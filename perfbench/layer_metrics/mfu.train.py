"""Share of the bf16 peak of the whole step, in the trainer cells
(:func:`perfbench.shares.mfu`)."""
from perfbench.shares import mfu as read  # noqa: F401
