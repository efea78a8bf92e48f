"""Share of the bf16 peak of the whole pass, in the processor cells
(:func:`perfbench.shares.mfu`)."""
from perfbench.shares import mfu as read  # noqa: F401
