"""Idle share of the device, in the trainer cells
(:func:`perfbench.shares.idle_share`)."""
from perfbench.shares import idle_share as read  # noqa: F401
