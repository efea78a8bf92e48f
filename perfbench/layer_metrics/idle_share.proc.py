"""Idle share of the device, in the processor cells
(:func:`perfbench.shares.idle_share`)."""
from perfbench.shares import idle_share as read  # noqa: F401
