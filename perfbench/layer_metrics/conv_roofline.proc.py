"""Share of the roofline of the convolution kernels, in the processor cells
(:func:`perfbench.shares.conv_roofline`)."""
from perfbench.shares import conv_roofline as read  # noqa: F401
