"""Kernels (``csrc/``) and plain tensor ops of the port."""
