"""Conv mode ``pallas``: the stride-1 3^3 conv on kernel A.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/pallas_conv.py``.
:func:`pallas_conv3d` replaces the Pallas kernel ``_pallas_conv3d_impl``
(pallas_conv.py:80, an im2col patch matrix times a (27C, O) weight matrix
on the MXU) and its custom VJP: the forward is one launch of kernel A
(``csrc/conv3x3x3.cu``) with an identity epilogue, the backward runs on
cuDNN (``ops/roll_conv.py::identity_conv3d``).  The im2col layout exists
to fill the TPU's matrix unit; kernel A's implicit GEMM computes the same
conv and needs none of it.

:func:`supports_pallas_conv3d` is the JAX gate copied verbatim: TPU VMEM
arithmetic (an H tile of the patch matrix under 12 MB), evaluated on the
shape the JAX package convolves, so the port runs the kernel at exactly
the JAX package's sites.  It says nothing about Hopper's shared memory.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .roll_conv import identity_conv3d


def _pick_h_tile(h: int, w: int = 0, c: int = 0, max_tile: int = 8,
                 itemsize: int = 2) -> int:
    """Largest divisor of ``h`` (<= max_tile) whose TPU patch matrix fits
    8 MB (the JAX package's ``_pick_h_tile``)."""
    for t in range(max_tile, 0, -1):
        if h % t:
            continue
        if c and t * max(w, 1) * 27 * c * itemsize > 8 * 1024 * 1024:
            continue
        return t
    return 1


def supports_pallas_conv3d(shape: Tuple[int, ...],
                           kernel_shape: Tuple[int, ...],
                           strides: Tuple[int, int, int],
                           itemsize: int = 2,
                           max_vmem_bytes: int = 12 * 1024 * 1024) -> bool:
    """The JAX package's gate: 3^3 stride-1 convs whose TPU per-step VMEM
    footprint stays under budget."""
    if tuple(kernel_shape[:3]) != (3, 3, 3) or strides != (1, 1, 1):
        return False
    B, D, H, W, C = shape
    O = kernel_shape[-1]
    H_TILE = _pick_h_tile(H, W, C, itemsize=itemsize)
    pad = lambda v, m: -(-v // m) * m  # noqa: E731
    planes = 3 * (H_TILE + 2) * pad(W + 2, 8) * pad(C, 128) * itemsize
    a_mat = H_TILE * pad(W, 8) * pad(27 * C, 128) * itemsize
    weights = pad(27 * C, 8) * pad(O, 128) * itemsize
    out_t = H_TILE * pad(W, 8) * pad(O, 128) * itemsize
    return planes + a_mat + weights + 2 * out_t < max_vmem_bytes


def pallas_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                  dilation: int = 1) -> torch.Tensor:
    """Stride-1 3^3 conv (NDHWC x (3,3,3,C,O), tap spacing and zero
    padding ``dilation``) in ``x.dtype``: kernel A forward, cuDNN
    backward."""
    return identity_conv3d(x, kernel, dilation, "pallas_conv3d")
