"""Conv mode ``flat``: the stride-1 3^3 conv of the dilated layers on
kernel A.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/flat_conv.py``.
:func:`flat_conv3d` replaces the Pallas kernel ``_flat_conv_impl``
(flat_conv.py:140: each depth plane flattened to rows with a zero
separator column, nine shifted plane copies in a patch ring, one matmul
per depth tap) and its custom VJP.  The JAX package runs it on the
space-to-batch subgrids of layer3/4 (B*d^3, D/d, H/d, W/d, C); the port
runs the same numbers as a dilated conv on the logical tensor: one launch
of kernel A (``csrc/conv3x3x3.cu``) with an identity epilogue at dilation
d, the backward on cuDNN (``ops/roll_conv.py::identity_conv3d``).

:func:`supports_flat_conv`, ``_geom`` and ``_plan`` are the JAX gate
copied verbatim (C and O multiples of 128, an 11 MB VMEM plan), evaluated
on the subgrid shape, so the port runs the kernel at exactly the JAX
package's sites.  They say nothing about Hopper's shared memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .roll_conv import identity_conv3d


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _geom(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(WS, R, RP) of the JAX kernel's flat plane layout."""
    _, _, h, w, _ = shape
    ws = w + 1
    r = h * ws
    rp = _round_up(_round_up(r, 8) + 2 * (ws + 1), 8)
    return ws, r, rp


def _plan(shape: Tuple[int, ...], o: int, itemsize: int,
          vmem_budget: int = 11 * 1024 * 1024) -> Optional[int]:
    """The JAX package's output-channel chunk OC, or None."""
    n, d, h, w, c = shape
    if c % 128 or o % 128:
        return None
    ws, r, rp = _geom(shape)
    rp8 = _round_up(r, 8)
    dp = d + 2
    oc = o
    while oc >= 128:
        if o % oc == 0:
            x_blk = dp * rp * c * itemsize
            ring = 3 * rp8 * 9 * c * itemsize
            wts = 3 * 9 * c * oc * itemsize
            acc = rp8 * oc * 4
            out_blk = d * rp8 * oc * itemsize
            if 2 * x_blk + ring + wts + acc + 2 * out_blk <= vmem_budget:
                return oc
        oc //= 2
    return None


def supports_flat_conv(shape: Tuple[int, ...], kernel_shape: Tuple[int, ...],
                       itemsize: int = 2) -> bool:
    """The JAX package's gate; ``shape`` is the NDHWC activation shape the
    JAX package convolves (the subgrid shape for a dilated conv)."""
    if tuple(kernel_shape[:3]) != (3, 3, 3):
        return False
    if shape[-1] != kernel_shape[3]:
        return False
    return _plan(tuple(shape), kernel_shape[-1], itemsize) is not None


def flat_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                dilation: int = 1) -> torch.Tensor:
    """Stride-1 3^3 conv (NDHWC x (3,3,3,C,O), tap spacing and zero
    padding ``dilation``) in ``x.dtype``: kernel A forward, cuDNN
    backward."""
    return identity_conv3d(x, kernel, dilation, "flat_conv3d")
