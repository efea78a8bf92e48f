"""Conv mode ``tapmm``: the stride-1 3^3 conv on kernel A.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/tap_conv.py``.
:func:`tap_conv3d` replaces the Pallas kernel ``_tap_conv3d_impl``
(tap_conv.py:118: depth taps concatenated into K, width taps into N,
three H-shifted views, so every MXU op is a full-lane matmul) and its
custom VJP: the forward is one launch of kernel A (``csrc/conv3x3x3.cu``)
with an identity epilogue, the backward runs on cuDNN
(``ops/roll_conv.py::identity_conv3d``).

:func:`supports_tap_conv3d` and its ``_plan`` are the JAX gate copied
verbatim (TPU row padding and a 10 MB VMEM tile plan; W < 24 is refused),
evaluated on the shape the JAX package convolves, so the port runs the
kernel at exactly the JAX package's sites.  They say nothing about
Hopper's shared memory.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .roll_conv import identity_conv3d


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _plan(shape: Tuple[int, ...], o: int, itemsize: int,
          vmem_budget: int = 10 * 1024 * 1024):
    """The JAX package's TPU tile plan (h_tile, n_chunks), or None."""
    b, d, h, w, c = shape
    wp = _round_up(w + 2, 8)
    if wp - w > max(8, w // 3):
        return None
    best = None
    for nc in (1, 2, 4, 8):
        if o % nc or (o // nc) % 8:
            continue
        oc = o // nc
        weights = 3 * (3 * c) * (3 * oc) * itemsize
        if weights > 6 * 1024 * 1024:
            continue
        for t in range(min(h, 16), 3, -1):
            if h % t:
                continue
            views = 3 * 2 * t * wp * (3 * c) * itemsize
            partial = t * wp * (3 * oc) * 4
            acc = t * w * oc * 4
            out = 2 * t * w * oc * itemsize
            if views + weights + partial + acc + out <= vmem_budget:
                if best is None or nc < best[1]:
                    best = (t, nc)
                break
        if best is not None:
            break
    return best


def supports_tap_conv3d(shape: Tuple[int, ...],
                        kernel_shape: Tuple[int, ...],
                        strides: Tuple[int, int, int],
                        itemsize: int = 2) -> bool:
    """The JAX package's gate: 3^3 stride-1 convs at widths where the TPU
    row padding stays small and a tile plan exists."""
    if tuple(kernel_shape[:3]) != (3, 3, 3) or tuple(strides) != (1, 1, 1):
        return False
    if shape[3] < 24 or shape[2] < 4:
        return False
    return _plan(tuple(shape), kernel_shape[-1], itemsize) is not None


def tap_conv3d(x: torch.Tensor, kernel: torch.Tensor,
               dilation: int = 1) -> torch.Tensor:
    """Stride-1 3^3 conv (NDHWC x (3,3,3,C,O), tap spacing and zero
    padding ``dilation``) in ``x.dtype``: kernel A forward, cuDNN
    backward."""
    return identity_conv3d(x, kernel, dilation, "tap_conv3d")
