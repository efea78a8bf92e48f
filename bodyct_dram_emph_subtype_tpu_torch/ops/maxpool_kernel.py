"""k3 s2 p1 3-D max-pool on NDHWC activations: kernel C of the port.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/maxpool_kernel.py``:
:func:`max_pool_k3s2p1` launches ``csrc/maxpool3d.cu::max_pool3d_k3s2p1``,
which replaces the Pallas kernel ``max_pool_quads`` (maxpool_kernel.py:161,
reached through ``max_pool_k3s2p1_pallas``, :205) and the pool stage of
``fused_pool_layer1`` (``layer1_kernel.py:388``).  The design note and
what bounds it on the H100 are in the CUDA source.

A CPU tensor runs the plain version (``F.max_pool3d``, -inf padding); a
CUDA tensor launches the kernel or raises.  Max is exact: the two agree
bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .roll_conv import _dtype_code, _on_cuda, _require, _stream


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def supports_maxpool_pallas(shape: Tuple[int, ...], itemsize: int = 2,
                            vmem_budget: int = 13 * 1024 * 1024) -> bool:
    """The JAX package's (B, D, H, W, C) gate of its pool kernel: even
    D/H, W % 4 == 0, TPU lane-tile-aligned quad lanes, even C, and its
    plane ring within a VMEM budget.  Routing only: kernel C takes any
    shape."""
    if len(shape) != 5:
        return False
    b, d, h, w, c = shape
    if d < 4 or d % 2 or h % 2 or w % 4 or (4 * c) % 128 or c % 2:
        return False
    plane = (h // 2) * 2 * (w // 4) * 4 * c
    stage = 2 * (h // 2) * _round_up(w // 4, 8) * 2 * c
    return (5 * plane + stage) * itemsize <= vmem_budget


def supports_maxpool_quads(shape: Tuple[int, ...], itemsize: int = 2,
                           vmem_budget: int = 13 * 1024 * 1024) -> bool:
    """The JAX package's gate on a quad-lane (B, D, H, W/4, 4C) stem shape
    (``models/experimental.py::stem_quad_supported`` reads it)."""
    if len(shape) != 5 or shape[-1] % 4:
        return False
    b, d, h, wq, c4 = shape
    return supports_maxpool_pallas((b, d, h, 4 * wq, c4 // 4), itemsize,
                                   vmem_budget)


def max_pool_k3s2p1_plain(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool3d(3, 2, 1)`` on NDHWC ``x``."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=3, stride=2,
                     padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def max_pool_k3s2p1(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, ceil(D/2), ceil(H/2), ceil(W/2), C)."""
    if not _on_cuda(x):
        return max_pool_k3s2p1_plain(x)
    code = _dtype_code(x)
    b, d, h, w, c = x.shape
    _require(x, (b, d, h, w, c), x.dtype, x.device, "x")
    out = torch.empty((b, (d + 1) // 2, (h + 1) // 2, (w + 1) // 2, c),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = cuda_build.library().max_pool3d_k3s2p1(
            code, x.data_ptr(), out.data_ptr(), b, d, h, w, c, _stream(x))
    cuda_build.check(err, "max_pool3d_k3s2p1")
    cuda_build.launched("max_pool3d_k3s2p1")
    return out
