"""The stem in one pass (k7 s2 conv + BN + ReLU + k3 s2 pool): kernel E.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/stem_kernel.py``:
:func:`fused_stem_pool` launches ``csrc/stem_pool.cu::stem_pool``, which
replaces the Pallas kernel ``fused_stem_pool`` (stem_kernel.py:241).  The
TPU kernel's quad-lane stem and W-pair packed pool are TPU layouts; the
port returns both activations NDHWC.  The design and what bounds it on
the H100 are in the CUDA source.

:func:`supports_fused_stem` is the JAX gate copied verbatim ((2,2,8)-
divisible dims, D >= 16, and a TPU VMEM budget), so the port takes the
kernel exactly where the JAX package does.

A CPU tensor runs :func:`fused_stem_pool_plain`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .roll_conv import _dtype_code, _on_cuda, _require, _stream

FEATURES = 64


def supports_fused_stem(shape: Tuple[int, ...], features: int = 64,
                        itemsize: int = 2,
                        vmem_budget: int = 44 * 1024 * 1024) -> bool:
    """The JAX package's gate on the (B, D, H, W, 1) input: (2,2,8)-
    divisible dims, pool-even outputs, D >= 16, and the TPU plane ring and
    accumulators within its VMEM budget."""
    if len(shape) != 5 or shape[-1] != 1 or features != 64:
        return False
    b, d, h, w, _ = shape
    if d % 4 or h % 4 or w % 8 or d < 16:
        return False
    d2, h2, wq = d // 2, h // 2, w // 8
    hwq = h2 * wq
    if hwq % 8:
        return False
    o = 4 * features
    ring = 6 * hwq * 384 * itemsize
    acc = hwq * o * 4
    cring = 3 * hwq * o * itemsize
    sstage = 2 * hwq * o * itemsize
    pstage = 2 * hwq * 2 * features * itemsize
    weights = 4 * 384 * o * itemsize
    return (ring + acc + cring + sstage + pstage + weights) <= vmem_budget


def fused_stem_pool_plain(x: torch.Tensor, kernel: torch.Tensor,
                          mul: torch.Tensor, add: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel E: the k7 s2 p3 conv in float32 of ``x``
    and the weights rounded to ``x.dtype`` (exactly widened), BN affine,
    ReLU, one rounding to ``x.dtype``, then ``F.max_pool3d`` (k3 s2 p1) of
    the rounded stem."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 kernel.to(x.dtype).float().permute(4, 3, 0, 1, 2),
                 stride=2, padding=3)
    y = torch.relu(y * mul.float()[:, None, None, None]
                   + add.float()[:, None, None, None]).to(x.dtype)
    pooled = F.max_pool3d(y, 3, 2, 1)
    return (y.permute(0, 2, 3, 4, 1).contiguous(),
            pooled.permute(0, 2, 3, 4, 1).contiguous())


def fused_stem_pool(x: torch.Tensor, kernel: torch.Tensor,
                    mul: torch.Tensor, add: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``stem = relu(conv_k7s2p3(x) * mul + add)`` rounded once to
    ``x.dtype``, and its k3 s2 p1 max-pool.

    ``x``: (B, D, H, W, 1) float32 or bfloat16 with D, H, W multiples of
    4; ``kernel``: (7, 7, 7, 1, 64), rounded to ``x.dtype``; ``mul``/
    ``add``: (64,) folded eval BatchNorm.  Returns the NDHWC stem (B, D/2,
    H/2, W/2, 64) and pooled (B, D/4, H/4, W/4, 64), both ``x.dtype``."""
    if not _on_cuda(x):
        return fused_stem_pool_plain(x, kernel, mul, add)
    b, d, h, w, c = x.shape
    if c != 1 or kernel.shape != (7, 7, 7, 1, FEATURES) or d % 4 or h % 4 \
            or w % 4:
        raise ValueError(f"stem kernel takes (B, D, H, W, 1) with D, H, W "
                         f"multiples of 4 and (7, 7, 7, 1, {FEATURES}) "
                         f"weights, got {tuple(x.shape)} and "
                         f"{tuple(kernel.shape)}")
    dev = x.device
    code = _dtype_code(x)
    _require(x, (b, d, h, w, 1), x.dtype, dev, "x")
    kernel = kernel.to(device=dev, dtype=x.dtype).contiguous()
    mul = mul.to(device=dev, dtype=torch.float32).contiguous()
    add = add.to(device=dev, dtype=torch.float32).contiguous()
    _require(mul, (FEATURES,), torch.float32, dev, "mul")
    _require(add, (FEATURES,), torch.float32, dev, "add")
    stem = torch.empty((b, d // 2, h // 2, w // 2, FEATURES), dtype=x.dtype,
                       device=dev)
    pooled = torch.empty((b, d // 4, h // 4, w // 4, FEATURES),
                         dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().stem_pool(
            code, x.data_ptr(), kernel.data_ptr(), mul.data_ptr(),
            add.data_ptr(), stem.data_ptr(), pooled.data_ptr(), b, d, h, w,
            _stream(x))
    cuda_build.check(err, "stem_pool")
    cuda_build.launched("stem_pool")
    return stem, pooled
