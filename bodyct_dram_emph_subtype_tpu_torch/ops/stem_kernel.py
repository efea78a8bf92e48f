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

In bfloat16 the kernel runs the conv on the tensor cores as a stride-1
4^3 conv over the 2x2x2 space-to-depth of the input (8 channels);
:func:`stem_weights_s2d` lays the 7^3 weights out for it (zero-padded to
8^3, one zero tap low on each axis) as a (512, 64) K x N operand.  That is
the kernel's operand layout only: the wrapper takes and returns the
logical tensors.  :func:`space_to_depth2` and :func:`stem_conv_s2d_plain`
state the identity in plain torch.

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
# The bf16 kernel's plan (``csrc/stem_pool.cu``;
# tests/test_torch_conv_tile_plan.py holds these against the constexpr
# values there): a block owns
# STEM_POOL_TILE^2 pooled columns, computes their (2 * STEM_POOL_TILE + 1)^2
# stem voxels per plane, and keeps STEM_RING space-to-depth planes of
# (2 * STEM_POOL_TILE + 4)^2 voxels; the weights are STEM_K x FEATURES.
STEM_POOL_TILE, STEM_RING, STEM_K = 8, 5, 512


def stem_smem_bytes() -> int:
    """Dynamic shared memory of the bf16 kernel: the bf16 weights, the ring
    of 16-byte space-to-depth voxels and the bf16 stem tile."""
    stem, s2d = 2 * STEM_POOL_TILE + 1, 2 * STEM_POOL_TILE + 4
    return (STEM_K * FEATURES * 2 + STEM_RING * s2d * s2d * 16
            + stem * stem * FEATURES * 2)


def stem_weights_s2d(kernel: torch.Tensor) -> torch.Tensor:
    """(7, 7, 7, 1, F) stem weights -> the (512, F) operand of the bf16
    kernel: zero-padded to 8^3 with the zero tap low on each axis (tap
    k' = k + 1), then row ``((td*4 + th)*4 + tw)*8 + (qd*2 + qh)*2 + qw``
    holds tap ``(2td + qd - 1, 2th + qh - 1, 2tw + qw - 1)``."""
    f = kernel.shape[-1]
    w = F.pad(kernel.reshape(7, 7, 7, f), (0, 0, 1, 0, 1, 0, 1, 0))
    w = w.reshape(4, 2, 4, 2, 4, 2, f).permute(0, 2, 4, 1, 3, 5, 6)
    return w.reshape(64 * 8, f).contiguous()


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, 1) -> (B, D/2, H/2, W/2, 8), channel
    ``(qd*2 + qh)*2 + qw`` = x[2i + qd, 2j + qh, 2k + qw]."""
    b, d, h, w, _ = x.shape
    y = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2)
    return y.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, d // 2, h // 2, w // 2, 8)


def stem_conv_s2d_plain(x: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """The k7 s2 p3 stem conv as the bf16 kernel computes it: the stride-1
    4^3 conv of :func:`space_to_depth2` of ``x`` (padded 2 low, 1 high) with
    :func:`stem_weights_s2d`, in float32; NDHWC (B, D/2, H/2, W/2, F)."""
    w = stem_weights_s2d(kernel.float()).reshape(4, 4, 4, 8, -1)
    xs = space_to_depth2(x.float()).permute(0, 4, 1, 2, 3)
    y = F.conv3d(F.pad(xs, (2, 1, 2, 1, 2, 1)), w.permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1)


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
    kernel = kernel.to(device=dev, dtype=x.dtype)
    # float32: the (7, 7, 7, F) taps; bfloat16: the (512, F) s2d operand
    kernel = (stem_weights_s2d(kernel) if x.dtype == torch.bfloat16
              else kernel.contiguous())
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
            0, _stream(x))
    cuda_build.check(err, "stem_pool")
    cuda_build.launched("stem_pool")
    return stem, pooled
