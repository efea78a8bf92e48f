"""Lung-masked pooling: the dRAM head's lesion-fraction reduction.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/masked_pool.py``
(reference ``med3d.py:386-387``): nearest-resize the lung mask to the
dense-map resolution, then per sample ``sum(dense * lung) / sum(lung)``.
The sums run on kernel F (``ops/pallas_kernels.py::masked_sums``) on a
CUDA tensor, and the function is differentiable in ``dense``: its backward
is the broadcast ``g / (den + eps) * lung`` in PyTorch, the VJP of the JAX
jnp version (the JAX package has no backward kernel for these sums).
"""
from __future__ import annotations

import torch

from .pallas_kernels import masked_sums
from .resize import resize_nearest


class _LungMaskedFraction(torch.autograd.Function):
    """Forward: kernel F.  Backward: ``(g / (den + eps)) * lung`` broadcast
    over the voxels, with respect to ``dense`` only."""

    @staticmethod
    def forward(ctx, dense, lung, eps):
        lung = lung.float()
        num, den = masked_sums(dense, lung)
        den = den[:, None] + eps
        ctx.save_for_backward(lung, den)
        ctx.dtype = dense.dtype
        return (num / den).to(dense.dtype)

    @staticmethod
    def backward(ctx, g):
        lung, den = ctx.saved_tensors
        gd = (g.float() / den)[:, None, None, None, :] * lung
        return gd.to(ctx.dtype), None, None


def lung_masked_fraction(dense: torch.Tensor, lung: torch.Tensor,
                         eps: float = 0.0) -> torch.Tensor:
    """``dense``: (B, D, H, W, C); ``lung``: (B, D', H', W', 1) at any
    resolution.  Returns (B, C) ``num / (den + eps)`` in ``dense.dtype``
    (the sums in float32)."""
    if tuple(lung.shape[1:4]) != tuple(dense.shape[1:4]):
        lung = resize_nearest(lung, dense.shape[1:4], (1, 2, 3))
    return _LungMaskedFraction.apply(dense, lung, eps)
