"""Lung-masked pooling: the dRAM head's lesion-fraction reduction.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/masked_pool.py``
(reference ``med3d.py:386-387``): nearest-resize the lung mask to the
dense-map resolution, then per sample ``sum(dense * lung) / sum(lung)``.
The sums run on kernel F (``ops/pallas_kernels.py::masked_sums``) on a
CUDA tensor, and the function is differentiable in ``dense``: its backward
is the broadcast ``g / (den + eps) * lung`` in PyTorch, the VJP of the JAX
jnp version (the JAX package has no backward kernel for these sums).

On H slabs (``parallel/spatial.py``) kernel F sums this rank's slab; the
partial numerators and lung counts go through ``mesh.all_sum`` over the
spatial group before the division, so the backward sums the incoming
gradient over it (the rule of ``parallel/mesh.py``).  The lung mask is
resized with the slab's global rows.
"""
from __future__ import annotations

import torch

from ..parallel import mesh, spatial
from .pallas_kernels import masked_sums
from .resize import resize_nearest


class _MaskedSums(torch.autograd.Function):
    """Forward: kernel F's float32 ``(num, den)``.  Backward: the
    gradient of ``num`` times ``lung``, broadcast over the voxels, with
    respect to ``dense`` only."""

    @staticmethod
    def forward(ctx, dense, lung):
        lung = lung.float()
        num, den = masked_sums(dense, lung)
        ctx.save_for_backward(lung)
        ctx.dtype = dense.dtype
        ctx.mark_non_differentiable(den)
        return num, den

    @staticmethod
    def backward(ctx, g, _):
        lung, = ctx.saved_tensors
        gd = g.float()[:, None, None, None, :] * lung
        return gd.to(ctx.dtype), None


def lung_masked_fraction(dense: torch.Tensor, lung: torch.Tensor,
                         eps: float = 0.0) -> torch.Tensor:
    """``dense``: (B, D, H, W, C); ``lung``: (B, D', H', W', 1) at any
    resolution.  Returns (B, C) ``num / (den + eps)`` in ``dense.dtype``
    (the sums in float32)."""
    if tuple(lung.shape[1:4]) != tuple(dense.shape[1:4]):
        lung = resize_nearest(lung, dense.shape[1:4], (1, 2, 3),
                              windows=spatial.h_windows(lung.shape[2],
                                                        dense.shape[2]))
    num, den = _MaskedSums.apply(dense, lung)
    if spatial.active():
        sums = mesh.all_sum(torch.cat([num, den[:, None]], 1), "spatial")
        num, den = sums[:, :-1], sums[:, -1]
    return (num / (den[:, None] + eps)).to(dense.dtype)
