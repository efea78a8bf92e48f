"""Lung-masked pooling: the dRAM head's lesion-fraction reduction.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/masked_pool.py``
(reference ``med3d.py:386-387``): nearest-resize the lung mask to the
dense-map resolution, then per sample ``sum(dense * lung) / sum(lung)``.
"""
from __future__ import annotations

import torch

from .resize import resize_nearest


def lung_masked_fraction(dense: torch.Tensor, lung: torch.Tensor,
                         eps: float = 0.0) -> torch.Tensor:
    """``dense``: (B, D, H, W, C); ``lung``: (B, D', H', W', 1) at any
    resolution.  Returns (B, C)."""
    if tuple(lung.shape[1:4]) != tuple(dense.shape[1:4]):
        lung = resize_nearest(lung, dense.shape[1:4], (1, 2, 3))
    lung = lung.to(dense.dtype)
    num = torch.sum(dense * lung, dim=(1, 2, 3))
    den = torch.sum(lung, dim=(1, 2, 3))
    return num / (den + eps)
