"""Intensity augmentations of the training chain, deterministic given draws.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/intensity.py``'s
``gaussian_additive_noise`` (reference ``intensity_transforms.py:145-177``)
and ``box_cutout`` (``intensity_transforms.py:180-237``).  The random
numbers come in as arguments (``transforms/batch_augment.py`` draws them):
``jax.random`` and torch give different streams, so only the deterministic
apply step is held against the JAX package.
"""
from __future__ import annotations

import torch


def gaussian_additive_noise(img: torch.Tensor, sigma: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    """Additive noise ``sigma * eps`` in rescaled [0, 1] space, clipped,
    then mapped back to the volume's range.  ``eps``: a N(0, 1) field of
    ``img``'s shape."""
    img = img.to(torch.float32)
    d_min = img.min()
    d_range = img.max() - d_min
    rescaled = (img - d_min) / (d_range + 1e-7)
    rescaled = torch.clamp(rescaled + sigma * eps, 0.0, 1.0)
    return rescaled * d_range + d_min


def box_cutout(img: torch.Tensor, centers: torch.Tensor, sizes: torch.Tensor,
               valid: torch.Tensor, assign_value: float = 0.0
               ) -> torch.Tensor:
    """Set up to N axis-aligned boxes of a (D, H, W) volume to
    ``assign_value``.  ``centers``/``sizes``: (N, 3) fractions; ``valid``:
    (N,) bool, the boxes applied.  Extents use the reference's integer
    arithmetic: ``start = max(0, int(c*s) - int(m*s)//2)``, ``stop =
    min(int(c*s) + (int(m*s) - int(m*s)//2), s)``."""
    dev = img.device
    shape_f = torch.tensor(img.shape, dtype=torch.float32, device=dev)
    shape_i = torch.tensor(img.shape, dtype=torch.int32, device=dev)
    c = (centers.float() * shape_f).to(torch.int32)
    m = (sizes.float() * shape_f).to(torch.int32)
    half = torch.div(m, 2, rounding_mode="floor")
    starts = torch.clamp_min(c - half, 0)
    stops = torch.minimum(c + (m - half), shape_i)
    # a box is the outer product of three per-axis indicators, so the union
    # over N boxes is one rank-N contraction
    ind = []
    for axis in range(3):
        ar = torch.arange(img.shape[axis], dtype=torch.int32,
                          device=dev)[None]
        ind.append(((ar >= starts[:, axis:axis + 1])
                    & (ar < stops[:, axis:axis + 1])).to(torch.float32))
    ind[0] = ind[0] * valid[:, None].to(torch.float32)
    cover = torch.einsum("bd,bh,bw->dhw", *ind)
    return torch.where(cover > 0.5,
                       torch.tensor(assign_value, dtype=img.dtype,
                                    device=dev), img)
