"""Flip + crop-and-resize of the training augmentation as tap matrices.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/grid_sample.py``'s
``flip_crop_resize`` and its helpers (reference ``functional.py:67-94``,
``spatial_transforms.py:133-197``).  The crop's affine grid is axis-aligned,
so each axis is one dense (out, in) tap matrix: two linear taps for images
(``grid_sample(align_corners=True)``), a one-hot round-half-to-even nearest
tap for masks (``align_corners=False``), zero outside the volume.  A flip
reverses the matrix's columns, a disabled crop is the identity, and an
optional trailing torch-'nearest' downscale of the masks selects rows, so
one tensordot per axis applies all of it.

The float32 arithmetic follows the JAX primitives operation by operation,
so mask taps that fall on an exact .5 tie round the same way: the base grid
reproduces how XLA on the CPU evaluates ``jnp.linspace`` (a reciprocal
multiply and a fused multiply-add), exact for every extent below 353.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _base_grid_1d(out_size: int) -> np.ndarray:
    """torch ``affine_grid`` base coordinates (align_corners=False) as the
    JAX package computes them in float32:
    ``linspace(-1, 1, S) * (S - 1) / S``."""
    if out_size == 1:
        return np.zeros(1, np.float32)
    div = out_size - 1
    recip = np.float32(1) / np.float32(div)
    prod = np.arange(div, dtype=np.float64) * np.float64(recip)
    one_minus = (1.0 - prod.astype(np.float32).astype(np.float64)
                 ).astype(np.float32)
    lin = (prod - one_minus.astype(np.float64)).astype(np.float32)
    lin = np.concatenate([lin, np.float32([1.0])])
    return (lin * np.float32(div)) / np.float32(out_size)


def _unnormalize(coords: torch.Tensor, in_size: int,
                 align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coords + 1.0) / 2.0 * (in_size - 1)
    return ((coords + 1.0) * in_size - 1.0) / 2.0


def _tap_matrix_linear(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense (out, in) linear-interpolation matrix: row i holds the two
    corner weights at columns floor(c) and floor(c)+1, zero outside."""
    j = torch.arange(in_size, dtype=torch.int32, device=coords.device)[None]
    i0 = torch.floor(coords).to(torch.int32)
    i1 = i0 + 1
    w1 = coords - i0.to(torch.float32)
    w0 = 1.0 - w1
    w0 = w0 * ((i0 >= 0) & (i0 <= in_size - 1))
    w1 = w1 * ((i1 >= 0) & (i1 <= in_size - 1))
    i0 = torch.clamp(i0, 0, in_size - 1)
    i1 = torch.clamp(i1, 0, in_size - 1)
    return (w0[:, None] * (j == i0[:, None])
            + w1[:, None] * (j == i1[:, None])).to(torch.float32)


def _tap_matrix_nearest(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense (out, in) one-hot nearest matrix (round half to even, zero
    outside)."""
    j = torch.arange(in_size, dtype=torch.int32, device=coords.device)[None]
    idx = torch.round(coords).to(torch.int32)
    valid = (idx >= 0) & (idx <= in_size - 1)
    idx = torch.clamp(idx, 0, in_size - 1)
    return ((j == idx[:, None]) & valid[:, None]).to(torch.float32)


def _crop_box01(shape: Tuple[int, ...], crop_center: torch.Tensor,
                crop_size: torch.Tensor) -> torch.Tensor:
    """The reference ``CropAndResize`` integer box as a normalised
    (ndim, 2) box of (start, stop) fractions."""
    dev = crop_center.device
    shape_f = torch.tensor(shape, dtype=torch.float32, device=dev)
    shape_i = torch.tensor(shape, dtype=torch.int32, device=dev)
    c = (crop_center.float() * shape_f).to(torch.int32)
    m = (crop_size.float() * shape_f).to(torch.int32)
    half = torch.div(m, 2, rounding_mode="floor")
    lo = torch.clamp_min(c - half, 0).to(torch.float32)
    hi = torch.minimum(c + (m - half), shape_i).to(torch.float32)
    return torch.stack([lo / shape_f, hi / shape_f], dim=-1)


def flip_crop_resize(vol: torch.Tensor, crop_center: torch.Tensor,
                     crop_size: torch.Tensor, flip_axis: torch.Tensor,
                     crop_gate: torch.Tensor, is_mask: bool,
                     align_corners: bool = True,
                     out_sizes: Optional[Tuple[int, ...]] = None
                     ) -> torch.Tensor:
    """Per-axis flip (where ``flip_axis[axis]``) THEN the crop-and-resize
    gated by ``crop_gate``, on one (D, H, W) volume, as one tensordot per
    axis.  ``out_sizes`` (masks only) composes a trailing torch 'nearest'
    downscale, bitwise equal to resampling at full size and then
    nearest-resizing.  Returns ``vol.dtype``."""
    if out_sizes is not None and not is_mask:
        raise ValueError("out_sizes composition is nearest-only (masks)")
    dev = vol.device
    box01 = _crop_box01(tuple(vol.shape), crop_center, crop_size)
    out = vol.to(torch.float32)
    for axis in range(vol.ndim):
        in_size = vol.shape[axis]
        t = torch.from_numpy(_base_grid_1d(in_size)).to(dev)
        b0, b1 = box01[axis, 0], box01[axis, 1]
        norm = t * (b1 - b0) + (b0 + b1 - 1.0)
        if is_mask:
            m = _tap_matrix_nearest(_unnormalize(norm, in_size, False),
                                    in_size)
        else:
            m = _tap_matrix_linear(_unnormalize(norm, in_size,
                                                align_corners), in_size)
        m = torch.where(crop_gate, m,
                        torch.eye(in_size, dtype=torch.float32, device=dev))
        m = torch.where(flip_axis[axis], m.flip(1), m)
        if out_sizes is not None and out_sizes[axis] != in_size:
            rows = np.minimum(
                np.floor(np.arange(out_sizes[axis], dtype=np.float64)
                         * (in_size / out_sizes[axis])).astype(np.int64),
                in_size - 1)
            m = m[torch.from_numpy(rows).to(dev)]
        out = torch.movedim(torch.tensordot(out, m, dims=([axis], [1])),
                            -1, axis)
    return out.to(vol.dtype)
