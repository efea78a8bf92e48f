"""Axis-aligned crop-and-resize, its training form as tap matrices, and
the general 3-D grid sample.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/grid_sample.py``
(reference ``functional.py:67-94``, ``spatial_transforms.py:133-197``).
The crop's affine grid is axis-aligned, so each axis samples separably:
two linear taps for images (``grid_sample(align_corners=True)``), a
round-half-to-even nearest tap for masks (``align_corners=False``), zero
outside the volume.  :func:`axis_aligned_grid_sample` takes them as
gathers or (``via="matmul"``) as one dense (out, in) tap matrix per axis;
:func:`crop_and_resize` is the ``CropAndResize`` transform on one volume.
The training augmentation's :func:`flip_crop_resize` composes a flip
(the matrix's columns reversed), the crop gate (the identity when off)
and an optional trailing torch-'nearest' downscale of the masks (selected
rows) into one tensordot per axis.  :func:`grid_sample_3d` is the
general, non-separable sample.

The float32 arithmetic follows the JAX primitives operation by operation,
so mask taps that fall on an exact .5 tie round the same way: the base grid
reproduces how XLA on the CPU evaluates ``jnp.linspace`` (a reciprocal
multiply and a fused multiply-add), exact for every extent below 353.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def _axis_taps_linear(coords: torch.Tensor, in_size: int):
    """((i0, w0), (i1, w1)): the two corner indices of linear sampling at
    ``coords``, clamped into the axis, and their weights, zero where the
    corner lies outside (zero padding)."""
    i0 = torch.floor(coords).to(torch.int32)
    i1 = i0 + 1
    w1 = coords - i0.to(torch.float32)
    w0 = 1.0 - w1
    w0 = w0 * ((i0 >= 0) & (i0 <= in_size - 1))
    w1 = w1 * ((i1 >= 0) & (i1 <= in_size - 1))
    return ((torch.clamp(i0, 0, in_size - 1), w0),
            (torch.clamp(i1, 0, in_size - 1), w1))


def _tap_matrix_linear(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense (out, in) linear-interpolation matrix: row i holds the two
    corner weights of :func:`_axis_taps_linear`."""
    j = torch.arange(in_size, dtype=torch.int32, device=coords.device)[None]
    (i0, w0), (i1, w1) = _axis_taps_linear(coords, in_size)
    return (w0[:, None] * (j == i0[:, None])
            + w1[:, None] * (j == i1[:, None])).to(torch.float32)


def _tap_matrix_nearest(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense (out, in) one-hot nearest matrix (round half to even, zero
    outside)."""
    j = torch.arange(in_size, dtype=torch.int32, device=coords.device)[None]
    idx, valid = _nearest_taps(coords, in_size)
    return ((j == idx[:, None]) & valid[:, None]).to(torch.float32)


def _nearest_taps(coords: torch.Tensor, in_size: int):
    """(index clamped into the axis, validity) of nearest sampling: round
    half to even, as ``std::nearbyint`` and ``jnp.round``."""
    idx = torch.round(coords).to(torch.int32)
    valid = (idx >= 0) & (idx <= in_size - 1)
    return torch.clamp(idx, 0, in_size - 1), valid


def axis_aligned_grid_sample(vol: torch.Tensor, box01: torch.Tensor,
                             out_sizes: Sequence[int], mode: str,
                             align_corners: bool,
                             via: str = "gather") -> torch.Tensor:
    """Sample the normalised axis-aligned box ``box01`` ((ndim, 2) start,
    stop fractions of each trailing spatial axis) of ``vol`` onto
    ``out_sizes``: an output base coordinate ``t`` reads the input
    normalised coordinate ``t * (b1 - b0) + (b0 + b1 - 1)``
    (``compute_crop_resize_affine_matrix``, ``functional.py:67-76``).
    ``mode``: ``bilinear`` (float32) or ``nearest`` (``vol``'s dtype);
    ``via``: per-axis gathers, or ``matmul``, one float32 tensordot per
    axis against a dense tap matrix."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode}")
    ndim = len(out_sizes)
    dev = vol.device
    out = vol.to(torch.float32) if mode == "bilinear" else vol
    for k, axis in enumerate(range(vol.ndim - ndim, vol.ndim)):
        in_size = vol.shape[axis]
        t = torch.from_numpy(_base_grid_1d(out_sizes[k])).to(dev)
        b0, b1 = box01[k, 0], box01[k, 1]
        coords = _unnormalize(t * (b1 - b0) + (b0 + b1 - 1.0), in_size,
                              align_corners)
        if via == "matmul":
            m = (_tap_matrix_linear(coords, in_size) if mode == "bilinear"
                 else _tap_matrix_nearest(coords, in_size))
            out = torch.movedim(torch.tensordot(out.to(torch.float32), m,
                                                dims=([axis], [1])), -1, axis)
            continue
        bshape = [1] * out.ndim
        bshape[axis] = out_sizes[k]
        if mode == "bilinear":
            (i0, w0), (i1, w1) = _axis_taps_linear(coords, in_size)
            out = (torch.index_select(out, axis, i0) * w0.reshape(bshape)
                   + torch.index_select(out, axis, i1) * w1.reshape(bshape))
        else:
            idx, valid = _nearest_taps(coords, in_size)
            taken = torch.index_select(out, axis, idx)
            out = taken * valid.reshape(bshape).to(taken.dtype)
    return out


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


def crop_and_resize(vol: torch.Tensor, crop_center, crop_size,
                    is_mask: bool, align_corners: bool = True,
                    via: str = "gather") -> torch.Tensor:
    """The reference ``CropAndResize`` on one volume: the per-axis
    fractions ``crop_center``/``crop_size`` give the integer box
    ``lo = max(0, int(c*s) - int(m*s)//2)``, ``hi = min(int(c*s) +
    (int(m*s) - int(m*s)//2), s)`` (``spatial_transforms.py:170-181``),
    resampled back to the volume's shape: images bilinear with
    ``align_corners``, masks nearest in float32 with align_corners False
    (``:196-197``); cast back to ``vol.dtype`` (``:190``)."""
    dev = vol.device

    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.asarray(v, np.float32)).to(dev)

    box01 = _crop_box01(tuple(vol.shape), f32(crop_center), f32(crop_size))
    if is_mask:
        out = axis_aligned_grid_sample(vol.to(torch.float32), box01,
                                       vol.shape, "nearest", False, via)
    else:
        out = axis_aligned_grid_sample(vol, box01, vol.shape, "bilinear",
                                       align_corners, via)
    return out.to(vol.dtype)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor,
                   mode: str = "bilinear",
                   align_corners: bool = False) -> torch.Tensor:
    """General 3-D grid sample with zero padding: ``vol`` (D, H, W[, C]),
    ``grid`` (Do, Ho, Wo, 3) normalised coordinates in torch's order
    (x = W, y = H, z = D); ``bilinear`` returns float32, ``nearest``
    ``vol``'s dtype."""
    has_c = vol.ndim == 4
    if not has_c:
        vol = vol[..., None]
    d, h, w, c = vol.shape
    xs = _unnormalize(grid[..., 0], w, align_corners)
    ys = _unnormalize(grid[..., 1], h, align_corners)
    zs = _unnormalize(grid[..., 2], d, align_corners)

    def gather(zi, yi, xi):
        valid = ((zi >= 0) & (zi < d) & (yi >= 0) & (yi < h)
                 & (xi >= 0) & (xi < w))
        vals = vol[zi.clamp(0, d - 1).long(), yi.clamp(0, h - 1).long(),
                   xi.clamp(0, w - 1).long()]
        return vals * valid[..., None].to(vol.dtype)

    if mode == "nearest":
        out = gather(torch.round(zs).to(torch.int32),
                     torch.round(ys).to(torch.int32),
                     torch.round(xs).to(torch.int32))
    else:
        z0 = torch.floor(zs).to(torch.int32)
        y0 = torch.floor(ys).to(torch.int32)
        x0 = torch.floor(xs).to(torch.int32)
        wz = (zs - z0)[..., None]
        wy = (ys - y0)[..., None]
        wx = (xs - x0)[..., None]
        out = torch.zeros(grid.shape[:-1] + (c,), dtype=torch.float32,
                          device=vol.device)
        for dz, wz_ in ((0, 1 - wz), (1, wz)):
            for dy, wy_ in ((0, 1 - wy), (1, wy)):
                for dx, wx_ in ((0, 1 - wx), (1, wx)):
                    out = out + gather(z0 + dz, y0 + dy, x0 + dx).to(
                        torch.float32) * (wz_ * wy_ * wx_)
    return out if has_c else out[..., 0]
