"""Torch-parity resampling: the deployment path's, the trainer's heatmap
tiles' and the transform framework's.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/resize.py``.  Linear
resizes are dense interpolation-matrix products (two taps per output
column, float64-derived tables), or for the tiles and the ``Interpolate``
transform (:func:`interpolate_volume`) the JAX package's gather-and-lerp
``resize_linear``; nearest and depth-linspace selections
use EXACT integer index math.  ``F.interpolate`` is deliberately not
used: float index floors flip at exact-integer crossings and moved whole
mask rows and CT slices in the reference before its round 4 (DEVNOTES
"Exact-integer resize index math").
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _interp_matrix(in_size: int, out_size: int, align_corners: bool
                   ) -> np.ndarray:
    """Dense (in, out) linear-interpolation matrix (two taps per column),
    float64 index math like torch's CPU kernels."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = i * scale
    else:
        src = np.maximum((i + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    m = np.zeros((in_size, out_size), np.float32)
    cols = np.arange(out_size)
    np.add.at(m, (i0, cols), 1.0 - w)
    np.add.at(m, (i1, cols), w)
    return m


def _matrix(in_size, out_size, align_corners, like: torch.Tensor,
            window=None):
    """The (in, out) interpolation matrix on ``like``'s device and dtype;
    ``window`` = (in_start, out_start, in_total, out_total): the block of
    the (in_total, out_total) matrix that rows ``[in_start, in_start +
    in_size)`` and columns ``[out_start, out_start + out_size)`` cut out
    (a slab of a sharded axis; raises ``ValueError`` where one of those
    columns has a tap outside those rows)."""
    if window is None:
        m = _interp_matrix(in_size, out_size, align_corners)
    else:
        i0, o0, in_total, out_total = window
        full = _interp_matrix(in_total, out_total, align_corners)
        cols = full[:, o0:o0 + out_size]
        m = cols[i0:i0 + in_size]
        if i0 < 0 or np.any(np.delete(
                cols, np.s_[i0:i0 + in_size], axis=0)):
            raise ValueError(f"interpolation window {window}: output rows "
                             f"[{o0}, {o0 + out_size}) read outside input "
                             f"rows [{i0}, {i0 + in_size})")
    return torch.from_numpy(np.ascontiguousarray(m)).to(
        device=like.device, dtype=like.dtype)


def resize_linear_matmul(x: torch.Tensor, out_sizes: Sequence[int],
                         axes: Sequence[int], align_corners: bool,
                         windows: Sequence = None) -> torch.Tensor:
    """n-linear resize of ``x`` over ``axes``: one matrix product per axis,
    in ``x.dtype`` (float32 products stay float32 when TF32 is off).
    ``windows``: per axis None or (in_start, out_start, in_total,
    out_total), the global rows this slab holds and the global output rows
    it makes (:func:`_matrix`): the interpolation of the whole axis, not of
    the slab alone (the align_corners x2 matrix does not commute with a
    shift)."""
    if windows is None:
        windows = [None] * len(axes)
    for axis, out_size, window in zip(axes, out_sizes, windows):
        m = _matrix(x.shape[axis], out_size, align_corners, x, window)
        x = torch.movedim(torch.tensordot(x, m, dims=([axis], [0])), -1,
                          axis)
    return x


def resize_linear_matmul_transpose(x: torch.Tensor, in_sizes: Sequence[int],
                                   axes: Sequence[int], align_corners: bool
                                   ) -> torch.Tensor:
    """Adjoint of :func:`resize_linear_matmul`: applies ``Rᵀ`` where ``R``
    maps spatial sizes ``in_sizes`` to ``x.shape[axes]``, so
    ``sum(resize(d) * x) == sum(d * resize_transpose(x))`` up to float
    reassociation (the predict step's percentage math without full-res
    maps)."""
    for axis, in_size in zip(axes, in_sizes):
        m = _matrix(in_size, x.shape[axis], align_corners, x)
        x = torch.movedim(torch.tensordot(x, m, dims=([axis], [1])), -1,
                          axis)
    return x


def _linear_source_positions(out_size: int, in_size, align_corners: bool,
                             device=None) -> torch.Tensor:
    """float32 source coordinates of 1-D linear resampling (torch
    convention) for an ``in_size`` known only as a tensor:
    ``i * (in-1)/(out-1)`` (0 when ``out == 1``) with ``align_corners``,
    else ``max(0, (i+0.5) * in/out - 0.5)``."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    in_f = torch.as_tensor(in_size, dtype=torch.float32, device=device)
    if align_corners:
        scale = ((in_f - 1.0) / float(out_size - 1) if out_size > 1
                 else torch.zeros((), device=device))
        return i * scale
    return torch.clamp((i + 0.5) * (in_f / float(out_size)) - 0.5, min=0.0)


def linear_gather_1d(x: torch.Tensor, out_size: int, axis: int,
                     align_corners: bool, in_size=None) -> torch.Tensor:
    """Resample one axis of ``x`` linearly (torch parity): two gathers and
    ``x0 * (1 - w) + x1 * w``.  A static ``in_size`` (default the axis
    length) takes float64 host index tables, as torch's CPU kernels do;
    a tensor ``in_size`` float32 positions on the device."""
    if in_size is None:
        in_size = x.shape[axis]
    if isinstance(in_size, torch.Tensor):
        src = _linear_source_positions(out_size, in_size, align_corners,
                                       x.device)
        n = in_size.to(device=x.device, dtype=torch.int64)
        i0 = torch.minimum(torch.floor(src).to(torch.int64), n - 1)
        i1 = torch.minimum(i0 + 1, n - 1)
        w = src - i0.to(torch.float32)
    else:
        n = int(in_size)
        i = np.arange(out_size, dtype=np.float64)
        if align_corners:
            src = i * ((n - 1) / (out_size - 1) if out_size > 1 else 0.0)
        else:
            src = np.maximum((i + 0.5) * (n / out_size) - 0.5, 0.0)
        i0 = np.clip(np.floor(src).astype(np.int64), 0, n - 1)
        i1 = np.minimum(i0 + 1, n - 1)
        w = torch.from_numpy((src - i0).astype(np.float32)).to(x.device)
        i0, i1 = torch.from_numpy(i0).to(x.device), \
            torch.from_numpy(i1).to(x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape).to(x.dtype)
    return (torch.index_select(x, axis, i0) * (1.0 - w)
            + torch.index_select(x, axis, i1) * w)


def resize_linear(x: torch.Tensor, out_sizes: Sequence[int],
                  axes: Sequence[int], align_corners: bool,
                  in_sizes: Sequence = None) -> torch.Tensor:
    """n-linear resize over ``axes`` as separable 1-D passes
    (:func:`linear_gather_1d`; JAX ``ops/resize.py::resize_linear``)."""
    if in_sizes is None:
        in_sizes = [None] * len(axes)
    for axis, out_size, in_size in zip(axes, out_sizes, in_sizes):
        x = linear_gather_1d(x, out_size, axis, align_corners, in_size)
    return x


def nearest_indices(out_size: int, in_size, device=None) -> torch.Tensor:
    """torch 'nearest' source rows ``floor(i * in / out)`` as the exact
    integer rational floor.  ``in_size``: an int, or an integer tensor of
    extents (B,), which gives (B, out_size) rows on its device without a
    host read."""
    if isinstance(in_size, torch.Tensor):
        n = in_size.to(torch.int64)[..., None]
        i = torch.arange(out_size, dtype=torch.int64, device=in_size.device)
        return torch.minimum((i * n) // out_size, n - 1)
    i = torch.arange(out_size, dtype=torch.int64, device=device)
    return torch.clamp((i * int(in_size)) // out_size, max=int(in_size) - 1)


def nearest_gather_1d(x: torch.Tensor, out_size: int, axis: int,
                      in_size=None, window=None) -> torch.Tensor:
    """Resample one axis with torch 'nearest' semantics; ``in_size`` (the
    true extent, default the axis length) may be smaller than the padded
    axis.  ``window`` = (in_start, out_start, in_total, out_total): ``x``
    holds global rows ``[in_start, ...)`` of ``in_total`` and the result
    global output rows ``[out_start, out_start + out_size)`` of
    ``out_total`` (a slab of a sharded axis; raises ``ValueError`` where a
    source row lies outside the slab)."""
    if window is None:
        if in_size is None:
            in_size = x.shape[axis]
        idx = nearest_indices(out_size, in_size, x.device)
    else:
        i0, o0, in_total, out_total = window
        idx = nearest_indices(out_total, in_total, x.device)[
            o0:o0 + out_size] - i0
        if idx.numel() and (int(idx.min()) < 0
                            or int(idx.max()) >= x.shape[axis]):
            raise ValueError(f"nearest window {window}: source rows outside "
                             f"the slab's {x.shape[axis]}")
    return torch.index_select(x, axis, idx)


def resize_nearest(x: torch.Tensor, out_sizes: Sequence[int],
                   axes: Sequence[int], in_sizes: Sequence = None,
                   windows: Sequence = None) -> torch.Tensor:
    """n-dim torch 'nearest' resize over ``axes``; ``in_sizes``: the true
    extents (default the axes' lengths); ``windows``: per axis None or a
    slab's global rows (:func:`nearest_gather_1d`)."""
    if in_sizes is None:
        in_sizes = [None] * len(axes)
    if windows is None:
        windows = [None] * len(axes)
    for axis, out_size, in_size, window in zip(axes, out_sizes, in_sizes,
                                               windows):
        x = nearest_gather_1d(x, out_size, axis, in_size, window)
    return x


def depth_linspace_indices(original_d, new_d: int,
                           device=None) -> torch.Tensor:
    """``torch.linspace(0, D-1, newD).long()`` as the exact rational floor
    ``(i * (D-1)) // (newD-1)``.  ``original_d``: an int, or an integer
    tensor of depths (B,), which gives (B, new_d) indices on its device."""
    if isinstance(original_d, torch.Tensor):
        d = original_d.to(torch.int64)[..., None]
        i = torch.arange(new_d, dtype=torch.int64, device=original_d.device)
        return (i * (d - 1)) // (new_d - 1) if new_d > 1 else \
            torch.zeros_like(d)
    if new_d > 1:
        i = torch.arange(new_d, dtype=torch.int64, device=device)
        return (i * (int(original_d) - 1)) // (new_d - 1)
    return torch.zeros(1, dtype=torch.int64, device=device)


def interpolate_volume(vol: torch.Tensor, target_size: Tuple[int, int, int],
                       is_mask: bool, only_in_plane: bool = True,
                       align_corners: bool = True,
                       in_sizes: Sequence[int] = None) -> torch.Tensor:
    """The reference ``Interpolate`` transform on a (..., D, H, W) volume
    (``spatial_transforms.py:55-97``): in-plane bilinear (images, float32)
    or nearest (masks, in ``vol``'s dtype) to (H, W), then the depth slices
    of :func:`depth_linspace_indices`; with ``only_in_plane=False`` a
    trilinear or nearest resize of all three axes.  ``in_sizes``: the true
    (D, H, W) extents, default the volume's."""
    d_new, h_new, w_new = target_size
    d_in, h_in, w_in = vol.shape[-3:] if in_sizes is None else in_sizes
    if not is_mask:
        vol = vol.to(torch.float32)
    if only_in_plane:
        out = (resize_nearest(vol, (h_new, w_new), (-2, -1), (h_in, w_in))
               if is_mask else
               resize_linear(vol, (h_new, w_new), (-2, -1), align_corners,
                             (h_in, w_in)))
        return torch.index_select(
            out, out.ndim - 3, depth_linspace_indices(d_in, d_new,
                                                      vol.device))
    if is_mask:
        return resize_nearest(vol, target_size, (-3, -2, -1),
                              (d_in, h_in, w_in))
    return resize_linear(vol, target_size, (-3, -2, -1), align_corners,
                         (d_in, h_in, w_in))


def upsample_trilinear(x: torch.Tensor, out_sizes: Sequence[int],
                       spatial_axes: Sequence[int] = (-4, -3, -2),
                       align_corners: bool = True) -> torch.Tensor:
    """Trilinear resize of the three spatial axes (NDHWC by default)."""
    return resize_linear(x, out_sizes, spatial_axes, align_corners)
