"""Binary morphology and bounding boxes: the device ops and the host
(numpy) ones the deployment path uses.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/morphology.py``: the
reference dilates the lung twice with the full 3x3x3 structure
(``dataset.py:68-71``) and crops to the lung bounding box padded by
``border`` millimetres (``utils.py:53-63``).  On a tensor, a dilation with
the full box structure is one max-pool and the bounding box two
reductions per axis (:func:`binary_dilate`, :func:`mask_bbox`,
:func:`pad_bbox_mm`); ``binary_dilate_np`` and ``find_crops_np`` are the
host copies.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.mha import SlabMap

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
# planes of a lobe map's z-slab in :func:`find_crops_np`: 1 MiB of a
# 512 x 512 uint8 map and its bool, in a core's cache
BBOX_PLANES = 4


def binary_dilate(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary dilation of a 1-3-D ``mask`` with the full 3^ndim structure,
    ``iterations`` times (``scipy.ndimage.binary_dilation(mask,
    generate_binary_structure(ndim, ndim), iterations)``): one max-pool
    with a (2N+1)-box window.  Returns bool."""
    if iterations <= 0:
        return mask
    x = mask.to(torch.float32)[None, None]
    out = _MAX_POOL[mask.ndim](x, 2 * iterations + 1, 1, iterations)
    return out[0, 0] > 0.5


def mask_bbox(mask: torch.Tensor) -> torch.Tensor:
    """(ndim, 2) int32 [start, stop) bounds of the nonzero region of
    ``mask`` (``scipy.ndimage.find_objects`` of one object; an empty mask
    gives [n, 0) on each axis)."""
    m = mask > 0
    bounds = []
    for axis in range(m.ndim):
        line = m.any(dim=tuple(a for a in range(m.ndim) if a != axis)) \
            if m.ndim > 1 else m
        n = line.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=m.device)
        bounds.append(torch.stack([
            torch.where(line, idx, n).min(),
            torch.where(line, idx + 1, 0).max()]))
    return torch.stack(bounds).to(torch.int32)


def pad_bbox_mm(bbox: torch.Tensor, shape: Sequence[int],
                spacing: Sequence[float], border_mm: float) -> torch.Tensor:
    """``bbox`` padded by ``ceil(border_mm / spacing)`` voxels per axis and
    clipped to ``shape`` (``find_crops``, ``utils.py:56-59``)."""
    pads = torch.tensor([int(math.ceil(border_mm / float(sp)))
                         for sp in spacing], dtype=torch.int32,
                        device=bbox.device)
    limit = torch.tensor(list(shape), dtype=torch.int32, device=bbox.device)
    return torch.stack([torch.clamp_min(bbox[:, 0] - pads, 0),
                        torch.minimum(bbox[:, 1] + pads, limit)], dim=-1)


def binary_dilate_np(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """NumPy dilation with the full box structure (host fallback): per axis
    a max filter of radius ``iterations`` (:func:`dilate_axis_np`)."""
    out = mask.astype(bool)
    if iterations <= 0:
        return out
    for axis in range(mask.ndim):
        out = dilate_axis_np(out, axis, 0, out.shape[axis], iterations)
    return out


def dilate_axis_np(a: np.ndarray, axis: int, lo: int, hi: int,
                   radius: int) -> np.ndarray:
    """Indices ``[lo, hi)`` along ``axis`` of the binary max filter of
    ``radius`` of bool ``a`` along that axis, False beyond ``a``'s ends:
    a copy and ``2 * radius`` in-place ORs of shifted slices.  A halo of
    ``radius`` around ``[lo, hi)`` inside ``a`` makes the result that of
    the whole axis."""
    n = a.shape[axis]

    def at(start, stop):
        return (slice(None),) * axis + (slice(start, stop),)

    out = a[at(lo, hi)].copy()
    for d in range(-radius, radius + 1):
        # the k of [lo, hi) whose neighbour k + d lies inside a
        start, stop = max(lo, -d), min(hi, n - d)
        if d and start < stop:
            out[at(start - lo, stop - lo)] |= a[at(start + d, stop + d)]
    return out


def find_crops_np(mask: np.ndarray, spacing: Sequence[float],
                  border_mm: float, slab_map: Optional[SlabMap] = None
                  ) -> Tuple[slice, ...]:
    """Host bbox-with-border crop slices of ``mask > 0``, parity with
    ``utils.py:53-63``.

    Per-axis ``any`` reductions + argmax instead of ``np.nonzero``: the
    latter materializes index arrays for every nonzero voxel (hundreds of
    MB for a deployment lung mask).  A 3-D mask (a lobe map as it was read)
    is reduced in z-slabs of ``BBOX_PLANES``, mapped by ``slab_map`` (in
    turn without one), each compared with 0 while it is in cache: no
    whole-volume bool is made, and the bbox is identical."""
    if mask.ndim == 3:
        def slab_lines(z):
            s = mask[z:z + BBOX_PLANES]
            m = s if s.dtype == np.bool_ else s > 0
            return m.any(axis=2), m.any(axis=(0, 1))
        parts = list((slab_map or map)(
            slab_lines, range(0, mask.shape[0], BBOX_PLANES)))
        zy = np.concatenate([zy for zy, _ in parts])
        lines = [zy.any(axis=1), zy.any(axis=0),
                 np.logical_or.reduce([x for _, x in parts])]
    else:
        m = mask if mask.dtype == np.bool_ else mask > 0
        lines = [m.any(axis=tuple(a for a in range(m.ndim) if a != axis))
                 for axis in range(m.ndim)]
    slices = []
    for axis, line in enumerate(lines):
        start = int(line.argmax())
        if not line[start]:
            raise ValueError("empty mask: no nonzero voxels to crop")
        stop = len(line) - int(line[::-1].argmax())
        if border_mm > 0:
            pad = int(math.ceil(border_mm / float(spacing[axis])))
            start = max(0, start - pad)
            stop = min(mask.shape[axis], stop + pad)
        slices.append(slice(start, stop))
    return tuple(slices)
