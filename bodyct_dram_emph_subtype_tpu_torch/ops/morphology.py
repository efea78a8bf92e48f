"""Host (numpy) morphology and bounding-box crops for the deployment path.

Numpy copies of ``bodyct_dram_emph_subtype_tpu/ops/morphology.py``'s
``binary_dilate_np`` and ``find_crops_np``: the reference dilates the lung
twice with the full 3x3x3 structure (``dataset.py:68-71``) and crops to
the lung bounding box padded by ``border`` millimetres (``utils.py:53-63``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def binary_dilate_np(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """NumPy max-filter dilation with the full box structure (host fallback)."""
    if iterations <= 0:
        return mask.astype(bool)
    out = mask.astype(bool)
    for axis in range(mask.ndim):
        acc = out.copy()
        for shift in range(1, iterations + 1):
            acc |= _shift_bool(out, shift, axis)
            acc |= _shift_bool(out, -shift, axis)
        out = acc
    return out


def _shift_bool(a: np.ndarray, shift: int, axis: int) -> np.ndarray:
    out = np.zeros_like(a)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    if shift > 0:
        dst[axis] = slice(shift, None)
        src[axis] = slice(None, -shift)
    else:
        dst[axis] = slice(None, shift)
        src[axis] = slice(-shift, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def find_crops_np(mask: np.ndarray, spacing: Sequence[float],
                  border_mm: float) -> Tuple[slice, ...]:
    """Host bbox-with-border crop slices, parity with ``utils.py:53-63``.

    Per-axis ``any`` reductions + argmax instead of ``np.nonzero``: the
    latter materializes index arrays for every nonzero voxel (hundreds of
    MB for a deployment lung mask), while the reductions stream the volume
    twice with no allocation — the bbox is identical."""
    m = mask if mask.dtype == np.bool_ else mask > 0
    if m.ndim == 3:
        zy = m.any(axis=2)
        lines = [zy.any(axis=1), zy.any(axis=0), m.any(axis=(0, 1))]
    else:
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
