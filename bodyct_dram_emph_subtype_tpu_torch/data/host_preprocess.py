"""Host (numpy) preprocess: the deployment halves and the training view.

Numpy-only copies of the functions of
``bodyct_dram_emph_subtype_tpu/data/host_preprocess.py`` that the port
uses: the exact depth selection and lung nearest-selection shipped with
each scan, the exact standardize moments, the two-tap linear resize of the
heatmap un-crop, and ``preprocess_sample`` / ``PreprocessedView``, which
the train loader reads through (window -> standardize -> in-plane bilinear
+ linspace depth subsample, reference ``models.py:57-63``).  Indices and
weights are float64-derived (linear) or exact integer (nearest, depth),
bit-identical to the device side (``ops/preprocess.py``, ``ops/resize.py``).
``RawPaddedView`` is the loader view of the training device input
pipeline: it only pads, and the device preprocesses.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..utils.spans import span


def _linear_taps(out_size: int, in_size: int, align_corners: bool):
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = i * scale
    else:
        src = np.maximum((i + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    return i0, i1, w


def resize_linear_np(x: np.ndarray, out_sizes, axes, align_corners: bool
                     ) -> np.ndarray:
    x = x.astype(np.float32)
    for axis, out_size in zip(axes, out_sizes):
        i0, i1, w = _linear_taps(out_size, x.shape[axis], align_corners)
        shape = [1] * x.ndim
        shape[axis] = out_size
        w = w.reshape(shape)
        x = (np.take(x, i0, axis=axis) * (1 - w)
             + np.take(x, i1, axis=axis) * w)
    return x


def resize_linear_matmul_np(x: np.ndarray, out_sizes, axes,
                            align_corners: bool) -> np.ndarray:
    """n-linear resize, axes processed most-shrinking first (separable 1-D
    operators commute, so only float32 rounding can differ)."""
    x = x.astype(np.float32)
    order = sorted(zip(axes, out_sizes),
                   key=lambda p: p[1] / x.shape[p[0]])
    return np.ascontiguousarray(resize_linear_np(
        x, [s for _, s in order], [a for a, _ in order], align_corners))


def resize_nearest_np(x: np.ndarray, out_sizes, axes) -> np.ndarray:
    """torch 'nearest' as the exact integer rational floor."""
    for axis, out_size in zip(axes, out_sizes):
        n = x.shape[axis]
        idx = np.minimum((np.arange(out_size, dtype=np.int64) * n)
                         // out_size, n - 1)
        x = np.take(x, idx, axis=axis)
    return x


def depth_indices_np(d_in: int, d_out: int) -> np.ndarray:
    """``torch.linspace(0, D-1, newD).long()`` as the exact rational
    floor."""
    if d_out > 1:
        return (np.arange(d_out, dtype=np.int64) * (d_in - 1)) // (d_out - 1)
    return np.zeros(1, np.int64)


def window_moments_np(img: np.ndarray,
                      window=(-1150.0, -300.0)) -> np.ndarray:
    """``[mean, 1/std]`` (float32) of the windowed volume from exact int64
    sums, one float division each; unbiased (ddof=1) like torch
    ``Tensor.std()``."""
    return moments_from_sums(*window_sums_np(img, window), window)


def window_sums_np(img: np.ndarray, window=(-1150.0, -300.0)
                   ) -> Tuple[int, int, int]:
    """Exact ``(n, sum c, sum c*c)`` of ``c = clip(img, *window)`` over
    int16 ``img``: the sums of a volume's slabs add up to the volume's."""
    lo_i, hi_i = int(window[0]), int(window[1])
    img = np.asarray(img, np.int16)
    c = np.empty(img.shape, np.int32)
    np.clip(img, lo_i, hi_i, out=c)
    s1 = int(np.add.reduce(c, axis=None, dtype=np.int64))
    np.multiply(c, c, out=c)       # |c| <= 2048: c*c fits int32
    return int(c.size), s1, int(np.add.reduce(c, axis=None, dtype=np.int64))


def moments_from_sums(n: int, s1: int, s2: int,
                      window=(-1150.0, -300.0)) -> np.ndarray:
    """:func:`window_moments_np` from :func:`window_sums_np`'s sums."""
    lo_i, hi_i = int(window[0]), int(window[1])
    r = hi_i - lo_i
    mean = (s1 - n * lo_i) / (n * r)
    var = (s2 * n - s1 * s1) / (n * max(n - 1, 1) * r * r)
    inv_std = 1.0 / np.sqrt(var) if var > 0 else 0.0
    return np.asarray([mean, inv_std], np.float32)


def preprocess_sample(sample: Dict[str, np.ndarray],
                      target_size: Tuple[int, int, int],
                      window=(-1150.0, -300.0)) -> Dict[str, np.ndarray]:
    """window -> standardize -> interpolate one archive sample; masks get
    nearest in-plane + the same depth subsampling."""
    out = dict(sample)
    img = np.asarray(sample["image"]).astype(np.float32)
    lo, hi = window
    img = np.clip(img, lo, hi)
    img = (img - lo) / (hi - lo)
    img = (img - img.mean()) / (img.std(ddof=1) + 0.0)
    d_new, h_new, w_new = target_size
    d_idx = depth_indices_np(img.shape[0], d_new)
    img = resize_linear_np(img, (h_new, w_new), (1, 2), align_corners=True)
    out["image"] = np.ascontiguousarray(img[d_idx])
    for key in sample:
        if "mask" in key:
            m = np.asarray(sample[key]).astype(np.float32)
            m = resize_nearest_np(m, (h_new, w_new), (1, 2))
            out[key] = np.ascontiguousarray(m[d_idx])
    return out


class PreprocessedView:
    """Dataset adapter: ``preprocess_sample`` on ``__getitem__`` (what the
    loader threads run; an ``io.prepare`` span)."""

    def __init__(self, dataset, target_size, window=(-1150.0, -300.0)):
        self.dataset = dataset
        self.target_size = tuple(target_size)
        self.window = window

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        d = self.dataset[index]
        with span("io.prepare"):
            return preprocess_sample(d, self.target_size, self.window)

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class RawPaddedView:
    """Loader view of the device input pipeline: each sample's raw int16 CT
    and its lung mask padded into a static ``pad_shape`` buffer (-2048 and
    0), with its true extent ``in_sizes``; windowing, standardization,
    resizing and the LAA mask run on the device
    (``ops/preprocess.py::fused_preprocess``).  The padding is an
    ``io.prepare`` span.  A sample larger than the pad raises
    ``ValueError``."""

    def __init__(self, dataset, pad_shape):
        self.dataset = dataset
        self.pad_shape = tuple(pad_shape)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        d = self.dataset[index]
        with span("io.prepare"):
            return self._pad(index, d)

    def _pad(self, index, d):
        img = np.asarray(d["image"])
        lung = np.asarray(d["lung_mask"])
        shape = img.shape
        if any(s > p for s, p in zip(shape, self.pad_shape)):
            raise ValueError(f"sample {index} shape {shape} exceeds "
                             f"pad_shape {self.pad_shape}")
        img_p = np.full(self.pad_shape, -2048, np.int16)
        lung_p = np.zeros(self.pad_shape, np.uint8)
        sl = tuple(slice(0, s) for s in shape)
        img_p[sl] = img.astype(np.int16)
        lung_p[sl] = (lung > 0)
        out = {"image_raw": img_p, "lung_raw": lung_p,
               "in_sizes": np.asarray(shape, np.int32)}
        for key in ("cls_label", "pse_label", "index"):
            if key in d:
                out[key] = d[key]
        return out

    def __getattr__(self, name):
        return getattr(self.dataset, name)
