"""On-device preprocessing of raw int16 CT: window, standardize, resize.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/preprocess.py``:

- :func:`fused_preprocess` (JAX ``preprocess.py:92-134, 198-212``), the
  training device input pipeline's: a batch of raw padded int16 volumes
  with their true extents ``in_sizes`` -> model-ready image, lung mask and
  the LAA emphysema mask (threshold -950 HU in training).  In the JAX
  order: the standardize moments over the whole valid extent (two passes:
  ``mean = sum(img * valid) / n``, ``var = sum((img - mean)^2 * valid) /
  (n - 1)``, ``n = max(count, 2)``, the unbiased estimator of torch
  ``Tensor.std()``), then the exact linspace depth selection, the emphysema
  mask from the raw depth-selected int16 masked to the valid H/W, the
  bilinear in-plane resize (align_corners=True) and the nearest resize of
  the uint8 masks;
- :func:`fused_preprocess_preselected` (JAX ``preprocess.py:137-195``), the
  deployment processor's: the host has already taken the exact linspace
  depth planes of the CT, computed the standardize moments from exact
  integer sums and nearest-selected the lung to the model size
  (``data/host_preprocess.py``); the device windows (WINDOW, -1150..-300
  HU), standardizes, resizes in-plane and derives the emphysema mask from
  the raw taps (-910 HU for inference, a reference quirk kept from
  ``dataset.py:79``).

The bilinear resize is two products with interpolation matrices built from
each scan's true in-plane extent with exact integer tap floors and the
rational remainder as the weight (one float32 division): the JAX package's
``_interp_matrix_dynamic``, bit for bit.  The products run in float32
(TF32 stays off: ``torch.backends.cuda.matmul.allow_tf32`` is False by
default and the port never sets it).  ``in_sizes`` may be host ints or an
integer tensor on the device: every index is then built on the device, so
no step reads a device value back to the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .resize import depth_linspace_indices, nearest_indices

WINDOW = (-1150.0, -300.0)


def _sizes(in_sizes, device) -> torch.Tensor:
    """``in_sizes`` (B, 3) as an int64 tensor on ``device``."""
    if isinstance(in_sizes, torch.Tensor):
        return in_sizes.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(in_sizes, np.int64), device=device)


def _interp_matrix_dynamic(pad_in: int, out_size: int,
                           in_size: torch.Tensor) -> torch.Tensor:
    """(B, pad_in, out) float32 align_corners=True linear-interp matrices
    for the true extents ``in_size`` (B,) <= ``pad_in`` (rows past each
    extent stay zero)."""
    in_i = in_size.to(torch.int64)[:, None]
    den = max(out_size - 1, 1)
    i = torch.arange(out_size, dtype=torch.int64, device=in_size.device)
    num = i * (in_i - 1)
    i0 = torch.minimum(torch.clamp(num // den, min=0), in_i - 1)
    w = (num - i0 * den).to(torch.float32) / float(den)
    i1 = torch.minimum(i0 + 1, in_i - 1)
    rows = torch.arange(pad_in, dtype=torch.int64,
                        device=in_size.device)[:, None]
    return ((rows == i0[:, None, :]) * (1.0 - w)[:, None, :]
            + (rows == i1[:, None, :]) * w[:, None, :])


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-sample selection along ``axis`` >= 1: ``out[b] = x[b]`` at the
    indices ``idx[b]`` (B, n) of that axis."""
    shape = [1] * x.ndim
    shape[0], shape[axis] = x.shape[0], idx.shape[1]
    size = list(x.shape)
    size[axis] = idx.shape[1]
    return torch.gather(x, axis, idx.reshape(shape).expand(size))


def _resize_hw(img: torch.Tensor, sizes: torch.Tensor, h_new: int,
               w_new: int) -> torch.Tensor:
    """Bilinear in-plane resize of (B, D, Hp, Wp) float32 planes whose true
    extents are ``sizes[:, 1:]``: two interpolation-matrix products."""
    mh = _interp_matrix_dynamic(img.shape[-2], h_new, sizes[:, 1])
    mw = _interp_matrix_dynamic(img.shape[-1], w_new, sizes[:, 2])
    y = torch.einsum("bdhw,bhn->bdnw", img, mh)
    return torch.einsum("bdnw,bwm->bdnm", y, mw)


def _nearest_hw(vol: torch.Tensor, sizes: torch.Tensor, h_new: int,
                w_new: int) -> torch.Tensor:
    """Nearest in-plane selection of (B, D, Hp, Wp) planes of true extents
    ``sizes[:, 1:]`` (dtype-exact)."""
    out = _take(vol, nearest_indices(h_new, sizes[:, 1]), 2)
    return _take(out, nearest_indices(w_new, sizes[:, 2]), 3)


def _valid_mask(shape, sizes: torch.Tensor) -> torch.Tensor:
    """(B, *shape) bool: voxel inside each sample's true extent ``sizes``
    (B, len(shape))."""
    m = None
    for axis, n in enumerate(shape):
        view = [sizes.shape[0]] + [1] * len(shape)
        view[axis + 1] = n
        a = (torch.arange(n, device=sizes.device)[None, :]
             < sizes[:, axis, None]).reshape(view)
        m = a if m is None else m & a
    return m


def preprocess_one(image_i16: torch.Tensor, lung: torch.Tensor, in_sizes,
                   target_size: Tuple[int, int, int],
                   em_threshold: float) -> Dict[str, torch.Tensor]:
    """One padded (Dp, Hp, Wp) int16 volume -> model-ready dict
    (:func:`fused_preprocess` of a batch of one)."""
    out = fused_preprocess(image_i16[None], lung[None],
                           _sizes(in_sizes, image_i16.device)[None],
                           target_size, em_threshold)
    return {k: v[0] for k, v in out.items()}


def fused_preprocess(images_i16: torch.Tensor, lungs: torch.Tensor,
                     in_sizes,
                     target_size: Tuple[int, int, int] = (128, 224, 288),
                     em_threshold: float = -950.0
                     ) -> Dict[str, torch.Tensor]:
    """Batched fused preprocess of raw padded volumes.

    ``images_i16``: (B, Dp, Hp, Wp) int16 (or float32 holding integer HU);
    ``lungs``: (B, Dp, Hp, Wp) any integer/bool mask; ``in_sizes``: (B, 3)
    true extents (host ints or an integer tensor); ``em_threshold``: -950
    (training LAA) or -910 (inference ess).  Returns float32 ``image``,
    ``lung_mask`` and ``em_mask``, each (B, *target_size)."""
    d_new, h_new, w_new = target_size
    dev = images_i16.device
    sizes = _sizes(in_sizes, dev)
    lo, hi = WINDOW
    # the standardize moments over the whole valid volume, two passes
    vf = _valid_mask(images_i16.shape[1:], sizes).to(torch.float32)
    img_full = (torch.clamp(images_i16.to(torch.float32), lo, hi) - lo) \
        / (hi - lo)
    n = torch.clamp(torch.sum(vf, dim=(1, 2, 3)), min=2.0)
    mean = torch.sum(img_full * vf, dim=(1, 2, 3)) / n
    var = torch.sum((img_full - mean[:, None, None, None]) ** 2 * vf,
                    dim=(1, 2, 3)) / (n - 1.0)
    del img_full, vf
    idx = depth_linspace_indices(sizes[:, 0], d_new)
    img_d = _take(images_i16, idx, 1).to(torch.float32)
    lung_d = _take(lungs, idx, 1) > 0
    # the taken planes are valid by construction (idx < in_sizes[0]); only
    # the H/W padding is masked out of the emphysema mask
    valid_hw = _valid_mask(img_d.shape[2:], sizes[:, 1:])[:, None]
    em_d = (img_d < em_threshold) & lung_d & valid_hw
    img = ((torch.clamp(img_d, lo, hi) - lo) / (hi - lo)
           - mean[:, None, None, None]) \
        * torch.rsqrt(var)[:, None, None, None]
    return {"image": _resize_hw(img, sizes, h_new, w_new),
            "lung_mask": _nearest_hw(lung_d.to(torch.uint8), sizes, h_new,
                                     w_new).to(torch.float32),
            "em_mask": _nearest_hw(em_d.to(torch.uint8), sizes, h_new,
                                   w_new).to(torch.float32)}


def fused_preprocess_preselected(
        images_i16: torch.Tensor, lungs: torch.Tensor, in_sizes,
        moments: torch.Tensor,
        target_size: Tuple[int, int, int] = (128, 224, 288),
        em_threshold: float = -950.0) -> Dict[str, torch.Tensor]:
    """Batched preselected preprocess.

    ``images_i16``: (B, d_out, Hp, Wp) depth-selected planes, padded
    in-plane (int16, or float32 holding integer HU as the gated unpack
    gives them); ``lungs``: (B, *target_size) nearest-preselected lung
    (any integer dtype); ``in_sizes``: (B, 3) true extents, host ints or an
    integer tensor (entry 0 unused: depth is already target-sized);
    ``moments``: (B, 2) float32 ``[mean, inv_std]`` of the windowed
    volume.  Returns float32 ``image``, ``lung_mask`` and ``em_mask``, each
    (B, *target_size)."""
    d_new, h_new, w_new = target_size
    d = images_i16.shape[1]
    if d != d_new or tuple(lungs.shape[1:]) != tuple(target_size):
        raise ValueError(f"preselected shapes {tuple(images_i16.shape)} / "
                         f"{tuple(lungs.shape)} do not match {target_size}")
    lo, hi = WINDOW
    sizes = _sizes(in_sizes, images_i16.device)
    moments = moments.to(torch.float32)
    img = ((torch.clamp(images_i16.to(torch.float32), lo, hi) - lo)
           / (hi - lo) - moments[:, 0, None, None, None]) \
        * moments[:, 1, None, None, None]
    raw = _nearest_hw(images_i16, sizes, h_new, w_new)
    em = (raw.to(torch.float32) < em_threshold) & (lungs > 0)
    return {"image": _resize_hw(img, sizes, h_new, w_new),
            "lung_mask": (lungs > 0).to(torch.float32),
            "em_mask": em.to(torch.float32)}
