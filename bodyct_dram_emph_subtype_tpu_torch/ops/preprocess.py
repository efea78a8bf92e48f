"""On-device preprocessing of depth-preselected raw int16 CT planes.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/preprocess.py::
fused_preprocess_preselected`` (preprocess.py:137-195).  The host has
already taken the exact linspace depth planes of the CT, computed the
standardize moments from exact integer sums and nearest-selected the lung
to the model size (``data/host_preprocess.py``); the device windows
(WINDOW, -1150..-300 HU), standardizes, resizes in-plane bilinearly
(align_corners=True) as two interpolation-matrix products, and derives
the emphysema mask from the RAW int16 taps (threshold -910 HU for
inference, a reference quirk kept from ``dataset.py:79``).

The interpolation matrices are built from each scan's true in-plane
extent with exact integer tap floors and the rational remainder as the
weight (one float32 division) — the JAX package's
``_interp_matrix_dynamic``, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .resize import nearest_indices

WINDOW = (-1150.0, -300.0)


def _interp_matrix_dynamic(pad_in: int, out_size: int, in_size: int,
                           device) -> torch.Tensor:
    """(pad_in, out) float32 align_corners=True linear-interp matrix for a
    true extent ``in_size`` <= ``pad_in`` (rows past it stay zero)."""
    den = max(out_size - 1, 1)
    i = torch.arange(out_size, dtype=torch.int64, device=device)
    num = i * (in_size - 1)
    i0 = torch.clamp(num // den, 0, in_size - 1)
    w = (num - i0 * den).to(torch.float32) / float(den)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    rows = torch.arange(pad_in, dtype=torch.int64, device=device)[:, None]
    return ((rows == i0[None, :]) * (1.0 - w)[None, :]
            + (rows == i1[None, :]) * w[None, :])


def fused_preprocess_preselected(
        images_i16: torch.Tensor, lungs: torch.Tensor,
        in_sizes: Sequence[Sequence[int]], moments: torch.Tensor,
        target_size: Tuple[int, int, int] = (128, 224, 288),
        em_threshold: float = -950.0) -> Dict[str, torch.Tensor]:
    """Batched preselected preprocess.

    ``images_i16``: (B, d_out, Hp, Wp) int16 depth-selected planes, padded
    in-plane; ``lungs``: (B, *target_size) nearest-preselected lung
    (any integer dtype); ``in_sizes``: (B, 3) host ints, the true extents
    (entry 0 unused: depth is already target-sized); ``moments``: (B, 2)
    float32 ``[mean, inv_std]`` of the windowed volume.  Returns float32
    ``image``, ``lung_mask`` and ``em_mask``, each (B, *target_size)."""
    d_new, h_new, w_new = target_size
    b, d, hp, wp = images_i16.shape
    if d != d_new or tuple(lungs.shape[1:]) != tuple(target_size):
        raise ValueError(f"preselected shapes {tuple(images_i16.shape)} / "
                         f"{tuple(lungs.shape)} do not match {target_size}")
    lo, hi = WINDOW
    dev = images_i16.device
    moments = moments.to(torch.float32)
    img = ((torch.clamp(images_i16.to(torch.float32), lo, hi) - lo)
           / (hi - lo) - moments[:, 0, None, None, None]) \
        * moments[:, 1, None, None, None]
    out_img, out_em = [], []
    for i in range(b):
        h_in, w_in = int(in_sizes[i][1]), int(in_sizes[i][2])
        mh = _interp_matrix_dynamic(hp, h_new, h_in, dev)
        mw = _interp_matrix_dynamic(wp, w_new, w_in, dev)
        y = torch.einsum("dhw,hn->dnw", img[i], mh)
        out_img.append(torch.einsum("dnw,wm->dnm", y, mw))
        raw = images_i16[i].index_select(1, nearest_indices(h_new, h_in, dev))
        raw = raw.index_select(2, nearest_indices(w_new, w_in, dev))
        out_em.append((raw.to(torch.float32) < em_threshold) & (lungs[i] > 0))
    return {"image": torch.stack(out_img),
            "lung_mask": (lungs > 0).to(torch.float32),
            "em_mask": torch.stack(out_em).to(torch.float32)}
