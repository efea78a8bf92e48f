"""Plain PyTorch reference of the deployment processor's arithmetic.

Given one scan (int16 CT and lobe map, (Z, Y, X), as the benchmark made
them) and a state dict, what the reference ``processor.py`` writes for it
(reference ``dataset.py:49-93``, ``models.py:57-63``, ``processor.py:
99-158``, ``utils.py:28-63``):

1. the lung (lobes > 0), its bounding box padded by ``ceil(5 mm /
   spacing)`` voxels per axis; the crop of the CT with every voxel outside
   the lung dilated twice (3^3 box) set to -2048; the ess mask: CT < -910
   HU inside the lung;
2. window [-1150, -300] -> [0, 1], standardised by the crop's mean and
   unbiased std; in-plane bilinear resize (align_corners) to the model size
   and the linspace depth planes; the masks nearest in-plane and the same
   planes;
3. the model (``model.forward``); both maps trilinearly upsampled
   (align_corners) to the model size; each lesion percentage is the sum of
   the map over the ess mask divided by the lung's voxels;
4. each heatmap: the upsampled map times the ess mask, resized to the crop
   (align_corners), clipped to [0, 1], times 255, truncated to uint8 and
   pasted into a zero canvas of the scan's size;
5. the severity score of a percentage by the reference's interval maps.

Everything runs on the tensors' device in float32 (the standardize moments
in float64).  Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import model as ref_model

WINDOW = (-1150.0, -300.0)
ESS_HU = -910
CROP_BORDER_MM = 5.0
CLE_RATIO_MAP = {0: (0.0, 0.01), 1: (0.01, 0.05), 2: (0.05, 0.1),
                 3: (0.1, 0.2), 4: (0.2, 0.3), 5: (0.3, 1.0001)}
PSE_RATIO_MAP = {0: (0.0, 0.01), 1: (0.01, 0.05), 2: (0.05, 1.0001)}


def ratio_to_label(ratio: float, ratio_map) -> int:
    for label, (lo, hi) in ratio_map.items():
        if lo <= ratio < hi:
            return label
    raise ValueError(f"ratio {ratio} outside every interval")


def crop_slices(lung: torch.Tensor, spacing_zyx: Sequence[float]
                ) -> Tuple[slice, ...]:
    out = []
    for axis in range(3):
        line = lung.any(dim=tuple(a for a in range(3) if a != axis))
        idx = torch.nonzero(line)[:, 0]
        pad = int(math.ceil(CROP_BORDER_MM / float(spacing_zyx[axis])))
        start = max(0, int(idx[0]) - pad)
        stop = min(lung.shape[axis], int(idx[-1]) + 1 + pad)
        out.append(slice(start, stop))
    return tuple(out)


def depth_planes(d_in: int, d_out: int, device) -> torch.Tensor:
    return torch.div(torch.arange(d_out, device=device) * (d_in - 1),
                     max(d_out - 1, 1), rounding_mode="floor")


def preprocess(ct: torch.Tensor, lobes: torch.Tensor,
               spacing_zyx: Sequence[float], target: Sequence[int]
               ) -> Dict[str, object]:
    lung = lobes > 0
    sl = crop_slices(lung, spacing_zyx)
    dil = F.max_pool3d(lung.float()[None, None], 5, 1, 2)[0, 0] > 0.5
    raw = ct[sl]
    img = torch.where(dil[sl], raw, torch.full_like(raw, -2048))
    lung_c = lung[sl]
    ess = (raw < ESS_HU) & lung_c
    lo, hi = WINDOW
    w = (img.double().clamp(lo, hi) - lo) / (hi - lo)
    w = ((w - w.mean()) / w.std()).float()
    d_in = img.shape[0]
    planes = depth_planes(d_in, target[0], ct.device)
    x = F.interpolate(w[None, None], size=(d_in, *target[1:]),
                      mode="trilinear", align_corners=True)[:, :, planes]

    def mask(m):
        m = ref_model.nearest_resize(m.float()[None, None],
                                     (d_in, *target[1:]))
        return m[:, :, planes]

    return {"x": x, "lung": mask(lung_c), "ess": mask(ess), "crop": sl,
            "original_size": tuple(ct.shape)}


def process_scan(params: Dict[str, torch.Tensor], arch: str,
                 ct: torch.Tensor, lobes: torch.Tensor,
                 spacing_zyx: Sequence[float], target: Sequence[int],
                 prec: str = "f32") -> Dict[str, object]:
    """The reference outputs of one scan: ``cle_pct``/``pse_pct`` (float),
    ``heat`` ({"cle", "pse"}: uint8 canvases of the scan's size), ``crop``
    (the crop's slices) and the scores."""
    pre = preprocess(ct, lobes, spacing_zyx, target)
    with torch.no_grad():
        dense, _ = ref_model.forward(params, arch, pre["x"], pre["lung"],
                                     prec=prec)
        full = F.interpolate(torch.cat(dense, 1), size=tuple(target),
                             mode="trilinear", align_corners=True)
        lung_n = pre["lung"].sum()
        pcts = (full * pre["ess"]).sum((0, 2, 3, 4)) / lung_n
        masked = full * pre["ess"]
        crop = pre["crop"]
        size = tuple(s.stop - s.start for s in crop)
        heat = {}
        for c, name in enumerate(("cle", "pse")):
            up = F.interpolate(masked[:, c:c + 1], size=size,
                               mode="trilinear", align_corners=True)[0, 0]
            canvas = torch.zeros(pre["original_size"], dtype=torch.uint8,
                                 device=ct.device)
            canvas[crop] = (up.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            heat[name] = canvas
    cle, pse = (float(v) for v in pcts)
    return {"cle_pct": cle, "pse_pct": pse, "heat": heat, "crop": crop,
            "cle_score": ratio_to_label(cle, CLE_RATIO_MAP),
            "pse_score": ratio_to_label(pse, PSE_RATIO_MAP)}
