"""Plain PyTorch reference of the dRAM train step.

The reference ``models.py`` regression module's step (``models.py:57-76,
248-258, 495-537``, ``metrics.py:4-47``, ``data_sampler.py:7-68``),
float32, as functions:

- :func:`preprocess`: an archive volume (int16 CT, lung mask) to the model
  size: window [-1150, -300] -> [0, 1], standardised (unbiased std),
  in-plane bilinear (align_corners) and the linspace depth planes; masks
  nearest and the same planes; the LAA mask CT < -950 HU in the lung;
- :func:`augment`: the chain of ``models.py:64-76`` on given draws
  (GaussianAdditive, BoxMaskOut, Flip, CropAndResize through
  ``F.affine_grid``/``F.grid_sample``: the image bilinear with
  align_corners, masks nearest without; masks then nearest-resized to the
  dense maps);
- :func:`losses`: the interval regression losses (power-corrected,
  hinge-squared bands, x10, per-sample class weight, sum), the
  mutual-exclusion Dice and the class-balanced masked BCE;
- :func:`class_weights`: the sampler's clipped 'balanced' weights;
- :class:`Adam`: torch's Adam update (b1 0.9, b2 0.999, eps 1e-8).

Nothing here imports the program under test.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref_model
from .processor import CLE_RATIO_MAP, PSE_RATIO_MAP, WINDOW, depth_planes

LAA_HU = -950
BETA, GAMMA = 0.7338, 0.2578


def class_weights(labels: Sequence[int], n_classes: int) -> np.ndarray:
    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    w = len(labels) / (len(classes) * counts.astype(np.float64))
    w = list(np.clip(w / w.sum(), 0.2, 0.8))
    for c in range(n_classes):
        if c not in classes:
            w.insert(c, max(w))
    return np.asarray(w)


def preprocess(image: torch.Tensor, lung: torch.Tensor,
               target: Sequence[int]) -> Dict[str, torch.Tensor]:
    """(D, H, W) int16 CT and lung mask -> float32 ``image``, ``lung``,
    ``em`` at ``target``."""
    lo, hi = WINDOW
    w = (image.double().clamp(lo, hi) - lo) / (hi - lo)
    w = ((w - w.mean()) / w.std()).float()
    d_in = image.shape[0]
    planes = depth_planes(d_in, target[0], image.device)
    x = F.interpolate(w[None, None], size=(d_in, *target[1:]),
                      mode="trilinear", align_corners=True)[0, 0, planes]
    lung_b = lung > 0
    em = (image < LAA_HU) & lung_b

    def mask(m):
        return ref_model.nearest_resize(m.float(), (d_in, *target[1:]))[
            planes]

    return {"image": x, "lung": mask(lung_b), "em": mask(em)}


def _gaussian(img, sigma, eps):
    lo = img.min()
    span = img.max() - lo
    r = ((img - lo) / (span + 1e-7) + sigma * eps).clamp(0.0, 1.0)
    return r * span + lo


def _cutout(img, centers, sizes, valid):
    shape = torch.tensor(img.shape, dtype=torch.float32, device=img.device)
    out = img.clone()
    c = (centers.float() * shape).to(torch.int64)
    m = (sizes.float() * shape).to(torch.int64)
    for i in range(centers.shape[0]):
        if not bool(valid[i]):
            continue
        sl = tuple(slice(max(0, int(c[i, a]) - int(m[i, a]) // 2),
                         min(int(c[i, a]) + int(m[i, a]) - int(m[i, a]) // 2,
                             img.shape[a])) for a in range(3))
        out[sl] = 0.0
    return out


def _resample(vol, flip, gate, center, size, mask: bool):
    """Flip the axes of ``flip``, then (if ``gate``) crop the reference's
    integer box of ``center``/``size`` and resize it back to the volume."""
    axes = [a for a in range(3) if bool(flip[a])]
    if axes:
        vol = torch.flip(vol, axes)
    if not bool(gate):
        return vol
    shape = vol.shape
    box = []
    for a in range(3):
        s = shape[a]
        c = int(float(center[a]) * s)
        m = int(float(size[a]) * s)
        lo, hi = max(0, c - m // 2), min(c + m - m // 2, s)
        box.append((lo / s, hi / s))
    # theta maps the output's (x, y, z) = (W, H, D) to the input's
    theta = torch.zeros(1, 3, 4, device=vol.device)
    for k, a in enumerate((2, 1, 0)):
        b0, b1 = box[a]
        theta[0, k, k] = b1 - b0
        theta[0, k, 3] = b0 + b1 - 1.0
    grid = F.affine_grid(theta, (1, 1, *shape), align_corners=False)
    out = F.grid_sample(vol[None, None].float(), grid,
                        mode="nearest" if mask else "bilinear",
                        padding_mode="zeros", align_corners=not mask)
    return out[0, 0]


def augment(images, lungs, ems, draws: Dict[str, torch.Tensor],
            mask_size: Sequence[int]):
    """The chain on each row of (B, D, H, W) float32 inputs with the drawn
    parameters; masks returned at ``mask_size``."""
    out_i, out_l, out_e = [], [], []
    for i in range(images.shape[0]):
        g = draws["gates"][i]
        img = images[i].float()
        if bool(g[0]):
            img = _gaussian(img, draws["sigma"][i], draws["eps"][i])
        img = _cutout(img, draws["centers"][i], draws["sizes"][i],
                      draws["valid"][i])
        args = (draws["flip_axis"][i], g[3], draws["crop_center"][i],
                draws["crop_size"][i])
        out_i.append(_resample(img, *args, mask=False))
        for m, dst in ((lungs[i], out_l), (ems[i], out_e)):
            r = _resample(m.float(), *args, mask=True)
            dst.append(ref_model.nearest_resize(r, mask_size))
    return torch.stack(out_i), torch.stack(out_l), torch.stack(out_e)


def _bands(labels, ratio_map):
    n = len(ratio_map)
    lbs = np.asarray([ratio_map[i][0] for i in range(n)], np.float32)
    ubs = np.asarray([ratio_map[i][1] for i in range(n)], np.float32)
    mids, spans = (lbs + ubs) / 2, (ubs - lbs) / 2
    lo = np.where(lbs < 1e-7, 0.0, mids - spans)
    hi = np.where(lbs < 1e-7, 0.0, mids + spans)
    t = torch.from_numpy(np.stack([lo, hi], -1).astype(np.float32))
    return t.to(labels.device)[labels]


def _interval_loss(out, bands, w):
    data = BETA * torch.cat([out[:, None], bands], 1) ** GAMMA
    k = (0.5 * (data[:, 2] - data[:, 1])) ** 2
    un = (data[:, 0] - (data[:, 2] + data[:, 1]) / 2) ** 2 - k
    return torch.sum(10.0 * torch.relu(un) * w)


def _dice(y, y_hat, smooth=1e-7):
    inter = torch.sum(y * y_hat)
    return (2 * inter + smooth) / (y.sum() + y_hat.sum() + smooth)


def _masked_bce(t, p, mask, smoothness=0.85, eps=1e-6):
    alpha = torch.clamp(1.0 - t.sum() / t.shape[0], 0.3, 0.7)
    pt = p * t + (1 - p) * (1 - t)
    w = alpha * t + (1 - alpha) * (1 - t)
    log_pt = torch.log(torch.clamp(pt, eps, 1 - eps))
    nll = -(smoothness * log_pt * w * mask + log_pt * w * (1 - mask))
    return nll.sum() / w.sum()


def losses(dense: List[torch.Tensor], fracs: List[torch.Tensor], cle, pse,
           ems, lungs, cw_cle, cw_pse) -> Dict[str, torch.Tensor]:
    """``dense``: two (B, 1, d, h, w) maps; ``ems``/``lungs``: (B, d, h, w)
    at the maps' size; ``cle``/``pse``: (B,) labels."""
    loss_cle = _interval_loss(fracs[0], _bands(cle, CLE_RATIO_MAP),
                              cw_cle[cle])
    loss_pse = _interval_loss(fracs[1], _bands(pse, PSE_RATIO_MAP),
                              cw_pse[pse])
    binary = ((cle > 0) | (pse > 0)).float()[:, None, None, None, None]
    seg = ems[:, None] * binary
    lung = lungs[:, None]
    mul = _dice(dense[0] * lung, dense[1] * lung)
    seg_loss = _masked_bce(seg, torch.clamp(dense[0] + dense[1], 0, 1), lung)
    loss = loss_cle + loss_pse + 2.0 * mul + seg_loss
    return {"loss": loss, "loss_cle": loss_cle, "loss_pse": loss_pse,
            "mul_loss": mul, "seg_loss": seg_loss}


def step(params: Dict[str, torch.Tensor], arch: str, images, lungs, ems,
         cle, pse, cw_cle, cw_pse, prec: str = "f32"):
    """One forward and backward: (losses as floats, gradients by key, the
    two dense maps)."""
    leaves = {k: v for k, v in params.items() if v.requires_grad}
    for v in leaves.values():
        v.grad = None
    # the lesion fractions read the augmented lung at the maps' size
    dense, fracs = ref_model.forward(params, arch, images[:, None],
                                     lungs[:, None], train=True, prec=prec)
    out = losses(dense, fracs, cle, pse, ems, lungs, cw_cle, cw_pse)
    out["loss"].backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            {k: v.grad.detach().clone() for k, v in leaves.items()},
            [d.detach() for d in dense])


class Adam:
    """torch's Adam: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, leaves: Dict[str, torch.Tensor], b1=0.9, b2=0.999,
                 eps=1e-8):
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def update(self, leaves: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in leaves.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.sub_(lr * (self.m[k] / c1) / denom)
