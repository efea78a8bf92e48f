"""Loss primitives of both training strategies, with the reference math.

Counterpart of ``bodyct_dram_emph_subtype_tpu/losses/losses.py``
(reference ``models.py:248-258,495-537``, ``metrics.py:4-47``):

- weighted CE on pooled logits, normalised by sum w[y];
- interval regression loss with power correction beta*x^gamma and a
  hinge-squared band penalty, x10 x per-sample class weight, **sum**
  reduction;
- regression label bands with the score-0 correction;
- mutual-exclusion Dice between the CLE and PSE dense maps;
- class-balanced, mask-smoothness-weighted BCE coverage loss, including the
  quirk that alpha comes from ``t.shape[0]`` (the batch size, not the voxel
  count);
- lesion fraction -> severity label by vectorised interval lookup.

Under data parallelism each loss is the JAX package's global-batch loss
(a data mesh reduces over the whole batch): every sum and count that
spans the batch is this rank's partial sum through
:func:`~..parallel.mesh.all_sum` (the identity in a world of one), over
the group that it spans.  Sums over the batch's voxels (``dice_coef``,
``masked_balanced_bce``'s numerator and denominator) take
``spatial.voxel_axis()``: the ``replica`` group (data x spatial) on H
slabs.  Per-row quantities (``masked_balanced_bce``'s ``rows``,
``interval_regression_loss``, ``weighted_cross_entropy``) are the same on
every rank of a spatial group, so they sum over the ``data`` group alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import spatial
from ..parallel.mesh import all_sum

BETA = 0.7338
GAMMA = 0.2578


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """``F.cross_entropy(weight=w)``: weighted mean, normaliser sum w[y]."""
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels[:, None].long())[:, 0]
    w = class_weights[labels.long()]
    num, den = all_sum(torch.stack([torch.sum(nll * w), torch.sum(w)]),
                       "data")
    return num / den


def generate_regression_labels(cls_targets: torch.Tensor,
                               ratio_map: Dict[int, tuple],
                               tightness: float = 1.0) -> torch.Tensor:
    """Score -> (lower, upper) lesion-fraction band; score 0 collapses to
    (0, 0)."""
    n = len(ratio_map)
    lbs = np.asarray([ratio_map[i][0] for i in range(n)], np.float32)
    ubs = np.asarray([ratio_map[i][1] for i in range(n)], np.float32)
    mids = (lbs + ubs) / 2.0
    spans = (ubs - lbs) * tightness / 2.0
    lo = np.where(lbs < 1e-7, 0.0, mids - spans)
    hi = np.where(lbs < 1e-7, 0.0, mids + spans)
    bands = torch.from_numpy(np.stack([lo, hi], axis=-1).astype(np.float32))
    return bands.to(cls_targets.device)[cls_targets.long()]


def interval_regression_loss(outs: torch.Tensor, reg_targets: torch.Tensor,
                             weight_factors: torch.Tensor) -> torch.Tensor:
    """Hinge-squared interval loss in power-corrected space, sum reduction."""
    data = torch.cat([outs[:, None], reg_targets], dim=1)
    data = BETA * data ** GAMMA
    k = (0.5 * (data[:, 2] - data[:, 1])) ** 2
    unhinged = (data[:, 0] - (data[:, 2] + data[:, 1]) / 2.0) ** 2 - k
    loss = 10.0 * torch.relu(unhinged) * weight_factors
    return all_sum(torch.sum(loss), "data")


def dice_coef(y: torch.Tensor, y_hat: torch.Tensor,
              smooth: float) -> torch.Tensor:
    """Whole-batch flattened Dice."""
    y_flat = y.reshape(-1)
    y_hat_flat = y_hat.reshape(-1)
    inter, sum_y, sum_y_hat = all_sum(torch.stack([
        torch.sum(y_hat_flat * y_flat), torch.sum(y_flat),
        torch.sum(y_hat_flat)]), spatial.voxel_axis())
    return (2.0 * inter + smooth) / (sum_y + sum_y_hat + smooth)


def binary_dice(y, y_hat, smooth: float = 1e-7):
    return dice_coef(y, y_hat, smooth)


def masked_balanced_bce(y: torch.Tensor, y_hat: torch.Tensor, mask=None,
                        smoothness: float = 0.65, eps: float = 1e-6
                        ) -> torch.Tensor:
    """Class-balanced BCE with in-mask smoothness down-weighting; alpha is
    ``1 - t.sum()/t.shape[0]`` (the batch size) clamped to [0.3, 0.7]."""
    t = y.float()
    p = y_hat
    sum_t = all_sum(torch.sum(t), spatial.voxel_axis())
    rows = all_sum(torch.full((), float(t.shape[0]), device=t.device),
                   "data")
    alpha = torch.clamp(1.0 - sum_t / rows, 0.3, 0.7)
    pt = p * t + (1.0 - p) * (1.0 - t)
    w = alpha * t + (1.0 - alpha) * (1.0 - t)
    log_ptc = torch.log(torch.clamp(pt, eps, 1.0 - eps))
    if mask is not None:
        nll = -1.0 * (smoothness * log_ptc * w * mask
                      + log_ptc * w * (1.0 - mask))
    else:
        nll = -smoothness * log_ptc * w
    num, den = all_sum(torch.stack([torch.sum(nll), torch.sum(w)]),
                       spatial.voxel_axis())
    return num / den


def segmentation_losses(dense_cle: torch.Tensor, dense_pse: torch.Tensor,
                        ems: torch.Tensor, lungs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mutual-exclusion Dice, coverage BCE) pair."""
    mul_loss = dice_coef(dense_cle * lungs, dense_pse * lungs, 1e-7)
    dense_p = torch.clamp(dense_cle + dense_pse, 0.0, 1.0)
    seg_loss = masked_balanced_bce(ems, dense_p, lungs, smoothness=0.85)
    return mul_loss, seg_loss


def ratio_to_label_batch(ratios: torch.Tensor, ratio_map: Dict[int, tuple]
                         ) -> torch.Tensor:
    """Fraction -> severity score: the first interval whose upper bound
    exceeds the ratio, clipped into the last class."""
    n = len(ratio_map)
    uppers = torch.tensor([ratio_map[i][1] for i in range(n)],
                          dtype=torch.float32, device=ratios.device)
    label = torch.sum(ratios[..., None] >= uppers, dim=-1)
    return torch.clamp(label, 0, n - 1).to(torch.int32)
