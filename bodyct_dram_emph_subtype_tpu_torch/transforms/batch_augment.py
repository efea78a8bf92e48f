"""On-device batched training augmentation: a draw step and an apply step.

Counterpart of ``bodyct_dram_emph_subtype_tpu/transforms/batch_augment.py``
(``_augment_one``, reference ``models.py:64-76``): GaussianAdditive(p=.5,
sigma U(.03,.06)) -> BoxMaskOut(p=.5, 1-10 boxes, centers U(.2,.8), sizes
U(.01,.06)) -> Flip(p=.5, 1-2 random axes) -> CropAndResize(p=.5, center
U(.45,.55), size U(.95,1)).

``jax.random`` and torch draw different numbers, so the chain is split:
:func:`draw_augment_params` draws every random number from an explicit
``torch.Generator`` with the distributions of ``_augment_one``, and
:func:`augment_batch` applies them deterministically through the ports of
the JAX primitives (``ops/intensity.py``, ``ops/grid_sample.py``).  The
apply step is what the tests hold against the JAX package.  The ``rbg``
noise source of the JAX package is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.grid_sample import flip_crop_resize
from ..ops.intensity import box_cutout, gaussian_additive_noise

MAX_CUTOUT_BOXES = 10


def _uniform(gen: torch.Generator, shape, lo: float, hi: float
             ) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def _row_generator(seed: int, row: int, device) -> torch.Generator:
    """The generator of global row ``row`` of a batch whose draws are
    seeded by ``seed``."""
    return torch.Generator(device).manual_seed(int(
        np.random.SeedSequence([seed, row]).generate_state(1)[0]))


def draw_augment_params(generator: torch.Generator, batch: int,
                        shape: Sequence[int], first_row: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """Every random number of the chain for a (batch, *shape) volume batch,
    on ``generator``'s device: ``gates`` (B, 4) bool (noise, cutout, flip,
    crop; each p=.5), ``sigma`` (B,), ``eps`` (B, *shape) N(0, 1),
    ``centers``/``sizes`` (B, 10, 3), ``valid`` (B, 10) (the first
    U{1..10} boxes, if the cutout gate is on), ``flip_axis`` (B, 3) (1 or 2
    distinct random axes, if the flip gate is on), ``crop_center``/
    ``crop_size`` (B, 3).

    Row ``i`` draws from a generator of its own, seeded from
    ``generator``'s seed and its global row index ``first_row + i``: a
    rank that holds rows ``[first_row, first_row + batch)`` of a global
    batch draws for them what one process at the global batch draws, and
    draws nothing for the other ranks' rows."""
    seed, dev, n = generator.initial_seed(), generator.device, \
        MAX_CUTOUT_BOXES
    eps = torch.empty((batch, *shape), device=dev)
    rows = []
    for i in range(batch):
        g = _row_generator(seed, first_row + i, dev)
        gates = torch.rand(4, generator=g, device=dev) < 0.5
        n_boxes = torch.randint(1, n + 1, (1,), generator=g, device=dev)
        n_axes = torch.randint(1, 3, (1,), generator=g, device=dev)
        order = torch.argsort(torch.rand(3, generator=g, device=dev))
        torch.randn(tuple(shape), generator=g, out=eps[i])
        rows.append({
            "gates": gates,
            "sigma": _uniform(g, (), 0.03, 0.06),
            "centers": _uniform(g, (n, 3), 0.2, 0.8),
            "sizes": _uniform(g, (n, 3), 0.01, 0.06),
            "valid": (torch.arange(n, device=dev) < n_boxes) & gates[1],
            "flip_axis": (order < n_axes) & gates[2],
            "crop_center": _uniform(g, (3,), 0.45, 0.55),
            "crop_size": _uniform(g, (3,), 0.95, 1.0),
        })
    draws = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    draws["eps"] = eps
    return draws


def _augment_one(image: torch.Tensor, masks: Tuple[torch.Tensor, ...],
                 draws: Dict[str, torch.Tensor], i: int,
                 mask_out_size: Optional[Tuple[int, int, int]] = None):
    """The chain on sample ``i`` of ``draws``: (D, H, W) float32 image and
    masks -> (image, masks); ``mask_out_size`` emits the masks directly at
    that resolution (torch 'nearest' downscale composed into the taps)."""
    gates = draws["gates"][i]
    noisy = gaussian_additive_noise(image, draws["sigma"][i],
                                    draws["eps"][i])
    image = torch.where(gates[0], noisy, image)
    image = box_cutout(image, draws["centers"][i], draws["sizes"][i],
                       draws["valid"][i])
    args = (draws["crop_center"][i], draws["crop_size"][i],
            draws["flip_axis"][i], gates[3])
    image = flip_crop_resize(image, *args, is_mask=False, align_corners=True)
    masks = tuple(flip_crop_resize(m.to(torch.float32), *args, is_mask=True,
                                   out_sizes=mask_out_size) for m in masks)
    return image, masks


def augment_batch(images: torch.Tensor, lungs: torch.Tensor,
                  ems: torch.Tensor, draws: Dict[str, torch.Tensor],
                  mask_out_size: Optional[Tuple[int, int, int]] = None):
    """Apply the drawn chain to a (B, D, H, W) batch; returns float32
    (images, lungs, ems), the masks at ``mask_out_size`` if given."""
    out = [_augment_one(images[i].float(), (lungs[i], ems[i]), draws, i,
                        mask_out_size) for i in range(images.shape[0])]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1][0] for o in out]),
            torch.stack([o[1][1] for o in out]))
