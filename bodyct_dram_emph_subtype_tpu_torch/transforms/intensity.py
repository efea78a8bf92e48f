"""Intensity transforms (reference ``intensity_transforms.py``).

Counterpart of ``bodyct_dram_emph_subtype_tpu/transforms/intensity.py``:
the same parameters drawn from the same numpy RandomState
(``transforms/base.py``), applied by the torch ops of ``ops/intensity.py``.
"""
from __future__ import annotations

import numbers
from typing import Tuple, Union

import numpy as np
import torch

from ..ops import intensity as F
from .base import ImageOnlyTransform, as_tensor


def _draw(value, rng):
    """A number as it is; a (lo, hi) range as a uniform draw of ``rng``."""
    return value if isinstance(value, numbers.Number) else rng.uniform(*value)


class IntensityWindow(ImageOnlyTransform):
    """HU windowing: clip, rescale, cast to ``output_dtype``
    (``intensity_transforms.py:80-101``; the training chain takes
    ``(-1150, -300) -> (0, 1)`` in float32, ``models.py:60``)."""

    def __init__(self, from_span=(-1100, 400), to_span=(0, 255),
                 output_dtype=torch.float32):
        super().__init__(1.0, True, freeze_param=True)
        self.from_span = self.check_range(from_span, "from_span")
        self.to_span = self.check_range(to_span, "to_span")
        self.output_dtype = output_dtype

    def apply_to_image(self, data):
        out = F.intensity_window(as_tensor(data), self.from_span,
                                 self.to_span)
        return out.to(self.output_dtype)

    def get_transform_init_args_names(self):
        return ("from_span", "to_span")


class Standardize(ImageOnlyTransform):
    """Per-volume zero mean and unit (unbiased) std
    (``intensity_transforms.py:104-114``)."""

    def __init__(self):
        super().__init__(1.0, True, freeze_param=True)

    def apply_to_image(self, data):
        return F.standardize(as_tensor(data))


class ContrastStretching(ImageOnlyTransform):
    """Sigmoid contrast stretch (``intensity_transforms.py:27-77``; not in
    the training chain).  ``spatial_dimension_index >= 0`` stretches each
    slice along that axis on its own (``:48-57``)."""

    def __init__(self, p=0.5, always_apply=False, gamma=(1.0, 3.0),
                 middle_point=(0.3, 0.7), rescale=False,
                 spatial_dimension_index=-1):
        super().__init__(p, always_apply)
        self.gamma = gamma
        self.middle_point = middle_point
        self.rescale = rescale
        self.spatial_dimension_index = spatial_dimension_index

    def get_params(self, data_dict, rng):
        return {"gamma": _draw(self.gamma, rng),
                "middle_point": _draw(self.middle_point, rng)}

    def apply_to_image(self, data):
        data = as_tensor(data)
        args = (self.rescale, self.params["middle_point"],
                self.params["gamma"])
        idx = self.spatial_dimension_index
        if idx == -1:
            return F.contrast_stretching(data, *args)
        return torch.cat([F.contrast_stretching(s, *args)
                          for s in torch.split(data, 1, dim=idx)], dim=idx)

    def get_transform_init_args_names(self):
        return ("gamma", "middle_point", "rescale",
                "spatial_dimension_index")


class GaussianSmooth(ImageOnlyTransform):
    """Separable gaussian blur (``intensity_transforms.py:117-142``)."""

    def __init__(self, p=0.5, always_apply=False, sigma=(0.5, 2.0),
                 truncate=4.0):
        super().__init__(p, always_apply)
        self.sigma = sigma
        self.truncate = truncate

    def get_params(self, data_dict, rng):
        return {"sigma": _draw(self.sigma, rng)}

    def apply_to_image(self, data):
        return F.gaussian_smooth(as_tensor(data), self.params["sigma"],
                                 self.truncate)

    def get_transform_init_args_names(self):
        return ("sigma", "truncate")


class GaussianAdditive(ImageOnlyTransform):
    """Additive gaussian noise in rescaled [0, 1] space, sigma ~ U(0.03,
    0.06) (``intensity_transforms.py:145-177``; the reference spells it
    ``GaussianAddictive``, exported as an alias).

    The N(0, 1) field comes from a ``torch.Generator`` on the data's device
    seeded by the drawn ``noise_seed`` (card and CPU generators draw
    different fields), unless ``params`` holds a pre-drawn field ``eps``
    (the op's argument, as JAX's ``gaussian_additive_noise`` takes one):
    a frozen transform then adds that field wherever the data lies."""

    def __init__(self, p=0.5, always_apply=False, sigma=(0.03, 0.06)):
        super().__init__(p, always_apply)
        self.sigma = sigma

    def get_params(self, data_dict, rng):
        return {"sigma": _draw(self.sigma, rng),
                "noise_seed": int(rng.randint(0, 2 ** 31 - 1))}

    def apply_to_image(self, data):
        data = as_tensor(data)
        eps = self.params.get("eps")
        if eps is None:
            gen = torch.Generator(data.device).manual_seed(
                self.params["noise_seed"])
            eps = torch.randn(data.shape, generator=gen,
                              dtype=torch.float32, device=data.device)
        return F.gaussian_additive_noise(data, float(self.params["sigma"]),
                                         as_tensor(eps).to(data.device))

    def get_transform_init_args_names(self):
        return ("sigma",)


GaussianAddictive = GaussianAdditive  # the reference's spelling


class BoxMaskOut(ImageOnlyTransform):
    """Random box cut-out (``intensity_transforms.py:180-237``; the
    training chain: 1-10 boxes of 1-6% of each axis centred in the middle
    20-80%, ``models.py:67``).  As in the JAX package, ``n_masks[1]`` boxes
    are always drawn and ``valid`` marks the first ``n`` of them."""

    def __init__(self, p: float, always_apply: bool,
                 n_masks: Union[int, Tuple[int, int]],
                 region_range=(0.2, 0.8), region_size=(0.01, 0.06),
                 assign_value: float = 0, freeze_param: bool = False):
        super().__init__(p, always_apply, freeze_param=freeze_param)
        self.region_range = self.check_positive_range(region_range,
                                                      "region_range")
        self.region_size = self.check_positive_range(region_size,
                                                     "region_size")
        self.n_masks = n_masks
        self.assign_value = assign_value

    def get_params(self, data_dict, rng):
        ndim = np.ndim(data_dict["image"])
        ranged = isinstance(self.n_masks, (tuple, list))
        max_n = self.n_masks[1] if ranged else self.n_masks
        n = (rng.randint(self.n_masks[0], self.n_masks[1] + 1) if ranged
             else self.n_masks)
        centers = rng.uniform(self.region_range[0], self.region_range[1],
                              (max_n, ndim))
        sizes = rng.uniform(self.region_size[0], self.region_size[1],
                            (max_n, ndim))
        return {"n_masks": n, "mask_centers": centers, "mask_sizes": sizes,
                "valid": np.arange(max_n) < n}

    def apply_to_image(self, data):
        data = as_tensor(data)
        dev = data.device
        return F.box_cutout(
            data,
            torch.as_tensor(self.params["mask_centers"], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(self.params["mask_sizes"], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(self.params["valid"], device=dev),
            self.assign_value)

    def get_transform_init_args_names(self):
        return ("region_range", "region_size", "n_masks", "assign_value")
