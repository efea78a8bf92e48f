"""Spatial transforms (reference ``spatial_transforms.py``).

Counterpart of ``bodyct_dram_emph_subtype_tpu/transforms/spatial.py``:
the same parameters drawn from the same numpy RandomState, applied by the
torch ops of ``ops/resize.py`` and ``ops/grid_sample.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops.grid_sample import crop_and_resize
from ..ops.resize import interpolate_volume
from .base import DualTransform, as_tensor


class Interpolate(DualTransform):
    """Resize to the model input (``spatial_transforms.py:33-97``):
    with ``only_in_plane`` (the default, the pipeline's mode) images
    bilinear in-plane to (H, W) and masks nearest, both taking the depth
    slices of the truncated ``linspace``; the result in the input dtype
    (``:68``)."""

    def __init__(self, target_size, scale_factor=None, align_corners=False,
                 mode=None, only_in_plane=True):
        super().__init__(p=1.0, always_apply=True, freeze_param=True)
        if target_size is None and scale_factor is None:
            raise ValueError("Either target_size or scale_factor must be "
                             "given.")
        if scale_factor is not None:
            raise NotImplementedError(
                "scale_factor mode is unused by the reference pipeline")
        self.target_size = tuple(target_size)
        self.scale_factor = scale_factor
        self.align_corners = align_corners
        self.only_in_plane = only_in_plane
        self.mode = mode

    def apply_to_image(self, data):
        data = as_tensor(data)
        return interpolate_volume(data, self.target_size, is_mask=False,
                                  only_in_plane=self.only_in_plane,
                                  align_corners=self.align_corners
                                  ).to(data.dtype)

    def apply_to_mask(self, data):
        data = as_tensor(data)
        return interpolate_volume(data.to(torch.float32), self.target_size,
                                  is_mask=True,
                                  only_in_plane=self.only_in_plane
                                  ).to(data.dtype)

    def get_transform_init_args_names(self):
        return ("target_size", "scale_factor", "align_corners", "mode",
                "only_in_plane")


class Flip(DualTransform):
    """Flip a random subset of axes (``spatial_transforms.py:100-131``).
    The reference's quirk is kept: ``dim=(lo, hi)`` draws how many axes to
    flip as ``randint(lo, hi)`` (hi exclusive), then that many distinct
    axes; the training chain's ``dim=(1, 3)`` flips 1 or 2 of the 3."""

    def __init__(self, p, always_apply, dim: Union[int, Tuple[int, int]]):
        super().__init__(p=p, always_apply=always_apply)
        self.dim = dim

    def get_params(self, data_dict, rng):
        n_axes = rng.randint(self.dim[0], self.dim[1])
        ndim = np.ndim(data_dict["image"])
        combs = rng.choice(ndim, size=n_axes, replace=False)
        return {"combs": [int(c) for c in combs]}

    def _apply(self, data):
        return torch.flip(as_tensor(data), dims=self.params["combs"])

    def apply_to_image(self, data):
        return self._apply(data)

    def apply_to_mask(self, data):
        return self._apply(data)

    def get_transform_init_args_names(self):
        return ("dim",)


class CropAndResize(DualTransform):
    """Random crop resampled back to the volume's size
    (``spatial_transforms.py:133-197``; the training chain draws centres
    U(0.45, 0.55) and sizes U(0.95, 1.0) per axis, ``models.py:70-74``);
    images bilinear with ``align_corners``, masks nearest, each cast back
    to its dtype."""

    def __init__(self, p, always_apply, crop_center: Tuple[float, float],
                 crop_size: Tuple[float, float], position_given=False,
                 mode: str = "bilinear", padding_mode: str = "zeros",
                 align_corners: Optional[bool] = None):
        super().__init__(p, always_apply)
        self.crop_center = crop_center
        self.crop_size = crop_size
        self.position_given = position_given
        self.mode = mode
        self.padding_mode = padding_mode
        self.align_corners = align_corners

    def get_params(self, data_dict, rng):
        ndim = np.ndim(data_dict["image"])
        if self.position_given:
            return {"crop_center": self.crop_center,
                    "crop_size": self.crop_size}
        center = tuple(rng.uniform(*self.crop_center) for _ in range(ndim))
        size = tuple(rng.uniform(*self.crop_size) for _ in range(ndim))
        return {"crop_center": center, "crop_size": size}

    def apply_to_image(self, data):
        return crop_and_resize(as_tensor(data), self.params["crop_center"],
                               self.params["crop_size"], is_mask=False,
                               align_corners=bool(self.align_corners))

    def apply_to_mask(self, data):
        return crop_and_resize(as_tensor(data), self.params["crop_center"],
                               self.params["crop_size"], is_mask=True)

    def get_transform_init_args_names(self):
        return ("crop_center", "crop_size", "position_given", "align_corners",
                "padding_mode", "mode")
