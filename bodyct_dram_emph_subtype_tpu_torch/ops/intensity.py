"""Intensity-domain ops: the transform framework's and the training
augmentation's.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/intensity.py``:
``intensity_window`` (reference ``functional.py:13-26``),
``contrast_stretching`` (``functional.py:29-41``), ``standardize``
(``intensity_transforms.py:104-114``), ``gaussian_kernel_1d`` and
``gaussian_smooth`` (``functional.py:44-64``), ``gaussian_additive_noise``
(``intensity_transforms.py:145-177``) and ``box_cutout``
(``intensity_transforms.py:180-237``).  The random numbers come in as
arguments (``transforms/batch_augment.py`` and the transforms'
``get_params`` draw them): ``jax.random`` and torch give different
streams, so only the deterministic apply step is held against the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

EPSILON = 1e-7


def intensity_window(img: torch.Tensor,
                     from_span: Optional[Tuple[float, float]] = (-1150, 350),
                     to_span: Tuple[float, float] = (0, 255)
                     ) -> torch.Tensor:
    """Clip to ``from_span`` (None: the data's min and max), then rescale
    into ``to_span``; float32."""
    img = img.to(torch.float32)
    if from_span is None:
        lo, hi = img.min(), img.max()
    else:
        lo, hi = from_span
    img = torch.clamp(img, lo, hi)
    return ((img - lo) / (hi - lo)) * (to_span[1] - to_span[0]) + to_span[0]


def contrast_stretching(img: torch.Tensor, rescale: bool, middle_point: float,
                        gamma: float) -> torch.Tensor:
    """Sigmoid contrast stretch ``1 / (1 + (m / (x + eps)) ** gamma)``, on
    ``x`` min-max rescaled to [0, 1] first with ``rescale``."""
    img = img.to(torch.float32)
    if rescale:
        d_min = img.min()
        img = (img - d_min) / (img.max() - d_min + EPSILON)
    return 1.0 / (1.0 + (middle_point / (img + EPSILON)) ** gamma)


def standardize(img: torch.Tensor) -> torch.Tensor:
    """Per-volume zero mean and unit std, the std unbiased (ddof 1), as the
    reference's ``Tensor.std()``."""
    img = img.to(torch.float32)
    return (img - img.mean()) / img.std()


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0,
                       device=None) -> torch.Tensor:
    """Normalised 1-D gaussian taps of radius ``int(truncate*sigma + 0.5)``."""
    radius = int(truncate * float(sigma) + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    phi = torch.exp(-0.5 / float(sigma) ** 2 * x ** 2)
    return phi / phi.sum()


def _conv1d_same(x: torch.Tensor, kernel: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """1-D correlation along ``axis`` with zero 'same' padding."""
    moved = torch.movedim(x, axis, -1)
    n = moved.shape[-1]
    pad = (kernel.shape[0] - 1) // 2
    flat = F.pad(moved.reshape(-1, 1, n), (pad, kernel.shape[0] - 1 - pad))
    out = F.conv1d(flat, kernel.reshape(1, 1, -1))
    return torch.movedim(out.reshape(moved.shape), -1, axis)


def gaussian_smooth(img: torch.Tensor, sigma: float,
                    truncate: float = 4.0) -> torch.Tensor:
    """Separable gaussian blur over every axis, zero 'same' padding;
    float32."""
    kernel = gaussian_kernel_1d(sigma, truncate, img.device)
    img = img.to(torch.float32)
    for axis in range(img.ndim):
        img = _conv1d_same(img, kernel, axis)
    return img


def gaussian_additive_noise(img: torch.Tensor, sigma: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    """Additive noise ``sigma * eps`` in rescaled [0, 1] space, clipped,
    then mapped back to the volume's range.  ``eps``: a N(0, 1) field of
    ``img``'s shape."""
    img = img.to(torch.float32)
    d_min = img.min()
    d_range = img.max() - d_min
    rescaled = (img - d_min) / (d_range + 1e-7)
    rescaled = torch.clamp(rescaled + sigma * eps, 0.0, 1.0)
    return rescaled * d_range + d_min


def box_cutout(img: torch.Tensor, centers: torch.Tensor, sizes: torch.Tensor,
               valid: torch.Tensor, assign_value: float = 0.0
               ) -> torch.Tensor:
    """Set up to N axis-aligned boxes of an n-D (1-6) volume, (D, H, W) in
    the training chain, to ``assign_value``.  ``centers``/``sizes``:
    (N, ndim) fractions; ``valid``:
    (N,) bool, the boxes applied.  Extents use the reference's integer
    arithmetic: ``start = max(0, int(c*s) - int(m*s)//2)``, ``stop =
    min(int(c*s) + (int(m*s) - int(m*s)//2), s)``."""
    dev = img.device
    shape_f = torch.tensor(img.shape, dtype=torch.float32, device=dev)
    shape_i = torch.tensor(img.shape, dtype=torch.int32, device=dev)
    c = (centers.float() * shape_f).to(torch.int32)
    m = (sizes.float() * shape_f).to(torch.int32)
    half = torch.div(m, 2, rounding_mode="floor")
    starts = torch.clamp_min(c - half, 0)
    stops = torch.minimum(c + (m - half), shape_i)
    # a box is the outer product of per-axis indicators, so the union over
    # N boxes is one rank-N contraction
    ind = []
    for axis in range(img.ndim):
        ar = torch.arange(img.shape[axis], dtype=torch.int32,
                          device=dev)[None]
        ind.append(((ar >= starts[:, axis:axis + 1])
                    & (ar < stops[:, axis:axis + 1])).to(torch.float32))
    ind[0] = ind[0] * valid[:, None].to(torch.float32)
    axes = "dhwxyz"[:img.ndim]
    cover = torch.einsum(",".join("b" + a for a in axes) + "->" + axes,
                         *ind)
    return torch.where(cover > 0.5,
                       torch.tensor(assign_value, dtype=img.dtype,
                                    device=dev), img)
