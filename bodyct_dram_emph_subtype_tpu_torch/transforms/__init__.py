"""The per-sample transform framework (the reference's L1) and the
trainer's batched augmentation (``batch_augment.py``)."""
from .base import (BaseTransform, Compose, DualTransform, ImageOnlyTransform,
                   ToDevice, ToHost, as_rng)
from .intensity import (BoxMaskOut, ContrastStretching, GaussianAdditive,
                        GaussianAddictive, GaussianSmooth, IntensityWindow,
                        Standardize)
from .spatial import CropAndResize, Flip, Interpolate

__all__ = [
    "BaseTransform", "BoxMaskOut", "Compose", "ContrastStretching",
    "CropAndResize", "DualTransform", "Flip", "GaussianAdditive",
    "GaussianAddictive", "GaussianSmooth", "ImageOnlyTransform",
    "IntensityWindow", "Interpolate", "Standardize", "ToDevice", "ToHost",
    "as_rng", "build_pipeline",
]


def build_pipeline(target_size, train: bool, device=None) -> Compose:
    """The reference data module's chains (``models.py:55-80``): always
    ``ToDevice -> IntensityWindow((-1150, -300) -> (0, 1)) -> Standardize
    -> Interpolate(align_corners=True)``; training adds ``GaussianAdditive,
    BoxMaskOut, Flip, CropAndResize``.  ``device``: ``ToDevice``'s (the
    CUDA card by default; ``"cpu"`` on request)."""
    import torch

    chain = [
        ToDevice(device),
        IntensityWindow(from_span=(-1150, -300), to_span=(0, 1),
                        output_dtype=torch.float32),
        Standardize(),
        Interpolate(target_size, None, align_corners=True),
    ]
    if train:
        chain += [
            GaussianAdditive(p=0.5, always_apply=False),
            BoxMaskOut(p=0.5, always_apply=False, n_masks=(1, 10)),
            Flip(0.5, False, dim=(1, 3)),
            CropAndResize(0.5, False, (0.45, 0.55), (0.95, 1.0),
                          align_corners=True),
        ]
    return Compose(chain)
