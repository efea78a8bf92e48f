"""The quad stem switch: the eval stem + pool on kernel E.

Counterpart of ``bodyct_dram_emph_subtype_tpu/models/experimental.py``
(the quad stem; the pair stem, which runs only kernel 3, is not ported)
and of the gate ``stem_quad_supported`` with the size floor
``_ROLL_MIN_ELEMS`` it reads (``models/packed.py:139-160, 295``).

Off by default, as in the JAX package.  :func:`set_quad_stem_enable`
switches it on; :func:`use_quad_stem` then takes it in an eval forward
under conv mode ``roll`` with a packed decoder, where the JAX package's
shape gates pass: ``ResNetSegReg`` runs the stem conv, BN, ReLU and pool
in one launch of kernel E (``ops/stem_kernel.py::fused_stem_pool``) where
``supports_fused_stem`` holds, else cuDNN conv, BN, ReLU and kernel C
(``experimental.py:146-150``), and layer1 then runs as ``fused_layer1``.
The quad-lane stem layout is a TPU layout: the port's stem stays NDHWC.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.maxpool_kernel import supports_maxpool_quads

_QUAD_STEM_ENABLE = False

# The JAX package's floor (per-sample packed elements) for its kernel
# paths; here only the quad-stem gate reads it.  Tests patch it to 0 for
# tiny shapes, as the JAX tests patch ``models.packed._ROLL_MIN_ELEMS``.
_ROLL_MIN_ELEMS = 2 * 2 ** 20


def set_quad_stem_enable(on: bool) -> None:
    """Switch the quad stem -> pool path on or off."""
    global _QUAD_STEM_ENABLE
    _QUAD_STEM_ENABLE = bool(on)


def stem_quad_supported(shape: Sequence[int], features: int = 64,
                        itemsize: int = 2) -> bool:
    """The JAX gate: a 1-channel input with (2, 2, 8)-divisible dims (the
    JAX stem's space-to-depth factors, which the port has no switch for),
    the size floor, and its pool kernel's gate on the quad stem shape."""
    if len(shape) != 5 or shape[-1] != 1:
        return False
    b, d, h, w, _ = shape
    if d % 4 or h % 4 or w % 8:
        return False
    n = (d // 2) * (h // 2) * (w // 2) * features
    if n < _ROLL_MIN_ELEMS:
        return False
    return supports_maxpool_quads((b, d // 2, h // 2, w // 8, 4 * features),
                                  itemsize)


def use_quad_stem(x_shape: Sequence[int], train: bool, packed_decoder: bool,
                  dtype: torch.dtype) -> bool:
    """Gate of the quad stem path: eval, conv mode ``roll``, a packed
    decoder, the switch on, and :func:`stem_quad_supported`."""
    from . import blocks
    if train or not packed_decoder or blocks.get_conv3d_mode() != "roll":
        return False
    if not _QUAD_STEM_ENABLE:
        return False
    return stem_quad_supported(tuple(x_shape), 64, dtype.itemsize)
