"""The quad and pair stem switches of the eval forward.

Counterpart of ``bodyct_dram_emph_subtype_tpu/models/experimental.py``
(``set_quad_stem_enable``, ``use_quad_stem``, ``set_pair_stem_enable``,
``use_pair_stem``) and of the gate ``stem_quad_supported`` with the size
floor ``_ROLL_MIN_ELEMS`` it reads (``models/packed.py:139-160, 295``).

Off by default, as in the JAX package.  :func:`set_quad_stem_enable`
switches it on; :func:`use_quad_stem` then takes it in an eval forward
under conv mode ``roll`` with a packed decoder, where the JAX package's
shape gates pass: ``ResNetSegReg`` runs the stem conv, BN, ReLU and pool
in one launch of kernel E (``ops/stem_kernel.py::fused_stem_pool``) where
``supports_fused_stem`` holds, else cuDNN conv, BN, ReLU and kernel C
(``experimental.py:146-150``), and layer1 then runs as ``fused_layer1``.
The quad-lane stem layout is a TPU layout: the port's stem stays NDHWC.

The pair stem, off by default too (:func:`set_pair_stem_enable`), is a
TPU layout of the same route: the JAX stem conv writes the W-pair packed
activation that its pool + layer1 kernel reads (``ops/layer1_kernel.py``
``:370`` into ``:388``).  :func:`use_pair_stem` copies JAX's gate
(``experimental.py:68-89``) but for the VMEM budget of
``supports_fused_pool_layer``, which the port's kernels do not have; the
gate reads no size floor.  Where it holds, the port's forward takes its
default route (stem conv, BN, ReLU, ``fused_pool_layer1``: kernel C and
2 x A per block), with the same launches and the same numbers.
"""
from __future__ import annotations

import logging
from typing import Sequence

import torch

from ..ops.maxpool_kernel import supports_maxpool_quads
from ..parallel import spatial, tensor

logger = logging.getLogger(__name__)
_MESH_WARNED = []

_QUAD_STEM_ENABLE = False
_PAIR_STEM_ENABLE = False

# The JAX package's floor (per-sample packed elements) for its kernel
# paths; here only the quad-stem gate reads it.  Tests patch it to 0 for
# tiny shapes, as the JAX tests patch ``models.packed._ROLL_MIN_ELEMS``.
_ROLL_MIN_ELEMS = 2 * 2 ** 20


def set_quad_stem_enable(on: bool) -> None:
    """Switch the quad stem -> pool path on or off."""
    global _QUAD_STEM_ENABLE
    _QUAD_STEM_ENABLE = bool(on)


def set_pair_stem_enable(on: bool) -> None:
    """Switch the pair stem -> fused pool + layer1 path on or off."""
    global _PAIR_STEM_ENABLE
    _PAIR_STEM_ENABLE = bool(on)


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


def _off_on_mesh() -> bool:
    """True on H slabs (``parallel/spatial.py``) or a model axis
    (``parallel/tensor.py``), where both stems are off with one warning,
    as JAX's gate turns its fast path off on a spatial or model mesh
    (``parallel/mesh.py:129-133``, ``experimental.py:61-62``)."""
    if not spatial.active() and tensor.size() == 1:
        return False
    if not _MESH_WARNED:
        _MESH_WARNED.append(True)
        logger.warning("quad and pair stems off on a spatial or model "
                       "axis: the default stem route runs")
    return True


def use_quad_stem(x_shape: Sequence[int], train: bool, packed_decoder: bool,
                  dtype: torch.dtype) -> bool:
    """Gate of the quad stem path: eval, conv mode ``roll``, a packed
    decoder, the switch on, no spatial or model axis, and
    :func:`stem_quad_supported`."""
    from . import blocks
    if train or not packed_decoder or blocks.get_conv3d_mode() != "roll":
        return False
    if not _QUAD_STEM_ENABLE or _off_on_mesh():
        return False
    return stem_quad_supported(tuple(x_shape), 64, dtype.itemsize)


def use_pair_stem(x_shape: Sequence[int], train: bool, packed_decoder: bool,
                  dtype: torch.dtype, n_blocks: int) -> bool:
    """Gate of the pair stem path: eval, conv mode ``roll``, a packed
    decoder, the switch on, no spatial or model axis, a 1-channel 5-D input
    with ``d % 4``, ``h % 4`` and ``w % 8`` all 0.  ``dtype`` and
    ``n_blocks`` (layer1's depth) fed JAX's VMEM budget, which is not
    ported; they are kept so that the call reads as JAX's."""
    from . import blocks
    if train or not packed_decoder or blocks.get_conv3d_mode() != "roll":
        return False
    if not _PAIR_STEM_ENABLE or _off_on_mesh():
        return False
    if len(x_shape) != 5 or x_shape[-1] != 1:
        return False
    _, d, h, w, _ = x_shape
    return not (d % 4 or h % 4 or w % 8)
