"""Eval residual stacks of identity BasicBlocks, built from kernels A and C.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/layer1_kernel.py``:

- :func:`fused_layer1` replaces the Pallas kernel ``fused_layer1``
  (layer1_kernel.py:142): NB blocks of conv-BN-ReLU-conv-BN-(+x)-ReLU with
  BN folded into per-channel affines.  The resnet34 deployment runs it on
  the layer2 tail (blocks 1-3, 128 channels at 16x28x36).
- :func:`fused_pool_layer1` replaces ``_fused_pool_layer1_quadview``
  (layer1_kernel.py:388, via ``fused_pool_layer1``, :344): the k3 s2 p1
  stem max-pool, then layer1 (3 blocks, 64 channels at 32x56x72).

Source note.  The TPU kernels keep the whole per-item layer activation
resident in VMEM (~16.5 MB W-pair packed, layer1_kernel.py:11-13), so the
intermediate activations never touch HBM.  A Hopper block has at most
227 KB of shared memory, so that residency is out of reach: the port runs
the stack as 2*NB launches of kernel A (``csrc/conv3x3x3.cu``), each conv
with BatchNorm, ReLU and — for the second conv of a block — the residual
add fused into its epilogue, and ``fused_pool_layer1`` is kernel C
(``csrc/maxpool3d.cu``) followed by the same loop.  Each intermediate
activation makes one round trip through device memory (at B=2 layer1's is
33 MB in bf16, well inside the 50 MB L2); the convs themselves are bound
by arithmetic, so the round trips are not what bounds the stack.

On CPU tensors the wrappers run their plain versions, so these functions
need no plain twin of their own.

On H slabs (``parallel/spatial.py``) each launch runs on its slab
extended by the op's halo, exchanged before it: one row each side for a
conv, whose residual is padded with zero rows that the crop drops, and
two rows above for the stride-2 pool (:func:`pool_k3s2p1`).  On a model
axis (``parallel/tensor.py``) each conv takes its O-slice of the kernel
and the affine, its residual slice, and its output is gathered.  The
launches per rank are those of one process.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..parallel import spatial, tensor
from .maxpool_kernel import max_pool_k3s2p1
from .roll_conv import roll_conv_affine_relu


def pool_k3s2p1(x: torch.Tensor) -> torch.Tensor:
    """Kernel C's k3 s2 p1 max-pool on this rank's H slab (with its halo)
    or on the whole volume."""
    return spatial.halo_apply(max_pool_k3s2p1, x, 3, 2, 1, 1)


def conv_a(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
           shift: torch.Tensor, residual=None) -> torch.Tensor:
    """``roll_conv_affine_relu`` (kernel A, stride 1, pad 1) on this rank's
    H slab (with its halo; ``residual`` padded with zero rows) or on the
    whole volume."""
    if residual is None:
        return spatial.halo_apply(
            lambda x: roll_conv_affine_relu(x, kernel, scale, shift), x, 3,
            1, 1, 1)
    return spatial.halo_apply(
        lambda x, r: roll_conv_affine_relu(x, kernel, scale, shift,
                                           residual=r), x, 3, 1, 1, 1,
        (residual,))


def fused_layer1(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                 muls: Sequence[torch.Tensor],
                 adds: Sequence[torch.Tensor]) -> torch.Tensor:
    """Residual stack on NDHWC ``x`` (B, D, H, W, C).

    ``kernels``: 2*NB logical (3,3,3,C,C) kernels in execution order
    (block0 conv1, block0 conv2, block1 conv1, ...); ``muls``/``adds``: the
    matching folded eval-BN affines, (C,) float32.  Returns the same shape
    and dtype as ``x``."""
    if not (len(kernels) == len(muls) == len(adds)) or len(kernels) % 2:
        raise ValueError("need 2*NB kernels with one affine each")
    for i in range(0, len(kernels), 2):
        # identity blocks (O == C): a kernel of fewer outputs than x has
        # channels is a model-axis slice, whose output is gathered
        part = kernels[i].shape[-1] < x.shape[-1]
        gather = tensor.gather_channels if part else (lambda t: t)
        h = gather(conv_a(x, kernels[i], muls[i], adds[i]))
        res = tensor.channel_slice(x).contiguous() if part else x
        x = gather(conv_a(h, kernels[i + 1], muls[i + 1], adds[i + 1],
                          residual=res))
    return x


def fused_pool_layer1(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                      muls: Sequence[torch.Tensor],
                      adds: Sequence[torch.Tensor]) -> torch.Tensor:
    """k3 s2 p1 max-pool of the post-ReLU NDHWC stem, then
    :func:`fused_layer1`.  Returns (B, D/2, H/2, W/2, C) NDHWC."""
    return fused_layer1(pool_k3s2p1(x), kernels, muls, adds)
