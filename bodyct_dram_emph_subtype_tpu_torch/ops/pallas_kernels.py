"""Lung-masked sums: kernel F of the port.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/pallas_kernels.py``:
:func:`masked_sums` launches ``csrc/masked_sums.cu::masked_sums``, which
replaces the Pallas kernel ``masked_sums_pallas`` (pallas_kernels.py:46),
and :func:`lung_masked_fraction_kernel` is the counterpart of
``lung_masked_fraction_pallas`` (:69).  Per sample and channel it computes
``sum(dense * lung)`` and per sample ``sum(lung)``, in float32.  The
design note and what bounds it on the H100 are in the CUDA source.

Where it runs: ``ops/masked_pool.py::lung_masked_fraction`` (the dRAM
head's lesion fractions, every eval and train forward), the processor's
device-path reduction and the host-path predict step
(``train/steps.py::make_predict_step``).

A CPU tensor runs the plain version (:func:`masked_sums_plain`, float32
ATen sums); a CUDA tensor launches the kernel or raises.  Both are
bit-reproducible; they differ only in the order of the float32 sums.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_build
from .roll_conv import _on_cuda, _require, _stream

MAX_CHANNELS = 127                 # C + 1 sums in the TPU kernel's 128 lanes
SUMS_THREADS = 256                 # kernel F's block
SUMS_TARGET_BLOCKS = 8 * 132       # 8 blocks per H100 SM


def _check_shapes(dense: torch.Tensor, lung: torch.Tensor) -> None:
    if dense.dim() != 5 or tuple(lung.shape) != tuple(dense.shape[:4]) + (1,):
        raise ValueError(f"dense must be (B, D, H, W, C) and lung "
                         f"(B, D, H, W, 1), got {tuple(dense.shape)} and "
                         f"{tuple(lung.shape)}")
    if dense.shape[-1] > MAX_CHANNELS:
        raise ValueError(f"masked sums take at most {MAX_CHANNELS} channels, "
                         f"got {dense.shape[-1]}")


def masked_sums_plain(dense: torch.Tensor, lung: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: float32 ``(dense * lung).sum((1, 2, 3))`` and
    ``lung.sum((1, 2, 3, 4))``."""
    _check_shapes(dense, lung)
    dense, lung = dense.float(), lung.float()
    return (dense * lung).sum((1, 2, 3)), lung.sum((1, 2, 3, 4))


def masked_sums_splits(batch: int, voxels: int) -> int:
    """Kernel F's number S of voxel ranges per sample: about
    ``SUMS_TARGET_BLOCKS`` blocks in all, each with at least 16 voxels per
    thread."""
    return max(1, min(-(-SUMS_TARGET_BLOCKS // batch),
                      -(-voxels // (16 * SUMS_THREADS)), 65535))


def masked_sums(dense: torch.Tensor, lung: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, H, W, C) ``dense`` x (B, D, H, W, 1) ``lung`` -> ((B, C)
    masked sums, (B,) lung sums), float32; C <= 127.  Other dtypes are cast
    to float32 first, as ``masked_sums_pallas`` casts them.  On a CUDA
    tensor kernel F (partials over :func:`masked_sums_splits` voxel ranges,
    summed in a fixed order: no atomics, the same bits on every run); on a
    CPU tensor :func:`masked_sums_plain`."""
    if not _on_cuda(dense):
        return masked_sums_plain(dense, lung)
    _check_shapes(dense, lung)
    dense = dense.float().contiguous()
    lung = lung.float().contiguous()
    b, d, h, w, c = dense.shape
    dev = dense.device
    _require(lung, (b, d, h, w, 1), torch.float32, dev, "lung")
    splits = masked_sums_splits(b, d * h * w)
    ws = torch.empty((b, splits, c + 1), dtype=torch.float32, device=dev)
    num = torch.empty((b, c), dtype=torch.float32, device=dev)
    den = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().masked_sums(
            dense.data_ptr(), lung.data_ptr(), ws.data_ptr(), num.data_ptr(),
            den.data_ptr(), b, d, h, w, c, splits, _stream(dense))
    cuda_build.check(err, "masked_sums")
    cuda_build.launched("masked_sums")
    return num, den


def lung_masked_fraction_kernel(dense: torch.Tensor, lung: torch.Tensor
                                ) -> torch.Tensor:
    """``sum(dense * lung) / sum(lung)`` per sample and channel, (B, C)
    float32, for a lung already at the dense resolution (the counterpart
    of ``lung_masked_fraction_pallas``)."""
    num, den = masked_sums(dense, lung)
    return num / den[:, None]
