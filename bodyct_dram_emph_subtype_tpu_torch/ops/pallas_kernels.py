"""Lung-masked sums: kernel F of the port.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/pallas_kernels.py``:
:func:`masked_sums` launches ``csrc/masked_sums.cu::masked_sums``, which
replaces the Pallas kernel ``masked_sums_pallas`` (pallas_kernels.py:46),
and :func:`lung_masked_fraction_kernel` is the counterpart of
``lung_masked_fraction_pallas`` (:69).  Per sample and channel it computes
``sum(dense * lung)`` and per sample ``sum(lung)``, in float32.  One
launch per call: a one-wave grid of per-range partials whose last block
per sample sums them in a fixed order (the design note and what bounds it
on the H100 are in the CUDA source).  float32 and bf16 maps are read in
their own dtype; the masks are float32.

Where it runs: ``ops/masked_pool.py::lung_masked_fraction`` (the dRAM
head's lesion fractions, every eval and train forward), the processor's
device-path reduction and the host-path predict step
(``train/steps.py::make_predict_step``).

A CPU tensor runs the plain version (:func:`masked_sums_plain`, float32
ATen sums); a CUDA tensor launches the kernel or raises.  Both are
bit-reproducible; they differ only in the order of the float32 sums.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import cuda_build
from .roll_conv import _dtype_code, _on_cuda, _require, _stream

MAX_CHANNELS = 127                 # C + 1 sums in the TPU kernel's 128 lanes
MAX_BATCH = 65535                  # the grid's y extent (the C entry checks)
SUMS_THREADS = 256                 # kernel F's block (csrc MT)
SUMS_BLOCKS_PER_SM = 2             # its launch bounds (csrc kBlocksPerSM)
H100_SMS = 132

# One zeroed ticket array per (device, stream), never freed: the kernel's
# last block per sample returns its ticket to 0, and calls on one stream
# run in order, so no call finds another's tickets.  A CUDA graph keeps the
# array of the stream it was captured on.  (A torch.zeros per call would
# add a fill kernel, or a memset node in a graph, to every call.)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


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


def masked_sums_splits(batch: int, voxels: int, sms: int = H100_SMS) -> int:
    """Kernel F's number S of voxel ranges per sample: one wave of
    ``SUMS_BLOCKS_PER_SM`` blocks on each of ``sms`` SMs in all, each
    block with at least 16 voxels per thread."""
    return max(1, min(-(-SUMS_BLOCKS_PER_SM * sms // batch),
                      -(-voxels // (16 * SUMS_THREADS)), 65535))


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(MAX_BATCH, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def masked_sums(dense: torch.Tensor, lung: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, D, H, W, C) ``dense`` x (B, D, H, W, 1) ``lung`` -> ((B, C)
    masked sums, (B,) lung sums), float32; C <= 127.  On a CUDA tensor
    kernel F, one launch: float32 and bf16 maps are read as they are,
    other dtypes cast to float32 first (as ``masked_sums_pallas`` casts
    every map; the widening is exact), the lung as float32; partials over
    :func:`masked_sums_splits` voxel ranges, summed in a fixed order (the
    same bits on every run).  On a CPU tensor :func:`masked_sums_plain`."""
    if not _on_cuda(dense):
        return masked_sums_plain(dense, lung)
    _check_shapes(dense, lung)
    if dense.dtype not in (torch.float32, torch.bfloat16):
        dense = dense.float()
    dense = dense.contiguous()
    lung = lung.float().contiguous()
    b, d, h, w, c = dense.shape
    dev = dense.device
    _require(lung, (b, d, h, w, 1), torch.float32, dev, "lung")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = masked_sums_splits(b, d * h * w, sms)
    ws = torch.empty((b, splits, c + 1), dtype=torch.float32, device=dev)
    num = torch.empty((b, c), dtype=torch.float32, device=dev)
    den = torch.empty((b,), dtype=torch.float32, device=dev)
    stream = _stream(dense)
    with torch.cuda.device(dev):
        err = cuda_build.library().masked_sums(
            _dtype_code(dense), dense.data_ptr(), lung.data_ptr(),
            ws.data_ptr(), _tickets(dev, stream).data_ptr(), num.data_ptr(),
            den.data_ptr(), b, d, h, w, c, splits, stream)
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
