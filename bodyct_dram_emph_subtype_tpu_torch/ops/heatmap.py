"""The processor's heatmaps: kernel G of the port.

The deployment processor writes each scan's CLE and PSE maps as uint8
heatmaps of its lung crop.  Two stages take the model's maps there:

1. :func:`upsample_masked` (device path): the float16 half maps
   (B, d, h, w, 2) upsampled to the model size and zeroed where the ess
   mask is 0, float32 (B, D, H, W, 2);
2. :func:`quantised_crops` (both paths): the masked model-size maps
   resampled to each scan's crop and quantised, ``uint8(trunc(clip(x, 0,
   1) * 255))``, each map's crop at the start of its row of a (B, 2, N)
   uint8 buffer (:func:`row_length`).

Both resizes are the two-tap ``align_corners`` linear resize of
``data/host_preprocess.py::resize_linear_matmul_np`` (its axis order and
float64-derived taps), so every byte equals the numpy postprocess's
``resize_linear_matmul_np`` + mask + ``windowing(x, (0, 1))`` cast to
uint8.  A CUDA tensor launches ``csrc/heatmap.cu`` (one launch per
stage); a CPU tensor runs the plain version (:func:`upsample_masked_plain`,
:func:`quantised_crops_plain`: ``ops/resize.py::resize_linear`` in the
same axis order), byte for byte the same.

Where it runs: ``inference/processor.py``, after the reduction of each
device-path batch (both stages) and host-path batch (stage 2).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from ..data.host_preprocess import _linear_taps
from .resize import resize_linear
from .roll_conv import _on_cuda, _require, _stream

MAPS = 2                       # CLE and PSE, channels-last
# the axis orders of a 3-D resize, indexed as csrc/heatmap.cu's switch
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
ENTRY = 8                      # ints of a table entry's header
ROW_ALIGN = 16                 # bytes: a crop row's length divides by it

Shape = Tuple[int, int, int]


def axis_order(in_shape: Sequence[int], out_shape: Sequence[int]) -> Shape:
    """``resize_linear_matmul_np``'s order of the axes: ascending out / in,
    a stable sort."""
    return tuple(sorted(range(3), key=lambda a: out_shape[a] / in_shape[a]))


def resample_table(in_shape: Sequence[int],
                   out_shapes: Sequence[Sequence[int]]) -> np.ndarray:
    """The int32 table of kernel G: per output shape a header ``{n0, n1,
    n2, perm, off0, off1, off2, 0}`` (``perm`` indexes :data:`PERMS`;
    ``off_a`` is axis a's arrays' offset from the header), then per entry
    and axis the arrays ``i0``, ``i1`` and the bits of the float32 ``w`` of
    ``_linear_taps(n_a, in_a, align_corners=True)``."""
    heads = np.zeros((len(out_shapes), ENTRY), np.int32)
    taps = []
    at = heads.size
    for e, out in enumerate(out_shapes):
        heads[e, :3] = out
        heads[e, 3] = PERMS.index(axis_order(in_shape, out))
        for a in range(3):
            i0, i1, w = _linear_taps(int(out[a]), int(in_shape[a]), True)
            heads[e, 4 + a] = at - e * ENTRY
            taps += [i0.astype(np.int32), i1.astype(np.int32),
                     w.astype(np.float32).view(np.int32)]
            at += 3 * int(out[a])
    return np.concatenate([heads.ravel(), *taps])


def row_length(crops: Sequence[Sequence[int]]) -> int:
    """N of the (B, 2, N) crop buffer: the largest crop's voxel count,
    rounded up to :data:`ROW_ALIGN` (at least one row of it)."""
    n = max([int(np.prod(c)) for c in crops] + [1])
    return -(-n // ROW_ALIGN) * ROW_ALIGN


def _table(table: np.ndarray, dev: torch.device) -> torch.Tensor:
    # pinned, so the copy is asynchronous; the caching host allocator keeps
    # the block until the copy has run
    return torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)


def _resize(x: torch.Tensor, in_shape, out_shape, first: int
            ) -> torch.Tensor:
    """Spatial axes ``first .. first + 2`` of float32 ``x`` resized to
    ``out_shape`` in :func:`axis_order` (``resize_linear``)."""
    order = axis_order(in_shape, out_shape)
    return resize_linear(x, [out_shape[a] for a in order],
                         [first + a for a in order], align_corners=True)


def _check_maps(maps: torch.Tensor, name: str) -> None:
    if maps.dim() != 5 or maps.shape[-1] != MAPS:
        raise ValueError(f"{name} must be (B, D, H, W, {MAPS}), got "
                         f"{tuple(maps.shape)}")


def upsample_masked_plain(half: torch.Tensor, ess: torch.Tensor,
                          target_size: Sequence[int]) -> torch.Tensor:
    """Plain version of stage 1: ``half`` widened to float32, resized to
    ``target_size`` and set to 0 where ``ess`` is 0."""
    _check_maps(half, "half")
    up = _resize(half.float(), half.shape[1:4], tuple(target_size), 1)
    return up.masked_fill((ess == 0)[..., None], 0.0)


def upsample_masked(half: torch.Tensor, ess: torch.Tensor,
                    target_size: Sequence[int]) -> torch.Tensor:
    """Stage 1: float16 half maps (B, d, h, w, 2) and the uint8 ess mask
    (B, *target_size) -> float32 (B, *target_size, 2), the maps upsampled
    and masked.  One kernel-G launch on a CUDA tensor, the plain version on
    a CPU one."""
    if not _on_cuda(half):
        return upsample_masked_plain(half, ess, target_size)
    _check_maps(half, "half")
    b, d, h, w, _ = half.shape
    size = tuple(int(s) for s in target_size)
    dev = half.device
    _require(half, (b, d, h, w, MAPS), torch.float16, dev, "half")
    _require(ess, (b, *size), torch.uint8, dev, "ess")
    table = _table(resample_table((d, h, w), [size]), dev)
    out = torch.empty((b, *size, MAPS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().heatmap_upsample(
            half.data_ptr(), ess.data_ptr(), table.data_ptr(),
            out.data_ptr(), b, d, h, w, *size, _stream(half))
    cuda_build.check(err, "heatmap_upsample")
    cuda_build.launched("heatmap_upsample")
    return out


def quantised_crops_plain(maps: torch.Tensor,
                          crops: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain version of stage 2: per scan its maps resized to its crop,
    clipped to [0, 1], times 255, truncated to uint8; zero bytes after each
    crop."""
    _check_maps(maps, "maps")
    if len(crops) != maps.shape[0]:
        raise ValueError(f"{len(crops)} crops for {maps.shape[0]} scans")
    out = torch.zeros((maps.shape[0], MAPS, row_length(crops)),
                      dtype=torch.uint8, device=maps.device)
    for i, crop in enumerate(crops):
        n = int(np.prod(crop))
        if n:
            up = _resize(maps[i].float(), maps.shape[1:4], tuple(crop), 0)
            q = (torch.clamp(up, 0, 1) * 255).to(torch.uint8)
            out[i, :, :n] = q.permute(3, 0, 1, 2).reshape(MAPS, n)
    return out


def quantised_crops(maps: torch.Tensor,
                    crops: Sequence[Sequence[int]]) -> torch.Tensor:
    """Stage 2: float32 maps (B, D, H, W, 2) and each scan's crop extents
    -> (B, 2, :func:`row_length`) uint8, scan i's map c as the first
    ``prod(crops[i])`` bytes of row (i, c) in the crop's row-major order.
    A crop with a zero extent is skipped.  One kernel-G launch on a CUDA
    tensor, the plain version on a CPU one (which zeroes the rest of each
    row; the kernel leaves it unwritten)."""
    if not _on_cuda(maps):
        return quantised_crops_plain(maps, crops)
    _check_maps(maps, "maps")
    b, d, h, w, _ = maps.shape
    if len(crops) != b:
        raise ValueError(f"{len(crops)} crops for {b} scans")
    dev = maps.device
    _require(maps, (b, d, h, w, MAPS), torch.float32, dev, "maps")
    n = row_length(crops)
    if n >= 2 ** 31:
        raise ValueError(f"a crop of {n} voxels exceeds the kernel's rows")
    table = _table(resample_table((d, h, w), [tuple(c) for c in crops]),
                   dev)
    out = torch.empty((b, MAPS, n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().heatmap_crops(
            maps.data_ptr(), table.data_ptr(), out.data_ptr(), b, d, h, w,
            n, _stream(maps))
    cuda_build.check(err, "heatmap_crops")
    cuda_build.launched("heatmap_crops")
    return out
