"""Deployment inference pipeline — the ``processor.py`` equivalent.

Counterpart of ``bodyct_dram_emph_subtype_tpu/inference/processor.py``
(``run_inference``: ``_device_path`` and the host-preprocess path), with
the reference
Grand-Challenge contract (``processor.py:55-177``): paired MHA scans and
lobe masks in; per scan two uint8 heatmaps in the original geometry
(``images/centrilobular-emphysema-heatmap/<uid>.mha``,
``images/paraseptal-emphysema-heatmap/<uid>.mha``) and its
``results.json`` entry; the first scan's ``centrilobular-emphysema-
score.json`` and ``araseptal-emphysema-score.json`` (sic — the reference's
typo'd filename is part of the deployed contract).

Per batch of the device path (the default):

1. loader threads read each scan; its crop, dilated lung, mask-out and
   exact standardize moments are made in one pass over z-slabs of the
   crop, spread over the run's prepare pool (``data/datasets.py::
   SubtypingInference``); then, in chunks of planes on the same pool, the
   exact linspace depth planes of the CT go into an in-plane padded int16
   buffer with its block gate (the ``block``-voxel flat blocks holding a
   voxel above the HU window floor), and the lung is nearest-selected to
   the model size (``_RawPredictView``);
2. upload (JAX ``processor.py:357-414``): the dispatch thread packs the
   batch's CT as the block-gated 10-bit window-domain stream of
   ``ops/packing.py`` (only the live blocks, window-clamped, in a static
   stream of ``budget`` voxels sized by ``gated_frac``), the gate bits and
   the lung as little-endian bits; these, the extents and the moments go
   to the device (pinned, asynchronous).  The transport is exact: it
   changes no number the processor writes.  At the default pad (upload
   buffer 128x288x384, block 128, ``gated_frac`` 0.8) that is 14.2 MB +
   14 KB + 1.0 MB per scan, against 28.3 MB + 8.3 MB for int16 planes and
   a uint8 lung (counted from the shapes; ``chip_smoke.py`` phase 4
   checks them against ``stats["upload_bytes"]``);
3. on the device: the CT unpacked (``unpack10_gated_device``) and the lung
   bits unpacked, the preprocess (``ops/preprocess.py``), then the eval
   forward;
4. reduction on device: the exact lesion percentages through the
   adjoint-resize identity ``sum(resize(d)*ess) == sum(d * R^T ess)``
   (``_cached_predict_packed``, processor.py:232-242);
5. heatmaps on device (kernel G, ``ops/heatmap.py``): the maps rounded to
   f16 as the JAX package ships them, upsampled to the model size, masked
   with the ess mask, resampled to each scan's crop and quantised to
   uint8, byte for byte the JAX package's host postprocess;
6. download: the uint8 crops and the percentages are copied to pinned
   host memory right behind the batch on the stream; a completion stage
   waits for them and a postprocess stage writes each crop as its scan's
   heatmap, zero outside the crop, its slabs made and deflated on the
   run's slab pool (``_Stage``, :func:`pool_width`,
   ``data/mha.py::deflate``), overlapping the next batch's device work.

The host-preprocess path (``device_preprocess=False``, the CLI's
``--host_preprocess``: the strict reference-parity path) runs
``data/host_preprocess.py::preprocess_sample`` in the loader threads
(window, standardize, resize, with the dataset's native-dtype -910 HU ess
mask), uploads the float32 model inputs, and runs
``train/steps.py::make_predict_step``: the eval forward, both maps
upsampled to the model size and masked, the two numerators in one call of
kernel F; then kernel G's stage 2 makes the uint8 crops.  A scan whose
lung crop exceeds ``pad_shape`` in-plane does not stop the cohort: the
device path records it, warns naming it and emits a
dummy that is skipped on output, and afterwards just those scans run the
host path (``stats["host_scans"]``); so does a scan whose live blocks
exceed the stream's budget.  A ``target_size`` whose voxel count breaks
the bit-packing, or a ``pad_shape`` whose upload buffer has no gate block
(``pick_gate_block`` returns 0), sends the whole run to the host path with
a warning.  Results keep the cohort (glob) order.

In a process group of W ranks each data index runs this pipeline over
its shard of the scans and writes their heatmaps; the results are
gathered and rank 0 writes the JSONs (``run_inference``).  On a spatial
axis the ranks of a group score the same scans, each its H slab of the
model input (``parallel/spatial.py``), and the group's first rank writes
their files.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..data.datasets import (CLE_RATIO_MAP, PSE_RATIO_MAP, SubtypingInference,
                             ratio_to_label)
from ..data.host_preprocess import (depth_indices_np, preprocess_sample,
                                    resize_nearest_np)
from ..data.loader import DataLoader
from ..data.mha import SlabMap, deflate, pasted_planes, write_mha_file
from ..data.samplers import shard_indices
from ..models.registry import get_model_by_name
from ..models.torch_import import load_weights_file
from ..ops import cuda_build
from ..ops.heatmap import Shape, quantised_crops, upsample_masked
from ..ops.packing import (WINDOW_LO, gated_budget,
                           pack10_gated_host, pick_gate_block,
                           unpack10_gated_device)
from ..ops.pallas_kernels import masked_sums
from ..ops.preprocess import fused_preprocess_preselected
from ..ops.resize import resize_linear_matmul_transpose
from ..parallel import spatial, tensor
from ..parallel.mesh import coords, gather_objects, is_leader, mesh, rank, \
    world_size
from ..train.checkpoint import CheckpointManager
from ..train.steps import make_predict_step
from ..utils.device import entry_device
from ..utils.spans import span

logger = logging.getLogger(__name__)

STAGES = ("upload", "preprocess", "forward", "reduction", "heatmap",
          "download")
# the forward's two parts, split where the model marks ``decoder``: the
# stem through layer4, then us1, us2, us3 and the heads
FORWARD_SPLIT = ("trunk", "decoder")
# host-clock counters of ``stats["stage_ms"]``, each the summed time of the
# ``utils/spans.py`` span of the same name: the dispatch thread's waits on
# the loader and on the postprocess, the loader workers' MHA reads and the
# rest of each item, and the parts of the postprocess (kernel G took over
# ``post.upsample`` and ``post.uncrop``: they stay, and read 0)
COUNTERS = ("wait.loader", "wait.post", "io.read", "io.prepare",
            "post.upsample", "post.uncrop", "post.quantise", "post.zlib",
            "post.write")


class _PredictView:
    """Host-path loader view: per scan, ``preprocess_sample`` resizes the
    image and the masks to the model size (``original_image`` dropped)."""

    def __init__(self, dataset: SubtypingInference, target_size):
        self.dataset = dataset
        self.target_size = tuple(target_size)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        sample = self.dataset[index]
        with span("io.prepare", self.dataset.counters):
            sample.pop("original_image", None)
            if "ess_mask" not in sample:
                # the lean (compute_ess=False) dataset of the device path
                # leaves the -910 HU mask to its consumer: thresholded here
                # on the int16 crop, as the JAX package does
                # (processor.py:67-72)
                sample["ess_mask"] = np.logical_and(
                    np.asarray(sample["image"]) < -910,
                    np.asarray(sample["lung_mask"]))
            return preprocess_sample(sample, self.target_size)


class _RawPredictView:
    """Device-path loader view: the cropped raw int16 CT, depth-preselected
    to ``up_shape[0]`` planes (bit-identical to the device's linspace
    selection) and padded in-plane to ``up_shape``, with its block gate
    (``gate_blocks_np(img > WINDOW_LO)``, computed here so that the
    dispatch thread's packing does not scan the buffer again); the lung
    nearest-selected all the way to ``target_size``; the standardize
    moments from exact integer sums, taken in the dataset's slab pass.
    The selected planes are made in chunks of ``PLANE_CHUNK`` on the
    dataset's ``slab_map``.

    A scan whose lung crop exceeds ``up_shape`` in-plane, or whose live
    blocks exceed ``budget`` voxels, does not abort the cohort: its index
    goes into :attr:`oversized` (the loader workers are threads, so the
    caller sees it), a warning names the scan, and a dummy zero-lung item
    marked ``oversized`` takes its place; the caller skips the dummy on
    output and re-runs those scans on the host path (JAX
    ``processor.py:76-164``)."""

    PLANE_CHUNK = 4

    def __init__(self, dataset: SubtypingInference, up_shape, target_size,
                 budget: int, block: int):
        self.dataset = dataset
        self.up_shape = tuple(up_shape)      # (target_d, Hpad, Wpad)
        self.target_size = tuple(target_size)
        self.budget = int(budget)
        self.block = int(block)
        self.nblk = int(np.prod(self.up_shape)) // self.block
        self.oversized: Set[int] = set()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def _dummy(self, index, d, why: str):
        with self._lock:
            self.oversized.add(index)
        logger.warning(
            "scan %s %s — will fall back to host preprocessing for this "
            "scan only", d["uid"], why)
        return {"image_raw": np.full(self.up_shape, -2048, np.int16),
                "gate_blocks": np.zeros(self.nblk, bool),
                "lung_raw": np.zeros(self.target_size, np.uint8),
                "in_sizes": np.asarray(self.up_shape, np.int32),
                "moments": np.zeros(2, np.float32),
                "uid": d["uid"], "crop_slice": d["crop_slice"],
                "original_size": d["original_size"], "oversized": True}

    def _fits(self, shape) -> bool:
        return all(s <= p for s, p in zip(shape[1:], self.up_shape[1:]))

    def __getitem__(self, index):
        # an oversized scan's dummy needs no moments
        d = self.dataset.get_data(index, moments=self._fits)
        with span("io.prepare", self.dataset.counters):
            return self._prepare(index, d)

    def _prepare(self, index, d):
        img = np.asarray(d["image"])         # int16 crop
        if not self._fits(img.shape):
            return self._dummy(index, d, f"crop {img.shape} exceeds "
                               f"in-plane pad {self.up_shape[1:]}")
        idx = depth_indices_np(img.shape[0], self.up_shape[0])
        img_p = np.empty(self.up_shape, np.int16)
        lung_sel = np.empty(self.target_size, np.uint8)
        gate = np.zeros(self.nblk, bool)
        for b0, live in (self.dataset.slab_map or map)(functools.partial(
                self._planes, img, np.asarray(d["lung_mask"]), idx, img_p,
                lung_sel), range(0, self.up_shape[0], self.PLANE_CHUNK)):
            gate[b0:b0 + len(live)] |= live
        if int(np.count_nonzero(gate)) * self.block > self.budget:
            return self._dummy(index, d, f"gated voxel count exceeds budget "
                               f"{self.budget}")
        return {"image_raw": img_p, "gate_blocks": gate, "lung_raw": lung_sel,
                "in_sizes": np.asarray(
                    (self.up_shape[0], img.shape[1], img.shape[2]), np.int32),
                "moments": d["moments"],
                "uid": d["uid"], "crop_slice": d["crop_slice"],
                "original_size": d["original_size"], "oversized": False}

    def _planes(self, img, lung, idx, img_p, lung_sel, j: int):
        """Planes ``[j, j + PLANE_CHUNK)`` of the padded buffer and of the
        selected lung; returns the first gate block they touch and the
        liveness of each block they touch (a block shared with the next
        chunk is OR-ed with its part there)."""
        j1 = min(j + self.PLANE_CHUNK, len(idx))
        _, h, w = img.shape
        out = img_p[j:j1]
        out[:, :h, :w] = img[idx[j:j1]]
        out[:, h:] = -2048
        out[:, :h, w:] = -2048
        lung_sel[j:j1] = resize_nearest_np(
            np.ascontiguousarray(lung[idx[j:j1]], dtype=bool).view(np.uint8),
            self.target_size[1:], (1, 2))
        plane = self.up_shape[1] * self.up_shape[2]
        f0, f1 = j * plane, j1 * plane
        b0 = f0 // self.block
        flat = np.zeros((-(-f1 // self.block) - b0) * self.block, bool)
        np.greater(out.reshape(-1), WINDOW_LO,
                   out=flat[f0 - b0 * self.block:f1 - b0 * self.block])
        return b0, flat.reshape(-1, self.block).any(-1)


class _StageClock:
    """Stage boundaries of one batch.  On a card: CUDA events on the
    current stream, read only after the batch's results reached the host
    (timing adds no synchronisation).  On the CPU every op is synchronous
    and host clocks serve.  ``mark()`` ends one stage of ``STAGES`` and
    begins the next (so does any name but ``decoder``: the predict step's
    names); the model's ``mark("decoder")`` splits the forward into
    ``FORWARD_SPLIT``."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks: List[Any] = []
        self._split: Any = None

    def mark(self, name: Optional[str] = None) -> None:
        if self._cuda:
            t = torch.cuda.Event(enable_timing=True)
            t.record()
        else:
            t = time.perf_counter()
        if name == "decoder":
            self._split = t
        else:
            self._marks.append(t)

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds between consecutive marks, named by ``STAGES``,
        and the forward's ``trunk`` and ``decoder`` where the model
        marked the split: together the ``forward`` interval."""
        m = self._marks
        if self._cuda:
            m[-1].synchronize()
        out = dict(zip(STAGES, (self._ms(a, b) for a, b in zip(m, m[1:]))))
        if self._split is not None:
            f = STAGES.index("forward")
            out["trunk"] = self._ms(m[f], self._split)
            out["decoder"] = self._ms(self._split, m[f + 1])
        return out

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self._cuda else 1e3 * (b - a)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        # pinned staging lets the copy run asynchronously on the stream
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def gate_plan(target_size, pad_shape, gated_frac: float = 0.8):
    """The device path's upload plan: ``(up_shape, block, budget)``, the
    depth-preselected upload buffer (target depth, in-plane pad), its gate
    block (``pick_gate_block``) and the stream's capacity in voxels,
    ``gated_frac`` of the buffer's blocks rounded up to 8 blocks (JAX
    ``processor.py:373-379``).  Raises ``ValueError`` when the buffer has
    no gate block, where the JAX package would divide by 0."""
    up_shape = (int(target_size[0]), int(pad_shape[1]), int(pad_shape[2]))
    n_vox = int(np.prod(up_shape))
    block = pick_gate_block(n_vox)
    if block == 0:
        raise ValueError(f"upload buffer {up_shape} ({n_vox} voxels) has no "
                         f"gate block: its voxel count is not a multiple of "
                         f"8 blocks of 64")
    budget = gated_budget([int(n_vox // block * gated_frac)], block=block)
    return up_shape, block, budget


def _predict(model, packed, gate_bits, lung_bits, in_sizes, moments,
             up_shape, block: int, target_size, dtype: torch.dtype,
             clock: _StageClock, crops: Sequence[Shape]) -> Dict[str, Any]:
    """The device program of one batch (``_cached_predict_packed``): the
    gated CT stream and the lung bits unpacked (JAX
    ``processor.py:211-224``), then the preprocess, forward, reduction and
    kernel G's heatmaps, each scan's at its extents in ``crops``."""
    b = packed.shape[0]
    raw = unpack10_gated_device(packed, gate_bits, up_shape, block)
    shifts = torch.arange(8, dtype=torch.uint8, device=lung_bits.device)
    lung = ((lung_bits[..., None] >> shifts) & 1).reshape(b, -1)[
        :, :int(np.prod(target_size))].reshape(b, *target_size)
    pre = fused_preprocess_preselected(raw, lung, in_sizes, moments,
                                       target_size=target_size,
                                       em_threshold=-910.0)
    x = pre["image"][..., None].to(dtype)
    lungs5 = pre["lung_mask"][..., None]
    ess5 = pre["em_mask"][..., None]
    clock.mark()
    dense, _ = spatial.forward_slabs(model, x, lungs5, clock.mark)
    clock.mark()
    maps = torch.cat(dense, -1)
    ess_w = resize_linear_matmul_transpose(ess5, maps.shape[1:4], (1, 2, 3),
                                           align_corners=True)
    # both numerators in one call of kernel F
    num, _ = masked_sums(maps, ess_w)
    lung_sums = torch.sum(lungs5, dim=(1, 2, 3, 4))
    out = {"cle_pct": num[:, 0] / lung_sums, "pse_pct": num[:, 1] / lung_sums}
    clock.mark()
    # the f16 rounding of the half maps stays (the JAX package ships them
    # so), so every heatmap byte is its host postprocess's
    full = upsample_masked(maps.to(torch.float16),
                           ess5[..., 0].to(torch.uint8), target_size)
    out["heat"] = quantised_crops(full, crops)
    clock.mark()
    return out


class _Stage:
    """One host thread that applies ``fn`` to each item submitted, in
    turn, behind a queue of ``maxsize=2``: the bound on the batches in
    flight.  The first error is kept, the items after it are skipped, and
    it re-raises in :meth:`submit` and :meth:`close`.  The processor runs
    two: the completion stage (:func:`_complete`) and the postprocess
    stage (:func:`_batch_post`)."""

    def __init__(self, fn: Callable[[Any], None], name: str):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while (item := self._q.get()) is not None:
            if self._err is None:
                try:
                    self._fn(item)
                except BaseException as e:  # noqa: BLE001 — reraised
                    self._err = e

    def submit(self, item) -> None:
        if self._err is not None:
            raise self._err
        self._q.put(item)

    def close(self) -> None:
        """Return once every item submitted has run and the thread ended."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err


def pool_width() -> int:
    """Threads of each slab pool, the one that deflates the heatmaps and
    the one that prepares the loader's scans: the CPUs this process may
    run on, shared among the ranks of this host (``LOCAL_WORLD_SIZE``, as
    torchrun and ``parallel/mesh.py::spawn_ranks`` set it), less one; at
    least 1, and at 1 there are no pools: the slabs run in turn on the
    postprocess and loader threads.  On an 8-CPU H100 host, deflate pools
    of 4 and 5 threads ran the processor's cohort benchmark 8-10% slower
    than this rule's 7."""
    cpus = len(os.sched_getaffinity(0))
    ranks = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    return max(1, cpus // ranks - 1)


def _slab_map(pool: Optional[ThreadPoolExecutor],
              slab_stats: Dict[str, Any]) -> SlabMap:
    """A slab map on ``pool`` (in turn on the caller without one): each
    slab counted in ``slab_stats["slabs"]`` and its time in the thread
    added to ``slab_stats["work_ms"]``; callers on several threads (the
    loader workers) may share it."""
    lock = threading.Lock()

    def timed(fn, k):
        t0 = time.perf_counter()
        return fn(k), time.perf_counter() - t0

    def slab_map(fn, ks):
        run = functools.partial(timed, fn)
        done = list(pool.map(run, ks) if pool else map(run, ks))
        with lock:
            slab_stats["slabs"] += len(done)
            slab_stats["work_ms"] += 1e3 * sum(t for _, t in done)
        return [out for out, _ in done]
    return slab_map


def _complete(post: _Stage, item) -> None:
    """Completion-stage context: wait for one batch's device-to-host
    copies (enqueued by the dispatch thread right after the batch, into
    pinned memory), read its stage clock, and hand the host arrays to the
    postprocess stage, so batch n+1's device work overlaps batch n's host
    postprocess."""
    res, clock, batch_post = item
    with span("wait.copies"):
        stage_ms = clock.stage_ms()   # waits for the copies
    host = {k: v.numpy() for k, v in res.items()}
    post.submit(functools.partial(batch_post, host=host, stage_ms=stage_ms))


def _heat_plan(batch, owned: Set[str]):
    """Which scans of ``batch`` this rank writes (its own, not an
    oversized dummy, which re-runs on the host path) and the extents of
    the crop kernel G makes for each: its lung crop's, (0, 0, 0) for a
    scan it does not write."""
    over = batch.get("oversized", [False] * len(batch["uid"]))
    keep = [uid in owned and not o for uid, o in zip(batch["uid"], over)]
    crops = [tuple(int(b - a) for a, b in np.asarray(c)) if k else (0, 0, 0)
             for c, k in zip(batch["crop_slice"], keep)]
    return keep, crops


def _batch_post(pending: Set[str], results: List[Dict[str, Any]],
                finalize: Callable[[str, Dict[str, Any]], Dict[str, Any]], *,
                host, stage_ms, batch, keep, crops, stats: Dict[str, Any]):
    """Postprocess-stage context: finalize into ``results`` each scan of
    one batch that this rank writes, with its uint8 crops (kernel G's
    rows); ``pending`` passes each uid once, so a wrap-around repeat is
    dropped before any host work."""
    t0 = time.perf_counter()
    for i, uid in enumerate(batch["uid"]):
        if not keep[i] or uid not in pending:
            continue
        pending.remove(uid)
        n = int(np.prod(crops[i]))
        pct = float(host["cle_pct"][i]), float(host["pse_pct"][i])
        stats["fractions"][uid] = pct
        results.append(finalize(uid, {
            "cle_dense": host["heat"][i, 0, :n].reshape(crops[i]),
            "pse_dense": host["heat"][i, 1, :n].reshape(crops[i]),
            "cle_pct": pct[0], "pse_pct": pct[1],
            "crop_slice": np.asarray(batch["crop_slice"][i]),
            "original_size": np.asarray(batch["original_size"][i]),
        }))
    stats["batches"] += 1
    for k, v in stage_ms.items():
        stats["stage_ms"][k] += v
    stats["stage_ms"]["postprocess"] += 1e3 * (time.perf_counter() - t0)


def _finalize_scan(uid: str, rec: Dict[str, Any], *, dataset,
                   out_cle: Path, out_pse: Path,
                   counters: Optional[Dict[str, float]] = None,
                   slab_map: Optional[SlabMap] = None) -> Dict[str, Any]:
    """Write both uint8 heatmap crops (``rec["cle_dense"]``,
    ``rec["pse_dense"]``) as heatmap MHAs of the original scan geometry,
    zero outside the crop, and return the ``results.json`` entry
    (reference ``processor.py:99-158``).  ``counters``: the
    ``post.quantise`` (the paste plan, the crops as uint8), ``post.zlib``
    (each map's slabs made from its crop and deflated through ``slab_map``)
    and ``post.write`` (header and file) spans add there."""
    with span("post.quantise", counters):
        original_size = tuple(int(s) for s in rec["original_size"])
        # outside the crop windowing(0) == 0, the uint8 background
        paste = tuple(slice(int(a), int(b)) for a, b in rec["crop_slice"])
        # the heatmap files are uint8 whatever the crops hold
        crops = {name: np.asarray(rec[f"{name}_dense"]).astype(
            np.uint8, copy=False) for name in ("cle", "pse")}
    meta = dataset.scan_meta_cache[uid]
    itk_kwargs = dict(
        origin=meta["origin"][::-1],
        direction=np.asarray(meta["direction"]).reshape(3, 3)[
            ::-1].flatten().tolist(),
        spacing=meta["spacing"][::-1])

    metrics = {}
    for name, pct, out in (("cle", rec["cle_pct"], out_cle),
                           ("pse", rec["pse_pct"], out_pse)):
        planes = pasted_planes(crops[name], paste, original_size)
        with span("post.zlib", counters):
            chunks = deflate(planes, original_size, np.uint8, slab_map)
        with span("post.write", counters):
            write_mha_file(out / f"{uid}.mha", chunks, original_size,
                           np.uint8, **itk_kwargs)
        ratio_map = CLE_RATIO_MAP if name == "cle" else PSE_RATIO_MAP
        metrics[f"{name}_severity_score"] = "{:d}".format(
            ratio_to_label(pct, ratio_map))
        metrics[f"{name}_lesion_percentage_per_lung"] = "{:.3f}".format(pct)
    return {"entity": uid, "metrics": metrics, "error_messages": []}


def build_model(model_arch: str = "med3ddram",
                ckp_path: Optional[str] = "best.ckpt",
                seed: int = 0,
                compute_dtype: str = "float32") -> torch.nn.Module:
    """An eval model with the weights of ``ckp_path`` (JAX
    ``processor.py:583-597``): a directory restores the newest
    ``epoch_<n>.pt`` of the port trainer's checkpoints ("train ->
    deploy", ``<model_path>/subtyping_<arch>/checkpoints``); a
    ``.ckpt``/``.pth``/``.pt``/``.npz`` file loads greedily
    (``load_weights_file``; any other suffix raises ``ValueError``); a
    path that does not exist, or none, gives random weights drawn from
    ``seed``, with a warning.  The bfloat16 model has the packed decoder,
    as the JAX processor builds it (processor.py:555-556)."""
    model = get_model_by_name(
        model_arch, generator=torch.Generator().manual_seed(seed),
        packed_decoder=compute_dtype == "bfloat16")
    path = Path(ckp_path) if ckp_path else None
    if path is not None and path.is_dir():
        # is_dir first: CheckpointManager creates a directory it is given
        payload = CheckpointManager(path).restore()
        model.load_state_dict(payload["model"])
        logger.info("restored the checkpoint of epoch %d from %s",
                    payload["epoch"], path)
    elif path is not None and path.exists():
        report = load_weights_file(model, path)
        logger.info("loaded weights from %s: %s", path, report)
    else:
        logger.warning("no checkpoint found at %s — random weights "
                       "(seed %d)", ckp_path, seed)
    return model.eval()


def _device_path(model, dataset: SubtypingInference, make_loader,
                 subset: Sequence[int], fetcher: _Stage, owned: Set[str],
                 target_size, pad_shape, gated_frac: float,
                 dtype: torch.dtype, device: torch.device,
                 stats: Dict[str, Any]) -> List[int]:
    """The scans of ``subset`` through the device program (``_predict``),
    batch by batch, uploaded as the block-gated 10-bit stream
    (:func:`gate_plan`), heatmaps made for the uids of ``owned``; returns
    the dataset indices whose crops exceeded ``pad_shape`` in-plane or
    whose live blocks exceeded the budget, for the host path."""
    up_shape, block, budget = gate_plan(target_size, pad_shape, gated_frac)
    view = _RawPredictView(dataset, up_shape, target_size, budget, block)
    for batch in make_loader(view, subset):
        with span("proc.dispatch"):
            with span("pack_ms", stats):
                packed, gate_bits = pack10_gated_host(
                    batch["image_raw"], batch["gate_blocks"], budget, block)
                lung_bits = np.packbits(
                    batch["lung_raw"].reshape(len(packed), -1), axis=-1,
                    bitorder="little")
            stats["upload_bytes"] += sum(a.nbytes for a in (
                packed, gate_bits, lung_bits, batch["in_sizes"],
                batch["moments"]))
            keep, crops = _heat_plan(batch, owned)
            clock = _StageClock(device)
            clock.mark()
            inputs = [_upload(a, device) for a in (
                packed, gate_bits, lung_bits, batch["in_sizes"],
                batch["moments"])]
            clock.mark()
            res = _predict(model, *inputs, up_shape, block, target_size,
                           dtype, clock, crops)
            _submit(fetcher, res, clock, batch, keep, crops, device, stats)
    return sorted(view.oversized)


def _submit(fetcher: _Stage, res: Dict[str, torch.Tensor],
            clock: _StageClock, batch, keep, crops, device: torch.device,
            stats: Dict[str, Any]) -> None:
    """Enqueue one batch's download now, into pinned host memory, ahead
    of the next batch's work on the stream, and hand it to the completion
    stage; the dispatch thread's time blocked there (the backpressure) is
    ``wait.post``."""
    res = {k: v.to("cpu", non_blocking=True) for k, v in res.items()}
    clock.mark()
    if device.type == "cuda":
        stats["device_heatmaps"] += sum(keep)
    meta = {k: batch[k] for k in ("uid", "crop_slice", "original_size")}
    with span("wait.post", stats["stage_ms"]):
        fetcher.submit((res, clock, functools.partial(
            _batch_post, batch=meta, keep=keep, crops=crops, stats=stats)))


def _host_path(model, loader, fetcher: _Stage, owned: Set[str],
               dtype: torch.dtype, device: torch.device,
               stats: Dict[str, Any]) -> None:
    """The host-preprocessed batches of ``loader`` (over a
    :class:`_PredictView`) through ``make_predict_step``, then kernel G's
    stage 2 for the uids of ``owned``."""
    step = make_predict_step(model, compute_dtype=dtype, device=device)
    for batch in loader:
        with span("proc.dispatch"):
            keep, crops = _heat_plan(batch, owned)
            clock = _StageClock(device)
            clock.mark()
            images = _upload(batch["image"], device)
            lungs = _upload(batch["lung_mask"], device)
            ess = _upload(batch["ess_mask"], device)
            clock.mark()
            # marks as the forward and the reduction begin, between the
            # trunk and the decoder, and when both end; no preprocess runs
            # on the device here
            out = step(images, lungs, ess, mark=clock.mark)
            maps = torch.stack([out["cle_dense_outs"],
                                out["pse_dense_outs"]], -1)
            res = {"heat": quantised_crops(maps, crops),
                   "cle_pct": out["cle_precentages"],
                   "pse_pct": out["pse_precentages"]}
            clock.mark()
            _submit(fetcher, res, clock, batch, keep, crops, device, stats)


def run_inference(scan_path: str, lobe_path: str, output_path: str,
                  model_arch: str = "med3ddram",
                  ckp_path: Optional[str] = "best.ckpt",
                  target_size=(128, 224, 288), batch_size: int = 2,
                  workers: int = 2, compute_dtype: str = "float32",
                  device_preprocess: bool = True,
                  pad_shape=(160, 288, 384), gated_frac: float = 0.8,
                  model: Optional[torch.nn.Module] = None,
                  device=None, seed: int = 0,
                  stats: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """Run the deployment pipeline over every scan; returns the results.

    ``device_preprocess=True`` (the default): the device path; scans whose
    lung crop exceeds ``pad_shape`` in-plane, or whose live CT blocks
    exceed the gated stream's budget (``gated_frac`` of the upload
    buffer's blocks), then run the host path one by one (batched among
    themselves).  ``False``: every scan on the
    host-preprocess path, the strict reference-parity path.
    ``model``: an eval port model to use as is (``model_arch``,
    ``ckp_path`` and ``seed`` then go unused); otherwise one is built by
    :func:`build_model`.  ``device``: default ``cuda``; without a card pass
    ``cpu`` (every kernel site then runs its plain version), else this
    raises.  ``compute_dtype``: ``float32`` (the clinical default) or
    ``bfloat16``.  ``stats``: if given, filled with ``batches`` (device and
    host path), ``scans``, ``host_scans`` (the uids that ran the host path,
    in cohort order), ``fractions`` (each uid's unrounded CLE and PSE
    lesion fractions), ``upload_bytes`` (bytes the device path uploaded,
    every batch's stream, gate bits, lung bits, extents and moments),
    ``pack_ms`` (host-clock ms of the dispatch thread's packing, summed
    over the device-path batches), ``device_heatmaps`` (the scans whose
    uint8 crops kernel G made on a card; 0 on the CPU, where its plain
    version runs), ``zlib`` (the heatmap writer's ``threads``: the slab
    pool's width, :func:`pool_width`; ``slabs``: the slabs it
    deflated; ``work_ms``: their summed time in the pool's threads, so
    ``work_ms / stage_ms["post.zlib"]`` is the parallelism it reached),
    ``prepare`` (the same of the loader's prepare pool: its slabs of lobe
    maps and crops and its chunks of selected planes, so ``work_ms /
    stage_ms["io.prepare"]`` is the parallelism the prepare reached),
    the summed per-stage milliseconds ``stage_ms`` and
    ``pipeline_s``, the wall time from the first loader read to the last
    file written.  ``STAGES`` are intervals of the device timeline (on a
    card: from the batch's first event, which may wait behind the previous
    batch, through host pinning and the copies to the device, then each
    device stage, ``heatmap`` kernel G's, then the copies back; the host
    path has no device preprocess); ``FORWARD_SPLIT`` splits ``forward``
    where the model marks its decoder's start: ``trunk`` (the stem through
    layer4) and ``decoder`` (us1, us2, us3 and the heads) sum to it;
    ``postprocess`` is host time of the postprocess thread.
    ``COUNTERS`` are the host-clock ms of the ``utils/spans.py`` spans of
    the same names, summed over the threads: ``wait.loader`` and
    ``wait.post``, the dispatch thread blocked on the loader and on the
    postprocess (its backpressure and the final joins); ``io.read`` and
    ``io.prepare``, the loader workers' MHA reads and the rest of each
    item; ``post.quantise`` (the paste plan, the crops as uint8),
    ``post.zlib`` (a map's slabs made from its crop and deflated on the
    slab pool, wall time) and ``post.write`` (header and file), parts of
    ``postprocess`` (``post.upsample`` and ``post.uncrop`` read 0: kernel
    G does that work).  Under a running ``torch.profiler`` the dispatch
    thread's spans ``proc.setup``, ``proc.dispatch`` (one batch) and
    ``proc.results`` and the completion thread's ``wait.copies`` appear
    too.

    Data parallelism (JAX ``nchips``/``mesh``, ``processor.py:605-676``): in a
    process group of W ranks (``parallel/mesh.py::init_distributed``, as the
    CLI's ``--ngpus``/``--mesh data=N``/``--multihost`` set it up) rank r takes
    ``shard_indices`` of the sorted scan list (padded by wrap-around to a
    multiple of W, positions r::W) and finalizes only the scans it was dealt
    that are not that padding, so every scan's heatmaps are written once; its
    own oversized scans fall back to the host path on that rank.  After every
    rank's postprocess has ended the results are gathered: every rank returns
    them merged (one per uid, in glob order) and rank 0 alone writes the three
    JSONs.  Each rank builds the model the same way (no weights are broadcast),
    so ranks may share a card over gloo.  On a mesh with a spatial axis
    (``--mesh data=D,spatial=S``) the ranks of a spatial group take data index
    d's shard (``shard_indices`` over D), each unpacks and preprocesses the
    whole batch and runs the forward on its H slab; the dense maps are gathered
    to every rank of the group, and its first rank alone postprocesses and
    writes the files.  On a model axis each rank runs its channel slice of the
    weights (``parallel/tensor.py``, JAX ``processor.py:599-603``) and its
    group scores the same scans.  ``stats`` then holds this rank's counts
    (``scans``: the scans it owns, ``finalized``: the uids it wrote, ``rank``,
    ``world``, ``launches``: the CUDA kernel launches of this run), and
    ``ranks``: every rank's ``rank``, ``pipeline_s``, ``scans``, ``batches``,
    ``host_scans``, ``finalized``, ``fractions`` and ``launches``, in rank
    order (one entry in a world of one)."""
    if stats is None:
        stats = {}
    stage_ms = {k: 0.0 for k in (*STAGES, *FORWARD_SPLIT, "postprocess",
                                 *COUNTERS)}
    with span("proc.setup"):
        device = entry_device(device)
        world, this_rank = world_size(), rank()
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[compute_dtype]
        target_size = tuple(int(s) for s in target_size)
        out_root = Path(output_path)
        out_cle = out_root / "images" / "centrilobular-emphysema-heatmap"
        out_pse = out_root / "images" / "paraseptal-emphysema-heatmap"
        out_cle.mkdir(parents=True, exist_ok=True)
        out_pse.mkdir(parents=True, exist_ok=True)

        # the device path thresholds the ess mask on the device (its host
        # fallback, _PredictView, on the int16 crop); the host path keeps
        # the dataset's native-dtype threshold (reference dataset.py:79)
        dataset = SubtypingInference(scan_path, lobe_path,
                                     keep_original=False,
                                     compute_ess=not device_preprocess,
                                     counters=stage_ms)
        if len(dataset) == 0:
            raise FileNotFoundError(f"no .mha scans under {scan_path}")
        n_vox_u = target_size[0] * int(pad_shape[1]) * int(pad_shape[2])
        if device_preprocess and (int(np.prod(target_size)) % 8
                                  or n_vox_u % 8
                                  or pick_gate_block(n_vox_u) == 0):
            # JAX processor.py:616-631: the bit-packing needs
            # prod(target_size) % 8 == 0, the gated transport a gate block
            logger.warning(
                "target_size %s / pad_shape %s break the device path's "
                "packing (prod(target_size) %% 8 == 0, a gate block for the "
                "upload buffer) — using host preprocessing instead",
                target_size, tuple(pad_shape))
            device_preprocess = False
        if model is None:
            model = build_model(model_arch, ckp_path, seed, compute_dtype)
        elif tensor.size() > 1:
            model = copy.deepcopy(model)     # sliced below, not the caller's
        # on a model axis, this rank's channel slice (JAX
        # processor.py:599-603)
        model = tensor.shard_model(model.to(device).eval())

        def uid(i: int) -> str:
            return Path(dataset.scan_files[i]).stem

        dealt, padding = shard_indices(range(len(dataset)), mesh().data,
                                       coords()[0], shuffle=False,
                                       return_padding=True)
        mine = [int(i) for i in dealt]
        # the data index's scans; its spatial group's first rank writes them
        ours = {int(i) for i, pad in zip(dealt, padding) if not pad}
        owned = ours if is_leader() else set()

        def make_loader(view, subset: Sequence[int]) -> DataLoader:
            indices = list(subset)
            if len(indices) % batch_size:
                # wrap around so every batch is full; duplicates drop by uid
                total = -(-len(indices) // batch_size) * batch_size
                indices = list(np.resize(np.asarray(indices), total))
            return DataLoader(view, indices=indices, batch_size=batch_size,
                              num_workers=workers, counters=stage_ms)

        width = pool_width()
        stats.update(batches=0, scans=len(owned), host_scans=[],
                     fractions={}, upload_bytes=0, pack_ms=0.0,
                     device_heatmaps=0, stage_ms=stage_ms,
                     **{k: {"threads": width, "slabs": 0, "work_ms": 0.0}
                        for k in ("zlib", "prepare")})

        launched = cuda_build.launches()
        t0 = time.perf_counter()
        owned_uids = {uid(i) for i in owned}

    def close(stage: _Stage):
        with span("wait.post", stage_ms):
            stage.close()

    # the run's host threads, ended in turn on the way out, an error or
    # not: the completion stage, the postprocess stage, the slab pools.
    # The loader's prepare has a pool of its own: the deflate pool is
    # FIFO, and a batch's deflate slabs would queue the loader behind them
    with contextlib.ExitStack() as threads:
        pools = {k: threads.enter_context(ThreadPoolExecutor(
            width, thread_name_prefix=f"proc-{k}")) if width > 1 else None
            for k in ("deflate", "prepare")}
        dataset.slab_map = _slab_map(pools["prepare"], stats["prepare"])
        finalize = functools.partial(
            _finalize_scan, dataset=dataset, out_cle=out_cle,
            out_pse=out_pse, counters=stage_ms,
            slab_map=_slab_map(pools["deflate"], stats["zlib"]))
        pending, results = set(owned_uids), []
        post = _Stage(lambda batch_post: batch_post(pending, results,
                                                    finalize), "proc-post")
        threads.callback(close, post)
        fetcher = _Stage(functools.partial(_complete, post), "proc-complete")
        threads.callback(close, fetcher)
        with torch.inference_mode():
            host_subset = mine
            if device_preprocess:
                # an oversized scan falls back on its owner alone
                host_subset = [i for i in _device_path(
                    model, dataset, make_loader, mine, fetcher, owned_uids,
                    target_size, pad_shape, gated_frac, dtype, device,
                    stats) if i in ours]
            if host_subset:
                stats["host_scans"] = [uid(i) for i in host_subset
                                       if i in ours]
                _host_path(model, make_loader(
                    _PredictView(dataset, target_size), host_subset),
                    fetcher, owned_uids, dtype, device, stats)
    stats["pipeline_s"] = time.perf_counter() - t0
    stats.update(rank=this_rank, world=world,
                 finalized=[r["entity"] for r in results],
                 launches={k: v - launched[k]
                           for k, v in cuda_build.launches().items()})
    with span("proc.results"):
        return _gather_results(
            results, stats, [uid(i) for i in range(len(dataset))], out_root)


def _gather_results(results: List[Dict[str, Any]], stats: Dict[str, Any],
                    uids: Sequence[str], out_root: Path
                    ) -> List[Dict[str, Any]]:
    """Every rank's files are written: gather the results, one per uid, in
    the dataset (glob) order ``uids`` (the host-path scans were emitted
    after the device-path cohort, so results[0] stays the first scan);
    rank 0 writes the three JSONs."""
    parts = gather_objects((results, {k: stats[k] for k in (
        "rank", "pipeline_s", "scans", "batches", "host_scans", "finalized",
        "fractions", "launches")}))
    stats["ranks"] = [part for _, part in parts]
    merged = {}
    for part, _ in parts:
        for r in part:
            merged.setdefault(r["entity"], r)
    order = {u: i for i, u in enumerate(uids)}
    results = sorted(merged.values(),
                     key=lambda r: order.get(r["entity"], len(order)))
    if stats["rank"] != 0:
        return results
    first = results[0]["metrics"]
    for name, fname in (("cle", "centrilobular-emphysema-score.json"),
                        ("pse", "araseptal-emphysema-score.json")):
        # "araseptal": the reference's typo'd filename, part of the contract
        with open(out_root / fname, "w") as f:
            f.write(json.dumps({
                "score": int(float(first[f"{name}_severity_score"])),
                "percentage": float(
                    first[f"{name}_lesion_percentage_per_lung"])}))
    with open(out_root / "results.json", "w") as f:
        f.write(json.dumps(results))
    return results
