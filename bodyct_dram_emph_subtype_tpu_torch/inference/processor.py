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

1. loader threads read, dilate, mask and crop each scan, take the exact
   linspace depth planes of the CT into an in-plane padded int16 buffer,
   compute its block gate (the ``block``-voxel flat blocks holding a voxel
   above the HU window floor), nearest-select the lung to the model size
   and compute the exact standardize moments (``_RawPredictView``);
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
   (``_cached_predict_packed``, processor.py:232-242), f16 half maps and
   the bit-packed ess mask;
5. download: the results are copied to pinned host memory right behind
   the batch on the stream; a completion thread waits for them and a
   postprocess thread upsamples, un-crops and writes (``_FetchStage``,
   ``_PostprocessPipeline``), overlapping the next batch's device work.

The host-preprocess path (``device_preprocess=False``, the CLI's
``--host_preprocess``: the strict reference-parity path) runs
``data/host_preprocess.py::preprocess_sample`` in the loader threads
(window, standardize, resize, with the dataset's native-dtype -910 HU ess
mask), uploads the float32 model inputs, and runs
``train/steps.py::make_predict_step``: the eval forward, both maps
upsampled to the model size and masked, the two numerators in one call of
kernel F.  A scan whose lung crop exceeds ``pad_shape`` in-plane does not
stop the cohort: the device path records it, warns naming it and emits a
dummy that is skipped on output, and afterwards just those scans run the
host path (``stats["host_scans"]``); so does a scan whose live blocks
exceed the stream's budget.  A ``target_size`` whose voxel count breaks
the bit-packing, or a ``pad_shape`` whose upload buffer has no gate block
(``pick_gate_block`` returns 0), sends the whole run to the host path with
a warning.  Results keep the cohort (glob) order.

In a process group of W ranks each rank runs this pipeline over its
shard of the scans and writes their heatmaps; the results are gathered
and rank 0 writes the JSONs (``run_inference``).
"""
from __future__ import annotations

import functools
import json
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..data.datasets import (CLE_RATIO_MAP, PSE_RATIO_MAP, SubtypingInference,
                             ratio_to_label)
from ..data.host_preprocess import (depth_indices_np, preprocess_sample,
                                    resize_linear_matmul_np,
                                    resize_nearest_np, window_moments_np)
from ..data.loader import DataLoader
from ..data.mha import write_arrays_to_mha
from ..data.samplers import shard_indices
from ..models.registry import get_model_by_name
from ..models.torch_import import load_weights_file
from ..ops import cuda_build
from ..ops.packing import (WINDOW_LO, gate_blocks_np, gated_budget,
                           pack10_gated_host, pick_gate_block,
                           unpack10_gated_device)
from ..ops.pallas_kernels import masked_sums
from ..ops.preprocess import fused_preprocess_preselected
from ..ops.resize import resize_linear_matmul_transpose
from ..parallel.mesh import gather_objects, rank, world_size
from ..train.checkpoint import CheckpointManager
from ..train.steps import make_predict_step
from ..utils.device import entry_device
from ..utils.viz import windowing

logger = logging.getLogger(__name__)

STAGES = ("upload", "preprocess", "forward", "reduction", "download")


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
        sample.pop("original_image", None)
        if "ess_mask" not in sample:
            # the lean (compute_ess=False) dataset of the device path leaves
            # the -910 HU mask to its consumer: thresholded here on the
            # int16 crop, as the JAX package does (processor.py:67-72)
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
    moments from exact integer sums.

    A scan whose lung crop exceeds ``up_shape`` in-plane, or whose live
    blocks exceed ``budget`` voxels, does not abort the cohort: its index
    goes into :attr:`oversized` (the loader workers are threads, so the
    caller sees it), a warning names the scan, and a dummy zero-lung item
    marked ``oversized`` takes its place; the caller skips the dummy on
    output and re-runs those scans on the host path (JAX
    ``processor.py:76-164``)."""

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

    def __getitem__(self, index):
        d = self.dataset[index]
        img = np.asarray(d["image"])         # int16 crop
        if any(s > p for s, p in zip(img.shape[1:], self.up_shape[1:])):
            return self._dummy(index, d, f"crop {img.shape} exceeds "
                               f"in-plane pad {self.up_shape[1:]}")
        idx = depth_indices_np(img.shape[0], self.up_shape[0])
        img_p = np.full(self.up_shape, -2048, np.int16)
        img_p[:, :img.shape[1], :img.shape[2]] = img[idx]
        gate = gate_blocks_np((img_p > WINDOW_LO).reshape(1, -1),
                              self.block)[0]
        if int(np.count_nonzero(gate)) * self.block > self.budget:
            return self._dummy(index, d, f"gated voxel count exceeds budget "
                               f"{self.budget}")
        lung_sel = resize_nearest_np(
            np.ascontiguousarray(np.asarray(d["lung_mask"])[idx],
                                 dtype=bool).view(np.uint8),
            self.target_size[1:], (1, 2))
        return {"image_raw": img_p, "gate_blocks": gate, "lung_raw": lung_sel,
                "in_sizes": np.asarray(
                    (self.up_shape[0], img.shape[1], img.shape[2]), np.int32),
                "moments": window_moments_np(img),
                "uid": d["uid"], "crop_slice": d["crop_slice"],
                "original_size": d["original_size"], "oversized": False}


class _StageClock:
    """Stage boundaries of one batch.  On a card: CUDA events on the
    current stream, read only after the batch's results reached the host
    (timing adds no synchronisation).  On the CPU every op is synchronous
    and host clocks serve."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks: List[Any] = []

    def mark(self) -> None:
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds between consecutive marks, named by ``STAGES``."""
        m = self._marks
        if self._cuda:
            m[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        else:
            ms = [1e3 * (b - a) for a, b in zip(m, m[1:])]
        return dict(zip(STAGES, ms))


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
             clock: _StageClock) -> Dict[str, Any]:
    """The device program of one batch (``_cached_predict_packed``): the
    gated CT stream and the lung bits unpacked (JAX
    ``processor.py:211-224``), then the preprocess, forward and
    reduction."""
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
    dense, _ = model(x, lungs5)
    clock.mark()
    half = dense[0].shape[1:4]
    ess_w = resize_linear_matmul_transpose(ess5, half, (1, 2, 3),
                                           align_corners=True)
    # both numerators in one call of kernel F
    num, _ = masked_sums(torch.cat(dense, -1), ess_w)
    lung_sums = torch.sum(lungs5, dim=(1, 2, 3, 4))
    weights = 2 ** torch.arange(8, device=raw.device)
    ess_bits = (ess5[..., 0].to(torch.uint8).reshape(b, -1, 8) * weights
                ).sum(-1).to(torch.uint8)
    out = {
        # f16 halves the download; its 2^-11 relative error sits ~8x
        # below one uint8 heatmap count (percentages stay f32)
        "cle_half": dense[0][..., 0].to(torch.float16),
        "pse_half": dense[1][..., 0].to(torch.float16),
        "ess_bits": ess_bits,
        "cle_pct": num[:, 0] / lung_sums,
        "pse_pct": num[:, 1] / lung_sums,
    }
    clock.mark()
    return out


class _PostprocessPipeline:
    """Single consumer thread for the host postprocess (half->full
    upsample, un-crop, MHA/JSON writes), overlapping the next batch's
    device work.  Errors re-raise in :meth:`submit` / :meth:`close`.
    ``owned``: the uids this rank finalizes."""

    def __init__(self, finalize: Callable[[str, Dict[str, Any]],
                                          Dict[str, Any]],
                 owned: Set[str]):
        self._finalize = finalize
        self._owned = owned
        self._seen = set()
        self.results: List[Dict[str, Any]] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            thunk = self._q.get()
            if thunk is None:
                return
            if self._err is None:
                try:
                    thunk(self)
                except BaseException as e:  # noqa: BLE001 — reraised in close
                    self._err = e

    def claim(self, uid: str) -> bool:
        """Worker-thread context: True the first time ``uid`` is seen, so
        wrap-around duplicates are dropped before any host work; False for
        a uid that another rank finalizes."""
        if uid in self._seen or uid not in self._owned:
            return False
        self._seen.add(uid)
        return True

    def emit(self, uid: str, rec: Dict[str, Any]):
        """Worker-thread context: finalize one scan."""
        self.results.append(self._finalize(uid, rec))

    def submit(self, thunk: Callable[["_PostprocessPipeline"], None]):
        if self._err is not None:
            raise self._err
        self._q.put(thunk)

    def close(self) -> List[Dict[str, Any]]:
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self.results


class _FetchStage:
    """Completion thread between dispatch and postprocess: waits for a
    batch's device-to-host copies (enqueued by the dispatch loop right
    after the batch, into pinned memory), reads its stage clock, and hands
    host arrays to the postprocess pipeline, so batch n+1's device work
    overlaps batch n's host postprocess.  ``maxsize=2`` bounds the batches
    in flight."""

    def __init__(self, pipeline: _PostprocessPipeline):
        self._pipeline = pipeline
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue
            try:
                res, clock, post = item
                stage_ms = clock.stage_ms()       # waits for the copies
                host = {k: v.numpy() for k, v in res.items()}
                self._pipeline.submit(functools.partial(
                    post, host=host, stage_ms=stage_ms))
            except BaseException as e:  # noqa: BLE001 — reraised in close
                self._err = e

    def submit(self, res, clock: _StageClock, post):
        if self._err is not None:
            raise self._err
        self._q.put((res, clock, post))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err


def _emit(pipe: _PostprocessPipeline, uid: str, i: int, batch, stats,
          cle_dense: np.ndarray, pse_dense: np.ndarray, cle_pct: float,
          pse_pct: float) -> None:
    stats["fractions"][uid] = (cle_pct, pse_pct)
    pipe.emit(uid, {
        "cle_dense": cle_dense, "pse_dense": pse_dense,
        "cle_pct": cle_pct, "pse_pct": pse_pct,
        "crop_slice": np.asarray(batch["crop_slice"][i]),
        "original_size": np.asarray(batch["original_size"][i]),
    })


def _record(stats: Dict[str, Any], stage_ms: Dict[str, float],
            t0: float) -> None:
    stats["batches"] += 1
    for k, v in stage_ms.items():
        stats["stage_ms"][k] += v
    stats["stage_ms"]["postprocess"] += 1e3 * (time.perf_counter() - t0)


def _device_batch_post(pipe: _PostprocessPipeline, *, host, stage_ms, batch,
                       target_size, n_vox_t, stats: Dict[str, Any]):
    """Postprocess-thread context: unpack one device-path batch, emit each
    scan but the oversized dummies."""
    t0 = time.perf_counter()
    for i, uid in enumerate(batch["uid"]):
        if batch["oversized"][i] or not pipe.claim(uid):
            continue       # a dummy (re-run on the host path) or a repeat
        ess = np.unpackbits(host["ess_bits"][i], bitorder="little")
        ess = ess[:n_vox_t].reshape(target_size)
        maps = []
        for name in ("cle", "pse"):
            # the same linear upsample the device reduction used, with
            # host float64-derived taps (f16 transfer widened back)
            up = resize_linear_matmul_np(
                host[f"{name}_half"][i].astype(np.float32), target_size,
                (0, 1, 2), align_corners=True)
            up[ess == 0] = 0.0
            maps.append(up)
        _emit(pipe, uid, i, batch, stats, *maps, float(host["cle_pct"][i]),
              float(host["pse_pct"][i]))
    _record(stats, stage_ms, t0)


def _host_batch_post(pipe: _PostprocessPipeline, *, host, stage_ms, batch,
                     stats: Dict[str, Any]):
    """Postprocess-thread context: emit each scan of one host-path batch
    (its maps are already at the model size and masked)."""
    t0 = time.perf_counter()
    for i, uid in enumerate(batch["uid"]):
        if pipe.claim(uid):
            _emit(pipe, uid, i, batch, stats, host["cle_dense_outs"][i],
                  host["pse_dense_outs"][i],
                  float(host["cle_precentages"][i]),
                  float(host["pse_precentages"][i]))
    _record(stats, stage_ms, t0)


def _finalize_scan(uid: str, rec: Dict[str, Any], *, dataset,
                   out_cle: Path, out_pse: Path) -> Dict[str, Any]:
    """Un-crop both dRAMs into the original scan geometry, write the uint8
    heatmap MHAs, and return the ``results.json`` entry (reference
    ``processor.py:99-158``)."""
    crop = rec["crop_slice"]
    original_size = tuple(int(s) for s in rec["original_size"])
    recon_size = tuple(int(b - a) for a, b in crop)
    paste = tuple(slice(int(a), int(b)) for a, b in crop)

    metrics = {}
    full_maps = {}
    for name, dense, pct in (("cle", rec["cle_dense"], rec["cle_pct"]),
                             ("pse", rec["pse_dense"], rec["pse_pct"])):
        up = resize_linear_matmul_np(dense, recon_size, (0, 1, 2),
                                     align_corners=True)
        # quantize the CROP, then paste into a uint8 canvas: outside the
        # crop windowing(0) == 0, the uint8 background
        full = np.zeros(original_size, np.uint8)
        full[paste] = windowing(up, from_span=(0, 1)).astype(np.uint8)
        full_maps[name] = full
        ratio_map = CLE_RATIO_MAP if name == "cle" else PSE_RATIO_MAP
        metrics[f"{name}_severity_score"] = "{:d}".format(
            ratio_to_label(pct, ratio_map))
        metrics[f"{name}_lesion_percentage_per_lung"] = "{:.3f}".format(pct)

    meta = dataset.scan_meta_cache[uid]
    itk_kwargs = dict(
        origin=meta["origin"][::-1],
        direction=np.asarray(meta["direction"]).reshape(3, 3)[
            ::-1].flatten().tolist(),
        spacing=meta["spacing"][::-1])
    write_arrays_to_mha(out_cle, [full_maps["cle"]], [uid],
                        dtype=np.uint8, **itk_kwargs)
    write_arrays_to_mha(out_pse, [full_maps["pse"]], [uid],
                        dtype=np.uint8, **itk_kwargs)
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
                 subset: Sequence[int], fetcher: _FetchStage, target_size,
                 pad_shape, gated_frac: float, dtype: torch.dtype,
                 device: torch.device, stats: Dict[str, Any]) -> List[int]:
    """The scans of ``subset`` through the device program (``_predict``),
    batch by batch, uploaded as the block-gated 10-bit stream
    (:func:`gate_plan`); returns the dataset indices whose crops exceeded
    ``pad_shape`` in-plane or whose live blocks exceeded the budget, for
    the host path."""
    n_vox_t = int(np.prod(target_size))
    up_shape, block, budget = gate_plan(target_size, pad_shape, gated_frac)
    view = _RawPredictView(dataset, up_shape, target_size, budget, block)
    for batch in make_loader(view, subset):
        t0 = time.perf_counter()
        packed, gate_bits = pack10_gated_host(
            batch["image_raw"], batch["gate_blocks"], budget, block)
        lung_bits = np.packbits(batch["lung_raw"].reshape(len(packed), -1),
                                axis=-1, bitorder="little")
        stats["pack_ms"] += 1e3 * (time.perf_counter() - t0)
        stats["upload_bytes"] += sum(a.nbytes for a in (
            packed, gate_bits, lung_bits, batch["in_sizes"],
            batch["moments"]))
        clock = _StageClock(device)
        clock.mark()
        inputs = [_upload(a, device) for a in (
            packed, gate_bits, lung_bits, batch["in_sizes"],
            batch["moments"])]
        clock.mark()
        res = _predict(model, *inputs, up_shape, block, target_size, dtype,
                       clock)
        # enqueue the download now, into pinned host memory, ahead of the
        # next batch's work on the stream
        res = {k: v.to("cpu", non_blocking=True) for k, v in res.items()}
        clock.mark()
        meta = {k: batch[k] for k in ("uid", "crop_slice", "original_size",
                                      "oversized")}
        fetcher.submit(res, clock, functools.partial(
            _device_batch_post, batch=meta, target_size=target_size,
            n_vox_t=n_vox_t, stats=stats))
    return sorted(view.oversized)


def _host_path(model, loader, fetcher: _FetchStage, dtype: torch.dtype,
               device: torch.device, stats: Dict[str, Any]) -> None:
    """The host-preprocessed batches of ``loader`` (over a
    :class:`_PredictView`) through ``make_predict_step``."""
    step = make_predict_step(model, compute_dtype=dtype, device=device)
    for batch in loader:
        clock = _StageClock(device)
        clock.mark()
        images = _upload(batch["image"], device)
        lungs = _upload(batch["lung_mask"], device)
        ess = _upload(batch["ess_mask"], device)
        clock.mark()
        # marks as the forward and the reduction begin and when both end;
        # no preprocess runs on the device here
        res = step(images, lungs, ess, mark=lambda name: clock.mark())
        res = {k: v.to("cpu", non_blocking=True) for k, v in res.items()}
        clock.mark()
        meta = {k: batch[k] for k in ("uid", "crop_slice", "original_size")}
        fetcher.submit(res, clock, functools.partial(
            _host_batch_post, batch=meta, stats=stats))


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
    every batch's stream, gate bits, lung bits, extents and moments) and
    ``pack_ms`` (host-clock ms of the dispatch thread's packing, summed
    over the device-path batches), the summed per-stage milliseconds
    ``stage_ms`` and
    ``pipeline_s``, the wall time from the first loader read to the last
    file written.  ``STAGES`` are intervals of the device timeline (on a
    card: from the batch's first event, which may wait behind the previous
    batch, through host pinning and the copies to the device, then each
    device stage, then the copies back; the host path has no device
    preprocess); ``postprocess`` is host time of the postprocess thread.

    Data parallelism (JAX ``nchips``/``mesh``, ``processor.py:605-676``):
    in a process group of W ranks (``parallel/mesh.py::init_distributed``,
    as the CLI's ``--ngpus``/``--mesh data=N``/``--multihost`` set it up)
    rank r takes ``shard_indices`` of the sorted scan list (padded by
    wrap-around to a multiple of W, positions r::W) and finalizes only the
    scans it was dealt that are not that padding, so every scan's heatmaps
    are written once; its own oversized scans fall back to the host path
    on that rank.  After every rank's postprocess has ended the results
    are gathered: every rank returns them merged (one per uid, in glob
    order) and rank 0 alone writes the three JSONs.  Each rank builds the
    model the same way (no weights are broadcast), so ranks may share a
    card over gloo.  ``stats`` then holds this rank's counts (``scans``:
    the scans it owns, ``finalized``: the uids it wrote, ``rank``,
    ``world``, ``launches``: the CUDA kernel launches of this run), and
    ``ranks``: every rank's ``rank``, ``pipeline_s``, ``scans``,
    ``batches``, ``host_scans``, ``finalized``, ``fractions`` and
    ``launches``, in rank order (one entry in a world of one)."""
    device = entry_device(device)
    world, this_rank = world_size(), rank()
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[compute_dtype]
    target_size = tuple(int(s) for s in target_size)
    out_root = Path(output_path)
    cle_json = out_root / "centrilobular-emphysema-score.json"
    pse_json = out_root / "araseptal-emphysema-score.json"  # contract typo
    results_json = out_root / "results.json"
    out_cle = out_root / "images" / "centrilobular-emphysema-heatmap"
    out_pse = out_root / "images" / "paraseptal-emphysema-heatmap"
    out_cle.mkdir(parents=True, exist_ok=True)
    out_pse.mkdir(parents=True, exist_ok=True)

    # the device path thresholds the ess mask on the device (its host
    # fallback, _PredictView, on the int16 crop); the host path keeps the
    # dataset's native-dtype threshold (reference dataset.py:79)
    dataset = SubtypingInference(scan_path, lobe_path, keep_original=False,
                                 compute_ess=not device_preprocess)
    if len(dataset) == 0:
        raise FileNotFoundError(f"no .mha scans under {scan_path}")
    n_vox_u = target_size[0] * int(pad_shape[1]) * int(pad_shape[2])
    if device_preprocess and (int(np.prod(target_size)) % 8 or n_vox_u % 8
                              or pick_gate_block(n_vox_u) == 0):
        # JAX processor.py:616-631: the bit-packing needs
        # prod(target_size) % 8 == 0, the gated transport a gate block
        logger.warning(
            "target_size %s / pad_shape %s break the device path's packing "
            "(prod(target_size) %% 8 == 0, a gate block for the upload "
            "buffer) — using host preprocessing instead", target_size,
            tuple(pad_shape))
        device_preprocess = False
    if model is None:
        model = build_model(model_arch, ckp_path, seed, compute_dtype)
    model = model.to(device).eval()

    def uid(i: int) -> str:
        return Path(dataset.scan_files[i]).stem

    dealt, padding = shard_indices(range(len(dataset)), world, this_rank,
                                   shuffle=False, return_padding=True)
    mine = [int(i) for i in dealt]
    owned = {int(i) for i, pad in zip(dealt, padding) if not pad}

    def make_loader(view, subset: Sequence[int]) -> DataLoader:
        indices = list(subset)
        if len(indices) % batch_size:
            # wrap around so every batch is full; duplicates drop by uid
            total = -(-len(indices) // batch_size) * batch_size
            indices = list(np.resize(np.asarray(indices), total))
        return DataLoader(view, indices=indices, batch_size=batch_size,
                          num_workers=workers)

    if stats is None:
        stats = {}
    stats.update(batches=0, scans=len(owned), host_scans=[], fractions={},
                 upload_bytes=0, pack_ms=0.0,
                 stage_ms={k: 0.0 for k in (*STAGES, "postprocess")})

    launched = cuda_build.launches()
    t0 = time.perf_counter()
    pipeline = _PostprocessPipeline(functools.partial(
        _finalize_scan, dataset=dataset, out_cle=out_cle, out_pse=out_pse),
        owned={uid(i) for i in owned})
    try:
        fetcher = _FetchStage(pipeline)
        try:
            with torch.inference_mode():
                host_subset = mine
                if device_preprocess:
                    # an oversized scan falls back on its owner alone
                    host_subset = [i for i in _device_path(
                        model, dataset, make_loader, mine, fetcher,
                        target_size, pad_shape, gated_frac, dtype, device,
                        stats) if i in owned]
                if host_subset:
                    stats["host_scans"] = [uid(i) for i in host_subset
                                           if i in owned]
                    _host_path(model, make_loader(
                        _PredictView(dataset, target_size), host_subset),
                        fetcher, dtype, device, stats)
        finally:
            fetcher.close()
    finally:
        results = pipeline.close()
    stats["pipeline_s"] = time.perf_counter() - t0
    stats.update(rank=this_rank, world=world,
                 finalized=[r["entity"] for r in results],
                 launches={k: v - launched[k]
                           for k, v in cuda_build.launches().items()})

    # every rank's files are written: gather the results, one per uid, and
    # restore the dataset (glob) order (the host-path scans were emitted
    # after the device-path cohort) so results[0] stays the first scan
    parts = gather_objects((results, {k: stats[k] for k in (
        "rank", "pipeline_s", "scans", "batches", "host_scans", "finalized",
        "fractions", "launches")}))
    stats["ranks"] = [part for _, part in parts]
    merged = {}
    for part, _ in parts:
        for r in part:
            merged.setdefault(r["entity"], r)
    order = {uid(i): i for i in range(len(dataset))}
    results = sorted(merged.values(),
                     key=lambda r: order.get(r["entity"], len(order)))
    if this_rank != 0:
        return results
    with open(cle_json, "w") as f:
        f.write(json.dumps({
            "score": int(float(results[0]["metrics"]["cle_severity_score"])),
            "percentage": float(
                results[0]["metrics"]["cle_lesion_percentage_per_lung"])}))
    with open(pse_json, "w") as f:
        f.write(json.dumps({
            "score": int(float(results[0]["metrics"]["pse_severity_score"])),
            "percentage": float(
                results[0]["metrics"]["pse_lesion_percentage_per_lung"])}))
    with open(results_json, "w") as f:
        f.write(json.dumps(results))
    return results
