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
   nearest-select the lung to the model size and compute the exact
   standardize moments (``_RawPredictView``);
2. upload: the int16 planes and the uint8 lung go to the device as they
   are (the JAX package's 10-bit block-gated transport, ``ops/packing.py``,
   was a fix for its TPU link and is exact, so leaving it out changes no
   number);
3. preprocess on device (``ops/preprocess.py``), then the eval forward;
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
host path (``stats["host_scans"]``).  A ``target_size`` whose voxel count
breaks the ess bit-packing sends the whole run to the host path with a
warning.  Results keep the cohort (glob) order.
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
from ..models.registry import get_model_by_name
from ..models.torch_import import load_reference_checkpoint
from ..ops.pallas_kernels import masked_sums
from ..ops.preprocess import fused_preprocess_preselected
from ..ops.resize import resize_linear_matmul_transpose
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
    selection) and padded in-plane to ``up_shape``; the lung nearest-
    selected all the way to ``target_size``; the standardize moments from
    exact integer sums.

    A scan whose lung crop exceeds ``up_shape`` in-plane does not abort the
    cohort: its index goes into :attr:`oversized` (the loader workers are
    threads, so the caller sees it), a warning names the scan, and a dummy
    zero-lung item marked ``oversized`` takes its place; the caller skips
    the dummy on output and re-runs those scans on the host path.  The JAX
    package's second overflow, a gated CT stream over its budget, cannot
    happen here: the port uploads the raw int16 planes."""

    def __init__(self, dataset: SubtypingInference, up_shape, target_size):
        self.dataset = dataset
        self.up_shape = tuple(up_shape)      # (target_d, Hpad, Wpad)
        self.target_size = tuple(target_size)
        self.oversized: Set[int] = set()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def _dummy(self, index, d, shape):
        with self._lock:
            self.oversized.add(index)
        logger.warning(
            "scan %s crop %s exceeds in-plane pad %s — will fall back to "
            "host preprocessing for this scan only", d["uid"], shape,
            self.up_shape[1:])
        return {"image_raw": np.full(self.up_shape, -2048, np.int16),
                "lung_raw": np.zeros(self.target_size, np.uint8),
                "in_sizes": np.asarray(self.up_shape, np.int32),
                "moments": np.zeros(2, np.float32),
                "uid": d["uid"], "crop_slice": d["crop_slice"],
                "original_size": d["original_size"], "oversized": True}

    def __getitem__(self, index):
        d = self.dataset[index]
        img = np.asarray(d["image"])         # int16 crop
        if any(s > p for s, p in zip(img.shape[1:], self.up_shape[1:])):
            return self._dummy(index, d, img.shape)
        idx = depth_indices_np(img.shape[0], self.up_shape[0])
        img_p = np.full(self.up_shape, -2048, np.int16)
        img_p[:, :img.shape[1], :img.shape[2]] = img[idx]
        lung_sel = resize_nearest_np(
            np.ascontiguousarray(np.asarray(d["lung_mask"])[idx],
                                 dtype=bool).view(np.uint8),
            self.target_size[1:], (1, 2))
        return {"image_raw": img_p, "lung_raw": lung_sel,
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


def _predict(model, raw, lung, in_sizes, moments, target_size,
             dtype: torch.dtype, clock: _StageClock) -> Dict[str, Any]:
    """The device program of one batch (``_cached_predict_packed``)."""
    pre = fused_preprocess_preselected(raw, lung, in_sizes, moments,
                                       target_size=target_size,
                                       em_threshold=-910.0)
    x = pre["image"][..., None].to(dtype)
    lungs5 = pre["lung_mask"][..., None]
    ess5 = pre["em_mask"][..., None]
    clock.mark()
    dense, _ = model(x, lungs5)
    clock.mark()
    b = raw.shape[0]
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
    device work.  Errors re-raise in :meth:`submit` / :meth:`close`."""

    def __init__(self, finalize: Callable[[str, Dict[str, Any]],
                                          Dict[str, Any]]):
        self._finalize = finalize
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
        wrap-around duplicates are dropped before any host work."""
        if uid in self._seen:
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
    """An eval model with a reference checkpoint's weights when
    ``ckp_path`` exists, else random weights drawn from ``seed``.  The
    bfloat16 model has the packed decoder, as the JAX processor builds it
    (processor.py:555-556)."""
    model = get_model_by_name(
        model_arch, generator=torch.Generator().manual_seed(seed),
        packed_decoder=compute_dtype == "bfloat16")
    if ckp_path and Path(ckp_path).is_file():
        report = load_reference_checkpoint(model, ckp_path)
        logger.info("loaded weights from %s: %s", ckp_path, report)
    else:
        logger.warning("no checkpoint found at %s — random weights "
                       "(seed %d)", ckp_path, seed)
    return model.eval()


def _device_path(model, dataset: SubtypingInference, make_loader,
                 fetcher: _FetchStage, target_size, pad_shape,
                 dtype: torch.dtype, device: torch.device,
                 stats: Dict[str, Any]) -> List[int]:
    """Every scan through the device program (``_predict``), batch by
    batch; returns the dataset indices whose crops exceeded ``pad_shape``
    in-plane, for the host path."""
    n_vox_t = int(np.prod(target_size))
    up_shape = (target_size[0], int(pad_shape[1]), int(pad_shape[2]))
    view = _RawPredictView(dataset, up_shape, target_size)
    for batch in make_loader(view, range(len(view))):
        clock = _StageClock(device)
        clock.mark()
        raw = _upload(batch["image_raw"], device)
        lung = _upload(batch["lung_raw"], device)
        moments = _upload(batch["moments"], device)
        clock.mark()
        res = _predict(model, raw, lung, batch["in_sizes"].tolist(), moments,
                       target_size, dtype, clock)
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
                  pad_shape=(160, 288, 384),
                  model: Optional[torch.nn.Module] = None,
                  device=None, seed: int = 0,
                  stats: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """Run the deployment pipeline over every scan; returns the results.

    ``device_preprocess=True`` (the default): the device path; scans whose
    lung crop exceeds ``pad_shape`` in-plane then run the host path one by
    one (batched among themselves).  ``False``: every scan on the
    host-preprocess path, the strict reference-parity path.
    ``model``: an eval port model to use as is (``model_arch``,
    ``ckp_path`` and ``seed`` then go unused); otherwise one is built by
    :func:`build_model`.  ``device``: default ``cuda``; without a card pass
    ``cpu`` (every kernel site then runs its plain version), else this
    raises.  ``compute_dtype``: ``float32`` (the clinical default) or
    ``bfloat16``.  ``stats``: if given, filled with ``batches`` (device and
    host path), ``scans``, ``host_scans`` (the uids that ran the host path,
    in cohort order), ``fractions`` (each uid's unrounded CLE and PSE
    lesion fractions), the summed per-stage milliseconds ``stage_ms`` and
    ``pipeline_s``, the wall time from the first loader read to the last
    file written.  ``STAGES`` are intervals of the device timeline (on a
    card: from the batch's first event, which may wait behind the previous
    batch, through host pinning and the copies to the device, then each
    device stage, then the copies back; the host path has no device
    preprocess); ``postprocess`` is host time of the postprocess thread."""
    device = entry_device(device)
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
    if device_preprocess and int(np.prod(target_size)) % 8:
        logger.warning(
            "target_size %s breaks the device path's ess bit-packing "
            "(prod(target_size) %% 8 == 0) — using host preprocessing "
            "instead", target_size)
        device_preprocess = False
    if model is None:
        model = build_model(model_arch, ckp_path, seed, compute_dtype)
    model = model.to(device).eval()

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
    stats.update(batches=0, scans=len(dataset), host_scans=[], fractions={},
                 stage_ms={k: 0.0 for k in (*STAGES, "postprocess")})

    t0 = time.perf_counter()
    pipeline = _PostprocessPipeline(functools.partial(
        _finalize_scan, dataset=dataset, out_cle=out_cle, out_pse=out_pse))
    try:
        fetcher = _FetchStage(pipeline)
        try:
            with torch.inference_mode():
                host_subset = list(range(len(dataset)))
                if device_preprocess:
                    host_subset = _device_path(
                        model, dataset, make_loader, fetcher, target_size,
                        pad_shape, dtype, device, stats)
                if host_subset:
                    stats["host_scans"] = [Path(dataset.scan_files[i]).stem
                                           for i in host_subset]
                    _host_path(model, make_loader(
                        _PredictView(dataset, target_size), host_subset),
                        fetcher, dtype, device, stats)
        finally:
            fetcher.close()
    finally:
        results = pipeline.close()
    stats["pipeline_s"] = time.perf_counter() - t0

    # the host-path scans were emitted after the device-path cohort:
    # restore the dataset (glob) order so results[0] stays the first scan
    order = {Path(f).stem: i for i, f in enumerate(dataset.scan_files)}
    results.sort(key=lambda r: order.get(r["entity"], len(order)))
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
