"""The training system of both strategies: an explicit epoch loop over the
host loader, the train step and every-epoch checkpoints.

Counterpart of ``bodyct_dram_emph_subtype_tpu/train/loop.py``
(``ScanCLSLightningModule`` / ``ScanRegLightningModule`` +
``SubtypeDataModule`` + the ``train.py`` flow): the dRAM (regression)
strategy for the ``*dram*``/``*reg*`` archs, the classification (CLS)
strategy for the others; CLE-stratified sampling with per-epoch reshuffled index order
(``models.py:99-123``); loader threads deliver host-preprocessed
fixed-shape batches (``PreprocessedView``, ``input_pipeline="host"``) or,
with ``input_pipeline="device"``, raw int16 volumes padded to
``pad_shape`` (``RawPaddedView``) that the train and eval steps preprocess
on the device (``fused_preprocess``); either way ``prefetch_to_device``
keeps the next batches' uploads in flight (pinned memory, a copy stream
of their own) while a step runs (JAX ``loop.py:374-495``); augmentation,
forward, losses, backward and the Adam update run on the device; lr
decays x0.95 per epoch (``models.py:685-698``); every-epoch checkpoints
with auto-resume and greedy weight reload (``train.py:77-99``); per-epoch
accuracy, classification report, prediction CSV and ``metrics.jsonl``;
the confusion-matrix PNGs, the heatmap tiles of the first
``debug_draw_batches`` eval batches and TensorBoard scalars under JAX's
tags (``loop.py:325-649``); ``profile``: a ``torch.profiler`` Chrome trace
of epoch 0 per rank; ``debug_nans``: anomaly detection and a
``FloatingPointError`` at the first non-finite loss or gradient.

Each step's augmentation ``torch.Generator`` is seeded from (seed, epoch,
step), the counterpart of ``fold_in(fold_in(key, epoch), step)``
(``loop.py:405``).  Training runs the model in ``.train()`` (the kernels
A and D through ``roll_conv_packed``), evaluation in ``.eval()`` (the
eval kernels A, B and C).  The CLS strategy re-weights its classes at the
end of every train phase (:func:`reweight_classes`).

Data parallelism (``parallel/mesh.py``): in a process group of W ranks
the model trains under DDP (``broadcast_buffers=False``; train BatchNorm
and the losses reduce over the global batch), each rank loads
``batch_size`` rows of its shard of the resampled list, draws its rows of
the global batch's augmentation, and the epoch end gathers every rank's
outputs; rank 0 alone writes the checkpoint, the CSVs, ``metrics.jsonl``
and the artifacts (JAX ``loop.py:274-322, 516-556``).

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: a mesh with a ``spatial`` or ``model`` axis above 1, ``grad_accum``
above 1 on more than one rank, remat other than ``none`` and the ``rbg``
noise source.  The plain ``ResNet`` archs (``resnet34``, ``resnet50``) are
refused with a ``ValueError``: they take no lung mask, so the JAX trainer
cannot train them either.  An artifact whose package (``cv2``,
``matplotlib``, ``seaborn``, ``tensorboard``) is missing is skipped with
one warning naming it.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import COPDGeneSubtyping
from ..data.host_preprocess import (PreprocessedView, RawPaddedView,
                                    preprocess_sample)
from ..data.loader import (DataLoader, DeviceUploader, default_collate,
                           pinned_collate, prefetch_to_device)
from ..data.samplers import SubtypingStratifiedSampler, shard_indices
from ..models.registry import (PLAIN_FACTORIES, get_model_by_name,
                               resolve_arch)
from ..models.torch_import import WEIGHT_FILES, load_weights_file
from ..ops.resize import resize_linear
from ..parallel.mesh import (barrier, cat_all_gather, check_replicas_equal,
                             data_width, gather_objects, rank, world_size)
from ..utils.device import entry_device
from ..utils.metrics_eval import classification_report
from ..utils.viz import (draw_mask_tile_singleview_heatmap,
                         plot_confusion_matrix_from_data,
                         plot_to_numpy_array, save_image, windowing)
from .checkpoint import CheckpointManager
from .state import epoch_lr, make_optimizer
from .steps import make_cls_train_step, make_eval_step, make_reg_train_step

logger = logging.getLogger(__name__)

TRAIN_PHASE = "train"
VALID_PHASE = "validate"
TEST_PHASE = "test"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainerConfig:
    model_arch: str = "med3ddram"
    lr: float = 1e-4
    max_epochs: int = 120
    batch_size: int = 1
    num_samples: int = 128          # per-class resample count
    target_size: Tuple[int, int, int] = (128, 224, 288)
    workers: int = 2
    data_path: str = ""
    train_csv: str = ""
    valid_csv: str = ""
    test_csv: str = ""
    model_path: str = "./models"
    nchips: Optional[int] = None    # data-parallel ranks (None == the
    # process group's world size)
    seed: int = 0
    debug_draw_batches: int = 50
    check_val_every_n_epoch: int = 1
    sampler_seed: Optional[int] = None   # None == wall-clock (reference)
    compute_dtype: str = "float32"       # or "bfloat16"
    profile: bool = False                # torch.profiler trace of epoch 0
    debug_nans: bool = False             # anomaly mode + non-finite checks
    input_pipeline: str = "host"         # or "device": fused preprocess
    pad_shape: Optional[Tuple[int, int, int]] = None  # device-pipeline buffer
    mesh: Optional[str] = None
    remat: str = "none"
    noise_rng: str = "threefry"
    grad_accum: int = 1
    packed_decoder: bool = False         # decoder convs on kernels A/D
    # under conv mode roll, on cuDNN outside it, as the JAX trainer's W-pair
    # packed decoder; the unpacked default runs them on cuDNN
    device: Optional[str] = None         # default cuda; "cpu" on request

    @property
    def exp_name(self):
        return f"subtyping_{self.model_arch}"

    @property
    def exp_path(self) -> Path:
        return Path(self.model_path) / self.exp_name

    @property
    def is_regression(self):
        return "dram" in self.model_arch or "reg" in self.model_arch


def check_supported(cfg: TrainerConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port, and
    ``ValueError`` for what the trainer cannot run."""
    if resolve_arch(cfg.model_arch)[0] in PLAIN_FACTORIES:
        raise ValueError(
            f"{cfg.model_arch}: the plain ResNet classifier takes no lung "
            f"mask and has no decoder; the trainer runs the Seg archs "
            f"(med3d*, med3ddram*), as the JAX trainer does, whose train "
            f"forward passes the lungs to the model")
    world = world_size()
    if cfg.mesh is not None or cfg.nchips is not None:
        width = data_width(cfg.mesh, cfg.nchips, cfg.device)
        if width != world:
            raise ValueError(
                f"{width} data-parallel ranks asked for, the process group "
                f"holds {world}: launch the CLI with --ngpus {width}, or "
                f"torchrun with --multihost")
    if world > 1 and cfg.grad_accum > 1:
        raise NotImplementedError(
            f"grad_accum {cfg.grad_accum} on {world} ranks: the JAX step's "
            f"micro-batches are slices of the global batch, which would "
            f"move rows between ranks (ROADMAP section 1, 'Spatial "
            f"sharding, tensor parallelism and remat')")
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r}: activation checkpointing is not ported "
            f"(ROADMAP section 1); B=2 fits an 80 GB card without it, and a "
            f"naive torch.utils.checkpoint would update each train "
            f"BatchNorm's running statistics twice")
    if cfg.noise_rng != "threefry":
        raise NotImplementedError(
            f"noise_rng={cfg.noise_rng!r}: the TPU hardware-RNG noise source "
            f"is not ported (ROADMAP section 1); the port draws from a "
            f"torch.Generator")
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
    if cfg.batch_size % cfg.grad_accum:
        raise ValueError(f"batch_size {cfg.batch_size} must divide by "
                         f"grad_accum {cfg.grad_accum}")


def reweight_classes(current, y_true, y_pred) -> np.ndarray:
    """The adaptive class re-weighting of the CLS strategy (JAX
    ``loop.py:570-585``, reference ``models.py:369-379``): with the
    per-class accuracy of the confusion matrix of ``y_true`` against
    ``y_pred`` (a class never seen counts 0), ``new = current * (1 - acc)``,
    normalised to sum 1; ``current`` is kept when that sum is 0 (every
    seen class always right)."""
    current = np.asarray(current, np.float64)
    n = len(current)
    matrix = np.zeros((n, n))
    np.add.at(matrix, (np.asarray(y_true, int), np.asarray(y_pred, int)), 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        acc = np.nan_to_num(matrix.diagonal() / matrix.sum(axis=1))
    new = current * (1.0 - acc)
    return new / new.sum() if new.sum() > 0 else current


def resampled_list(sampler: SubtypingStratifiedSampler) -> List[int]:
    """One epoch's resampled list, the same on every rank.  Its seed is
    the sampler's fixed seed, else the wall clock of rank 0, which every
    rank takes (over the gloo group): ranks whose clocks read different
    seconds would otherwise deal their shards from different lists (JAX
    deals one list per host to its data axis, ``loop.py:306-310``)."""
    seed = sampler.epoch_seed()
    if sampler.seed is None and world_size() > 1:
        seed = gather_objects(seed)[0]
    return sampler.epoch_indices(seed)


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The augmentation generator's seed of one train step."""
    return int(np.random.SeedSequence([seed, epoch, step])
               .generate_state(1)[0])


class SubtypeTrainer:
    """Explicit trainer of both strategies (``mode`` ``reg`` or ``cls``).

    ``step_mark``: optional ``mark(name)`` hook, called with ``loader``
    before each train batch is fetched and passed on to the train step
    (phase boundaries), so a caller can time a step's parts."""

    def __init__(self, config: TrainerConfig):
        check_supported(config)
        self.config = config
        self.device = entry_device(config.device)
        self.dtype = DTYPES[config.compute_dtype]
        self.mode = "reg" if config.is_regression else "cls"
        self.model: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.datasets: Dict[str, Any] = {}
        self.cle_class_weights = np.ones(6) / 6
        self.pse_class_weights = np.ones(3) / 3
        self.epoch = 0
        self.ckpt: Optional[CheckpointManager] = None
        self.epoch_train_losses: Dict[int, float] = {}
        self.step_mark: Optional[Callable[[str], None]] = None
        self.world, self.rank = world_size(), rank()
        self.train_module: Optional[torch.nn.Module] = None
        self.global_step = 0
        self._tb = None
        self._missing_warned: set = set()

    # ------------------------------------------------------------------ setup
    def init_state(self) -> torch.nn.Module:
        """Model with weights drawn from ``seed`` on the device, a fresh
        Adam, and the train / eval steps."""
        cfg = self.config
        self.model = get_model_by_name(
            cfg.model_arch, generator=torch.Generator().manual_seed(cfg.seed),
            packed_decoder=cfg.packed_decoder).to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr)
        self.train_module = self.model
        if self.world > 1:
            # every parameter gets a gradient in both strategies' train
            # forwards; the running statistics are kept equal by the global
            # moments, not by a broadcast
            self.train_module = torch.nn.parallel.DistributedDataParallel(
                self.model, broadcast_buffers=False,
                device_ids=([self.device] if self.device.type == "cuda"
                            else None))
        make = (make_reg_train_step if self.mode == "reg"
                else make_cls_train_step)
        self._train_step = make(
            self.train_module, self.optimizer, num_data_shards=self.world,
            accum_steps=cfg.grad_accum, compute_dtype=self.dtype,
            device=self.device, fused_input=cfg.input_pipeline == "device",
            target_size=tuple(cfg.target_size), debug_nans=cfg.debug_nans)
        # per input pipeline; the device one preprocesses in the step (JAX
        # loop.py:488-495), so evaluation follows the pipeline it is given
        self._eval_steps = {
            pipeline: make_eval_step(
                self.model, self.mode, self.dtype, self.device,
                fused_input=pipeline == "device",
                target_size=tuple(cfg.target_size))
            for pipeline in ("host", "device")}
        self._uploader = DeviceUploader(self.device)
        return self.model

    def _put(self, pipeline: str, train: bool):
        """``put_fn`` of ``prefetch_to_device``: one loader batch's inputs
        and labels -> (:class:`~..data.loader.Upload`, the host batch).
        The arrays each pipeline uploads are JAX ``loop.py:374-384,
        441-451``'s; eval batches need no ``em_mask``."""
        if pipeline == "device":
            keys = ("image_raw", "lung_raw", "in_sizes")
        else:
            keys = ("image", "lung_mask") + (("em_mask",) if train else ())
        keys += ("cls_label", "pse_label")

        def put(batch):
            return self._uploader({k: batch[k] for k in keys}), batch

        return put

    def setup_checkpointing(self) -> CheckpointManager:
        self.ckpt = CheckpointManager(self.config.exp_path / "checkpoints")
        return self.ckpt

    def try_resume(self, reload_only_weights: bool = True,
                   ckp: Optional[str] = None) -> bool:
        """Auto-resume of ``train.py:77-91``: an explicit weights file
        (``.ckpt``/``.pth``/``.pt``/``.npz``) is loaded greedily; else the
        newest checkpoint — weights only, or (``reload_only_weights``
        false) weights, optimizer, class weights and the next epoch."""
        if self.model is None or self.ckpt is None:
            raise RuntimeError("call init_state() and setup_checkpointing() "
                               "first")
        if ckp is not None and Path(ckp).suffix in WEIGHT_FILES:
            report = load_weights_file(self.model, ckp)
            logger.info("greedy weights reload from %s: %s", ckp, report)
            return True
        latest = self.ckpt.latest_epoch()
        if latest is None:
            return False
        payload = self.ckpt.restore(latest)
        self.model.load_state_dict(payload["model"])
        if not reload_only_weights:
            self.optimizer.load_state_dict(payload["optimizer"])
            self.epoch = payload["epoch"] + 1
            self.cle_class_weights = np.asarray(payload["cle_class_weights"])
            self.pse_class_weights = np.asarray(payload["pse_class_weights"])
        logger.info("resumed from epoch %d (weights_only=%s)", latest,
                    reload_only_weights)
        return True

    def _dataset(self, phase: str):
        cfg = self.config
        if phase in self.datasets:
            return self.datasets[phase]
        csv_file = {TRAIN_PHASE: cfg.train_csv, VALID_PHASE: cfg.valid_csv,
                    TEST_PHASE: cfg.test_csv}[phase]
        ds = COPDGeneSubtyping(cfg.data_path,
                               COPDGeneSubtyping.get_series_uids(csv_file))
        self.datasets[phase] = ds
        if phase == TRAIN_PHASE:
            self.sampler = SubtypingStratifiedSampler(ds, cfg.num_samples,
                                                      seed=cfg.sampler_seed)
            self.cle_class_weights = np.asarray(
                self.sampler.cle_class_weights)
            self.pse_class_weights = np.asarray(
                self.sampler.pse_class_weights)
            ds.cle_class_weights = self.cle_class_weights
            ds.pse_class_weights = self.pse_class_weights
        return ds

    def _loader(self, phase: str, epoch: int,
                input_pipeline: Optional[str] = None) -> DataLoader:
        """The loader of ``phase`` on this rank (JAX ``loop.py:274-322``):
        ``batch_size`` rows per step of this rank's shard of the resampled
        list (``shard_indices``), or of the eval set, padded by
        wrap-around; host-preprocessed batches, or raw padded ones for the
        device pipeline (``input_pipeline``, default the config's).  On a
        CUDA device batches are stacked in pinned memory."""
        cfg = self.config
        ds = self._dataset(phase)
        if (input_pipeline or cfg.input_pipeline) == "device":
            if cfg.pad_shape is None:
                raise ValueError("input_pipeline='device' needs pad_shape")
            view = RawPaddedView(ds, cfg.pad_shape)
        else:
            view = PreprocessedView(ds, cfg.target_size)
        collate = (pinned_collate if self.device.type == "cuda"
                   else default_collate)
        if phase == TRAIN_PHASE:
            indices = shard_indices(resampled_list(self.sampler), self.world,
                                    self.rank, shuffle=True, epoch=epoch)
            return DataLoader(view, indices=indices,
                              batch_size=cfg.batch_size,
                              num_workers=cfg.workers, drop_last=True,
                              collate=collate)
        # pad by wrap-around so the last batch is full; duplicates are
        # dropped at epoch end (models.py:306-311)
        indices = shard_indices(np.arange(len(ds)), self.world, self.rank,
                                shuffle=False)
        if len(indices) % cfg.batch_size:
            total = -(-len(indices) // cfg.batch_size) * cfg.batch_size
            indices = np.resize(indices, total)
        return DataLoader(view, indices=indices, batch_size=cfg.batch_size,
                          num_workers=cfg.workers, collate=collate)

    # -------------------------------------------------------------- artifacts
    def _missing(self, exc: ImportError, artifact: str) -> None:
        """One warning per missing package: the artifact is skipped."""
        name = (exc.name or str(exc)).split(".")[0]
        if name not in self._missing_warned:
            self._missing_warned.add(name)
            logger.warning("%s skipped: package %r unavailable (%s)",
                           artifact, name, exc)

    def _importable(self, package: str, artifact: str) -> bool:
        try:
            __import__(package)
            return True
        except ImportError as exc:
            self._missing(exc, artifact)
            return False

    @property
    def tb_writer(self):
        """Lazy TensorBoard writer on rank 0 (``exp_path/tb_logs``, the
        reference's ``TensorBoardLogger``); ``None`` elsewhere or without
        the ``tensorboard`` package."""
        if self._tb is None and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(self.config.exp_path /
                                             "tb_logs"))
            except ImportError as exc:
                exc.name = exc.name or "tensorboard"
                self._missing(exc, "TensorBoard logging")
                self._tb = False
        return self._tb or None

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        self._tb = None

    # ------------------------------------------------------------------ train
    def fit(self) -> torch.nn.Module:
        cfg = self.config
        if self.model is None:
            self.init_state()
        if self.ckpt is None:
            self.setup_checkpointing()
        with torch.autograd.set_detect_anomaly(cfg.debug_nans):
            for epoch in range(self.epoch, cfg.max_epochs):
                self._fit_epoch(epoch)
        return self.model

    def _fit_epoch(self, epoch: int) -> None:
        """One train epoch, its epoch end, the checkpoint (rank 0, then a
        barrier) and, every ``check_val_every_n_epoch``, validation (JAX
        ``loop.py:334-358``)."""
        cfg = self.config
        self.epoch = epoch
        t0 = time.time()
        if cfg.profile and epoch == 0:
            metrics, outputs = self._profiled_train_epoch(epoch)
        else:
            metrics, outputs = self._run_train_epoch(epoch)
        self._epoch_end(outputs, TRAIN_PHASE, epoch)
        logger.info("epoch %d done in %.1fs %s", epoch, time.time() - t0,
                    {k: round(v, 4) for k, v in metrics.items()})
        if self.tb_writer:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(f"{TRAIN_PHASE}_{k}", v, epoch)
        check_replicas_equal(self.model)
        if self.rank == 0:
            self.ckpt.save(epoch, self.model, self.optimizer,
                           self.cle_class_weights, self.pse_class_weights,
                           metrics)
        barrier()
        self.epoch_train_losses[epoch] = float(metrics.get("loss", 0.0))
        if (epoch + 1) % cfg.check_val_every_n_epoch == 0 and cfg.valid_csv:
            self.evaluate(VALID_PHASE, epoch)

    def _profiled_train_epoch(self, epoch: int):
        """The train epoch under ``torch.profiler`` (CPU and, on a card,
        CUDA activities; each step stage a ``record_function`` span named
        after its mark); one Chrome trace per rank,
        ``exp_path/profile/rank<r>.json`` (JAX ``loop.py:337-341``)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out = self.config.exp_path / "profile"
        out.mkdir(parents=True, exist_ok=True)
        spans = _StageSpans()
        with profile(activities=activities) as prof:
            try:
                result = self._run_train_epoch(epoch, spans)
            finally:
                spans("done")
        path = out / f"rank{self.rank}.json"
        prof.export_chrome_trace(str(path))
        logger.info("profiler trace written to %s", path)
        return result

    def restore_best(self) -> int:
        """Restore the lowest-train-loss epoch's checkpoint (the
        reference's ``trainer.test(ckpt_path='best')`` with ``monitor=
        'train_loss'``, ``train.py:92-99,108``)."""
        if not self.epoch_train_losses:
            return self.epoch
        best = min(self.epoch_train_losses, key=self.epoch_train_losses.get)
        payload = self.ckpt.restore(best)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        logger.info("restored best epoch %d (train_loss=%.4f)", best,
                    self.epoch_train_losses[best])
        return best

    def _run_train_epoch(self, epoch: int, spans=None
                         ) -> Tuple[Dict[str, float], List[Dict]]:
        cfg = self.config
        lr = epoch_lr(cfg.lr, epoch)
        marks = [m for m in (self.step_mark, spans) if m is not None]

        def mark(name):
            for m in marks:
                m(name)

        outputs: List[Dict[str, np.ndarray]] = []
        running: Dict[str, float] = {}
        n_steps = 0
        it = prefetch_to_device(self._loader(TRAIN_PHASE, epoch),
                                self._put(cfg.input_pipeline, train=True))
        while True:
            mark("loader")
            item = next(it, None)
            if item is None:
                break
            upload, batch = item
            gen = torch.Generator(self.device).manual_seed(
                step_seed(cfg.seed, epoch, n_steps))
            metrics, preds = self._train_step(
                upload.ready(), lr, self.cle_class_weights,
                self.pse_class_weights, generator=gen, mark=mark)
            n_steps += 1
            self.global_step += 1
            tb = self.tb_writer
            for k, v in metrics.items():
                v = float(v)
                running[k] = running.get(k, 0.0) + v
                if tb:      # the reference's on_step logging
                    tb.add_scalar(f"{TRAIN_PHASE}_{k}_step", v,
                                  self.global_step)
            out = {k: v.cpu().numpy() for k, v in preds.items()}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            outputs.append(out)
        return ({k: v / max(n_steps, 1) for k, v in running.items()},
                outputs)

    # ------------------------------------------------------------------- eval
    def evaluate(self, phase: str, epoch: Optional[int] = None,
                 input_pipeline: Optional[str] = None) -> Dict[str, float]:
        """Eval epoch: eval forward, labels, the epoch-end report of
        ``phase`` (on rank 0; ``{}`` on the others).  ``input_pipeline``
        defaults to the config's, so a device-pipeline run serves val and
        test through the fused eval step too; ``"host"`` or ``"device"``
        overrides it per call.  Rank 0 draws the heatmap tiles of its first
        ``debug_draw_batches`` batches; only those copy the dense maps to
        the host (JAX ``loop.py:458-486``)."""
        epoch = epoch if epoch is not None else self.epoch
        if self.model is None:
            self.init_state()
        pipeline = input_pipeline or self.config.input_pipeline
        eval_step = self._eval_steps[pipeline]
        outputs = []
        for batch_idx, (upload, batch) in enumerate(prefetch_to_device(
                self._loader(phase, epoch, input_pipeline=pipeline),
                self._put(pipeline, train=False))):
            res = eval_step(upload.ready())
            draw = (self.rank == 0
                    and batch_idx < self.config.debug_draw_batches
                    and self._importable("cv2", "heatmap tiles"))
            out = {k: v.float().cpu().numpy() if k.startswith("dense")
                   else v.cpu().numpy() for k, v in res.items()
                   if draw or not k.startswith("dense")}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            if draw:
                self._draw_predictions(
                    self._host_view_of_raw_batch(batch)
                    if pipeline == "device" else batch, out, phase, epoch)
                out = {k: v for k, v in out.items()
                       if not k.startswith("dense")}
            outputs.append(out)
        return self._epoch_end(outputs, phase, epoch)

    def _host_view_of_raw_batch(self, batch) -> Dict[str, np.ndarray]:
        """The host preprocess of a raw padded batch, for the heatmap tiles
        (drawn batches only; JAX ``loop.py:497-514``)."""
        images, lungs, ems = [], [], []
        for i in range(len(batch["in_sizes"])):
            sl = tuple(slice(0, int(s)) for s in batch["in_sizes"][i])
            raw = np.asarray(batch["image_raw"][i])[sl]
            lung = np.asarray(batch["lung_raw"][i])[sl] > 0
            sample = {"image": raw, "lung_mask": lung,
                      "em_mask": np.logical_and(raw < -950, lung)}
            pre = preprocess_sample(sample, tuple(self.config.target_size))
            images.append(pre["image"])
            lungs.append(pre["lung_mask"])
            ems.append(pre["em_mask"])
        return {"image": np.stack(images), "lung_mask": np.stack(lungs),
                "em_mask": np.stack(ems), "index": batch["index"]}

    # --------------------------------------------------------------- epoch end
    def _epoch_end(self, outputs: List[Dict], phase: str, epoch: int
                   ) -> Dict[str, float]:
        """``shared_epoch_end`` (``models.py:287-317,603-633``; JAX
        ``loop.py:516-556``): gather every rank's outputs, dedup by dataset
        index, the CLS class re-weighting of a train phase (CLE, then PSE,
        on the de-duplicated outputs, on every rank: the next epoch's steps
        and this epoch's checkpoint take the new weights); then on rank 0
        alone the accuracy, the report, the confusion-matrix PNGs, the CSV,
        ``metrics.jsonl`` and the TensorBoard scalars.  Other ranks return
        ``{}``."""
        if not outputs:
            return {}
        cat = {k: np.concatenate([o[k] for o in outputs]) for k in outputs[0]}
        if self.world > 1:
            cat = cat_all_gather(cat)
        _, unique_ids = np.unique(cat["index"], return_index=True)
        dedup = {k: v[unique_ids] for k, v in cat.items()}
        if phase == TRAIN_PHASE and self.mode == "cls":
            for name in ("cle", "pse"):
                current = getattr(self, f"{name}_class_weights")
                new = reweight_classes(current, dedup[f"{name}_labels"],
                                       dedup[f"pred_{name}_labels"])
                if not np.array_equal(new, current):
                    logger.info("reset %s class weights: %s -> %s", name,
                                current, new)
                setattr(self, f"{name}_class_weights", new)
        if self.rank != 0:
            return {}
        acc_cle = float((cat["pred_cle_labels"] == cat["cle_labels"]).mean())
        acc_pse = float((cat["pred_pse_labels"] == cat["pse_labels"]).mean())
        report = classification_report(dedup["cle_labels"],
                                       dedup["pred_cle_labels"], 6,
                                       prefix=f"epoch_{phase}_cle_")
        report.update(classification_report(dedup["pse_labels"],
                                            dedup["pred_pse_labels"], 3,
                                            prefix=f"epoch_{phase}_pse_"))
        for name, n in (("cle", 6), ("pse", 3)):
            self._log_confusion_matrix(dedup[f"pred_{name}_labels"],
                                       dedup[f"{name}_labels"], phase, name,
                                       n, epoch)
        self._log_csv(dedup, phase, epoch)
        logger.info("epoch_%s_acc_cle=%.4f acc_pse=%.4f", phase, acc_cle,
                    acc_pse)
        metrics = {f"epoch_{phase}_acc_cle": acc_cle,
                   f"epoch_{phase}_acc_pse": acc_pse, **report}
        out = self.config.exp_path / "metrics.jsonl"
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps({"epoch": epoch, "phase": phase, **metrics})
                    + "\n")
        if self.tb_writer:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(k, v, epoch)
            self.tb_writer.flush()
        return metrics

    def _log_confusion_matrix(self, y_pred, y_true, phase, name, n_classes,
                              epoch):
        """``confusion_matrices/<phase>/<phase>_epoch_<e>_cm_<name>.png``
        and its TensorBoard image (JAX ``loop.py:558-569``)."""
        try:
            image = plot_to_numpy_array(plot_confusion_matrix_from_data(
                y_true, y_pred, list(range(n_classes)), line_width=0.5,
                fig_size=10, font_size=11))
            out_dir = self.config.exp_path / "confusion_matrices" / phase
            out_dir.mkdir(parents=True, exist_ok=True)
            save_image(out_dir / f"{phase}_epoch_{epoch}_cm_{name}.png",
                       image)
        except ImportError as exc:
            self._missing(exc, "confusion-matrix PNG")
            return
        if self.tb_writer:
            self.tb_writer.add_image(f"{phase}_confusion_matrix_{name}",
                                     image, epoch, dataformats="HWC")

    def _log_csv(self, dedup: Dict[str, np.ndarray], phase: str, epoch: int):
        ds = self.datasets.get(phase)
        uids = ([ds.series_uids[i] for i in dedup["index"]]
                if ds is not None else list(map(str, dedup["index"])))
        out_dir = self.config.exp_path / "predicts" / phase
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{epoch}_predicts.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["uid", "y_preds_cle", "y_preds_pse", "y_cle",
                             "y_pse"])
            for row in zip(uids, dedup["pred_cle_labels"],
                           dedup["pred_pse_labels"], dedup["cle_labels"],
                           dedup["pse_labels"]):
                writer.writerow(row)

    def _draw_predictions(self, batch, res, phase, epoch):
        """The heatmap tiles of one eval batch (``models.py:455-493``, JAX
        ``loop.py:611-649``): ``debug_input_data/<epoch>/<phase>/<uid>_
        label_<cle>_<pred cle>_<pse>_<pred pse>.jpg`` (needs ``cv2``)."""
        out_dir = (self.config.exp_path / "debug_input_data" / str(epoch)
                   / phase)
        out_dir.mkdir(parents=True, exist_ok=True)
        size = batch["image"].shape[1:4]
        dense_cle, dense_pse = (
            resize_linear(torch.from_numpy(np.asarray(res[k], np.float32)),
                          size, (1, 2, 3), align_corners=False).numpy()
            for k in ("dense_cle", "dense_pse"))
        ds = self.datasets.get(phase)
        for i in range(batch["image"].shape[0]):
            scan = np.asarray(batch["image"][i])
            lung = np.asarray(batch["lung_mask"][i])
            em = np.asarray(batch.get("em_mask", np.zeros_like(lung))[i])
            if self.mode == "reg":
                dp_cle = dense_cle[i, ..., 0]
                dp_pse = dense_pse[i, ..., 0]
            else:
                dp_cle = np.maximum(dense_cle[i, ..., 1:], 0).sum(-1)
                dp_pse = np.maximum(dense_pse[i, ..., 1:], 0).sum(-1)
                dp_cle = dp_cle / (dp_cle.max() + 1e-7)
                dp_pse = dp_pse / (dp_pse.max() + 1e-7)
            index = int(np.asarray(batch["index"]).reshape(-1)[i])
            uid = ds.series_uids[index] if ds is not None else str(index)
            labels = [int(np.asarray(res[k])[i]) for k in (
                "cle_labels", "pred_cle_labels", "pse_labels",
                "pred_pse_labels")]
            path = out_dir / (f"{uid}_label_" + "_".join(map(str, labels)))
            draw_mask_tile_singleview_heatmap(
                windowing(scan, from_span=None).astype(np.uint8),
                [[(lung * 255).astype(np.uint8)],
                 [windowing(dp_cle * lung, from_span=(0, 1))
                  .astype(np.uint8)],
                 [windowing(dp_pse * lung, from_span=(0, 1))
                  .astype(np.uint8)],
                 [(em * 255).astype(np.uint8)]],
                lung > 0, 5, path, coord_axis=0,
                titles=["lung", "heatmap (cle)", "heatmap (pse)", "LAA950"])


class _StageSpans:
    """The ``mark`` hook of a profiled epoch: each call closes the open
    ``record_function`` span and opens one named after the new stage
    (``done`` opens none)."""

    def __init__(self):
        self._open = None

    def __call__(self, name: str) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name != "done":
            self._open = torch.profiler.record_function(name)
            self._open.__enter__()
