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
accuracy, classification report, prediction CSV and ``metrics.jsonl``.

Each step's augmentation ``torch.Generator`` is seeded from (seed, epoch,
step), the counterpart of ``fold_in(fold_in(key, epoch), step)``
(``loop.py:405``).  Training runs the model in ``.train()`` (the kernels
A and D through ``roll_conv_packed``), evaluation in ``.eval()`` (the
eval kernels A, B and C).  The CLS strategy re-weights its classes at the
end of every train phase (:func:`reweight_classes`).

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: multi-device training (``nchips`` > 1, ``mesh``), remat other than
``none`` and the ``rbg`` noise source.  The
plain ``ResNet`` archs (``resnet34``, ``resnet50``) are refused with a
``ValueError``: they take no lung mask, so the JAX trainer cannot train
them either.  The confusion-matrix PNGs, the heatmap tiles and
TensorBoard are skipped (logged once).
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
from ..data.host_preprocess import PreprocessedView, RawPaddedView
from ..data.loader import (DataLoader, DeviceUploader, default_collate,
                           pinned_collate, prefetch_to_device)
from ..data.samplers import SubtypingStratifiedSampler, shard_indices
from ..models.registry import (PLAIN_FACTORIES, get_model_by_name,
                               resolve_arch)
from ..models.torch_import import (load_reference_checkpoint,
                                   load_state_dict_greedy)
from ..utils.device import entry_device
from ..utils.metrics_eval import classification_report
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
    nchips: Optional[int] = None    # >1 needs DDP: not ported
    seed: int = 0
    sampler_seed: Optional[int] = None   # None == wall-clock (reference)
    compute_dtype: str = "float32"       # or "bfloat16"
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
    if cfg.mesh is not None or (cfg.nchips or 1) > 1:
        raise NotImplementedError(
            "multi-device training (mesh, nchips > 1, multihost) needs DDP, "
            "which is not ported yet (ROADMAP section 1, 'DDP')")
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
        self._skipped_logged = False

    # ------------------------------------------------------------------ setup
    def init_state(self) -> torch.nn.Module:
        """Model with weights drawn from ``seed`` on the device, a fresh
        Adam, and the train / eval steps."""
        cfg = self.config
        self.model = get_model_by_name(
            cfg.model_arch, generator=torch.Generator().manual_seed(cfg.seed),
            packed_decoder=cfg.packed_decoder).to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), cfg.lr)
        make = (make_reg_train_step if self.mode == "reg"
                else make_cls_train_step)
        self._train_step = make(
            self.model, self.optimizer, accum_steps=cfg.grad_accum,
            compute_dtype=self.dtype, device=self.device,
            fused_input=cfg.input_pipeline == "device",
            target_size=tuple(cfg.target_size))
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
        if ckp is not None and Path(ckp).suffix in (".ckpt", ".pth", ".pt",
                                                    ".npz"):
            if Path(ckp).suffix == ".npz":
                with np.load(ckp) as z:
                    report = load_state_dict_greedy(
                        self.model, {k: z[k] for k in z.files})
            else:
                report = load_reference_checkpoint(self.model, ckp)
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
        """The loader of ``phase``: host-preprocessed batches, or raw
        padded ones for the device pipeline (``input_pipeline``, default
        the config's).  On a CUDA device batches are stacked in pinned
        memory."""
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
            indices = shard_indices(list(iter(self.sampler)), 1, 0,
                                    shuffle=True, epoch=epoch)
            return DataLoader(view, indices=indices,
                              batch_size=cfg.batch_size,
                              num_workers=cfg.workers, drop_last=True,
                              collate=collate)
        # pad by wrap-around so the last batch is full; duplicates are
        # dropped at epoch end (models.py:306-311)
        indices = np.arange(len(ds))
        if len(indices) % cfg.batch_size:
            total = -(-len(indices) // cfg.batch_size) * cfg.batch_size
            indices = np.resize(indices, total)
        return DataLoader(view, indices=indices, batch_size=cfg.batch_size,
                          num_workers=cfg.workers, collate=collate)

    def _log_skipped_once(self):
        if not self._skipped_logged:
            logger.info("skipped (not ported): confusion-matrix PNGs, "
                        "heatmap tiles, TensorBoard scalars")
            self._skipped_logged = True

    # ------------------------------------------------------------------ train
    def fit(self) -> torch.nn.Module:
        cfg = self.config
        if self.model is None:
            self.init_state()
        if self.ckpt is None:
            self.setup_checkpointing()
        for epoch in range(self.epoch, cfg.max_epochs):
            self.epoch = epoch
            t0 = time.time()
            metrics, outputs = self._run_train_epoch(epoch)
            self._epoch_end(outputs, TRAIN_PHASE, epoch)
            logger.info("epoch %d done in %.1fs %s", epoch, time.time() - t0,
                        {k: round(v, 4) for k, v in metrics.items()})
            self.ckpt.save(epoch, self.model, self.optimizer,
                           self.cle_class_weights, self.pse_class_weights,
                           metrics)
            self.epoch_train_losses[epoch] = float(metrics.get("loss", 0.0))
            if cfg.valid_csv:
                self.evaluate(VALID_PHASE, epoch)
        return self.model

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

    def _run_train_epoch(self, epoch: int
                         ) -> Tuple[Dict[str, float], List[Dict]]:
        cfg = self.config
        lr = epoch_lr(cfg.lr, epoch)
        mark = self.step_mark or (lambda name: None)
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
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + float(v)
            out = {k: v.cpu().numpy() for k, v in preds.items()}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            outputs.append(out)
        return ({k: v / max(n_steps, 1) for k, v in running.items()},
                outputs)

    # ------------------------------------------------------------------- eval
    def evaluate(self, phase: str, epoch: Optional[int] = None,
                 input_pipeline: Optional[str] = None) -> Dict[str, float]:
        """Eval epoch: eval forward, labels, the epoch-end report of
        ``phase``.  ``input_pipeline`` defaults to the config's, so a
        device-pipeline run serves val and test through the fused eval
        step too; ``"host"`` or ``"device"`` overrides it per call."""
        epoch = epoch if epoch is not None else self.epoch
        if self.model is None:
            self.init_state()
        pipeline = input_pipeline or self.config.input_pipeline
        eval_step = self._eval_steps[pipeline]
        outputs = []
        for upload, batch in prefetch_to_device(
                self._loader(phase, epoch, input_pipeline=pipeline),
                self._put(pipeline, train=False)):
            res = eval_step(upload.ready())
            out = {k: v.cpu().numpy() for k, v in res.items()
                   if not k.startswith("dense")}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            outputs.append(out)
        return self._epoch_end(outputs, phase, epoch)

    # --------------------------------------------------------------- epoch end
    def _epoch_end(self, outputs: List[Dict], phase: str, epoch: int
                   ) -> Dict[str, float]:
        """``shared_epoch_end`` (``models.py:287-317,603-633``): gather,
        dedup by dataset index, accuracy, report, the CLS class
        re-weighting of a train phase (CLE, then PSE, on the de-duplicated
        outputs; the next epoch's steps and this epoch's checkpoint take
        the new weights), CSV, ``metrics.jsonl``."""
        if not outputs:
            return {}
        cat = {k: np.concatenate([o[k] for o in outputs]) for k in outputs[0]}
        acc_cle = float((cat["pred_cle_labels"] == cat["cle_labels"]).mean())
        acc_pse = float((cat["pred_pse_labels"] == cat["pse_labels"]).mean())
        _, unique_ids = np.unique(cat["index"], return_index=True)
        dedup = {k: v[unique_ids] for k, v in cat.items()}
        report = classification_report(dedup["cle_labels"],
                                       dedup["pred_cle_labels"], 6,
                                       prefix=f"epoch_{phase}_cle_")
        report.update(classification_report(dedup["pse_labels"],
                                            dedup["pred_pse_labels"], 3,
                                            prefix=f"epoch_{phase}_pse_"))
        self._log_skipped_once()
        if phase == TRAIN_PHASE and self.mode == "cls":
            for name in ("cle", "pse"):
                current = getattr(self, f"{name}_class_weights")
                new = reweight_classes(current, dedup[f"{name}_labels"],
                                       dedup[f"pred_{name}_labels"])
                if not np.array_equal(new, current):
                    logger.info("reset %s class weights: %s -> %s", name,
                                current, new)
                setattr(self, f"{name}_class_weights", new)
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
        return metrics

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
