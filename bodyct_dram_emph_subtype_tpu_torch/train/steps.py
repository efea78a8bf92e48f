"""The train steps of both strategies, the eval step and the predict step.

Counterpart of ``bodyct_dram_emph_subtype_tpu/train/steps.py``'s
``make_reg_train_step``, ``make_cls_train_step``, ``make_eval_step`` and
``make_predict_step`` (reference ``models.py:236-264, 539-592``, the TRAIN
and VAL/TEST branches of ``shared_step``, and ``models.py:430-450``,
``predict_step``):

- train (both strategies, :func:`_make_train_step`): with
  ``fused_input`` (the device input pipeline) the raw padded int16 volumes
  through ``ops/preprocess.py::fused_preprocess`` (LAA mask at -950 HU,
  ``steps.py:88-99``), then on-device
  augmentation -> train-mode forward (BatchNorm batch statistics) -> the
  losses -> backward -> one Adam update.  dRAM: the four reg losses
  ``(cle + pse) / num_data_shards + 2 * mutex_dice + coverage_bce``;
  CLS: the class-weighted cross entropies of the pooled CLE and PSE
  logits, ``cle + pse``, and ``argmax`` predictions;
- ``accum_steps > 1``: the batch splits into microbatches run one after
  the other, gradients averaged, BatchNorm running statistics chained
  through them, one Adam update (``steps.py:196-221``);
- eval: (``fused_input``: the fused preprocess, then) eval forward +
  predicted labels (interval lookup of the lesion fractions for dRAM,
  ``argmax`` of the pooled logits for CLS);
- predict: eval forward -> both dRAM maps linearly upsampled
  (align_corners=True) to the input size -> masked by the -910 HU
  emphysema-susceptible mask -> lesion percentages, normalised per sample
  or, with ``batch_lung_norm``, by the whole batch's lung volume as the
  reference does (``models.py:440-441``; equal at batch 1).

The JAX step is one jitted program; the port runs eagerly.  Augmentation
draws its random numbers from the ``torch.Generator`` it is handed.

The mesh (``parallel/mesh.py``): on D data ranks each holding B rows,
micro-batch i of ``accum_steps`` a holds the global rows ``[i*G/a,
(i+1)*G/a)`` of the G = D*B rows (JAX ``steps.py:197-223``), of which rank
d holds B/a (the trainer's loader deals them); DDP syncs the gradients
in the last micro-batch's backward only (``no_sync``).  On a spatial axis
each rank preprocesses and augments the whole volume (flips and the
crop-resize mix rows across H; every rank of a spatial group draws the
same per-row parameters) and then keeps its H slab (``parallel/
spatial.py``), where ``H % (8 * S) == 0``; the eval and predict steps
gather the dense maps back to the whole volume.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import CLE_RATIO_MAP, PSE_RATIO_MAP
from ..losses import (generate_regression_labels, interval_regression_loss,
                      ratio_to_label_batch, segmentation_losses,
                      weighted_cross_entropy)
from ..ops.pallas_kernels import masked_sums
from ..ops.preprocess import fused_preprocess
from ..ops.resize import resize_linear_matmul, resize_nearest
from ..parallel import spatial
from ..parallel.mesh import coords, mesh
from ..transforms.batch_augment import augment_batch, draw_augment_params
from .state import set_lr

METRICS = ("loss", "loss_cle", "loss_pse", "mul_loss", "seg_loss")
CLS_METRICS = ("loss", "loss_cle", "loss_pse")


def dense_map_size(spatial: Sequence[int]) -> Tuple[int, int, int]:
    """(D', H', W') of ResNetSegReg's dense maps for an input of spatial
    size ``spatial``: the stem conv, pool and layer2 each take ceil(n/2),
    us1 and us2 each double (half the input for sizes divisible by 8)."""
    out = []
    for n in spatial:
        for _ in range(3):
            n = -(-n // 2)
        out.append(4 * n)
    return tuple(out)


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype, non_blocking=True)


def _batch_inputs(batch, fused_input: bool, target_size, device):
    """(images, lungs, ems) float32 on ``device``, (B, D, H, W): the
    host-preprocessed ``image``, ``lung_mask`` and ``em_mask`` (``None``
    when the batch has none: eval batches), or with ``fused_input`` the
    raw padded ``image_raw``/``lung_raw`` of true extents ``in_sizes``
    through the fused preprocess (``steps.py:88-99``)."""
    if fused_input:
        pre = fused_preprocess(_as_tensor(batch["image_raw"], device),
                               _as_tensor(batch["lung_raw"], device),
                               _as_tensor(batch["in_sizes"], device),
                               target_size=tuple(target_size),
                               em_threshold=-950.0)
        return pre["image"], pre["lung_mask"], pre["em_mask"]
    ems = batch.get("em_mask")
    return (_as_tensor(batch["image"], device, torch.float32),
            _as_tensor(batch["lung_mask"], device, torch.float32),
            None if ems is None else _as_tensor(ems, device, torch.float32))


def _reg_heads(dense, regs, cle_labels, pse_labels, ems5, lungs5,
               cw_cle, cw_pse, num_data_shards: int):
    """The four reg losses (``steps.py:154-175``)."""
    cle_bands = generate_regression_labels(cle_labels, CLE_RATIO_MAP)
    pse_bands = generate_regression_labels(pse_labels, PSE_RATIO_MAP)
    loss_cle = interval_regression_loss(regs[0], cle_bands,
                                        cw_cle[cle_labels])
    loss_pse = interval_regression_loss(regs[1], pse_bands,
                                        cw_pse[pse_labels])
    binary = torch.logical_or(cle_labels > 0, pse_labels > 0)
    size = dense[0].shape[1:4]
    seg_labels = resize_nearest(
        ems5 * binary[:, None, None, None, None].float(), size, (1, 2, 3))
    lung_labels = resize_nearest(lungs5, size, (1, 2, 3))
    mul_loss, seg_loss = segmentation_losses(dense[0], dense[1], seg_labels,
                                             lung_labels)
    loss = (loss_cle + loss_pse) / num_data_shards + 2.0 * mul_loss \
        + seg_loss
    return {"loss": loss, "loss_cle": loss_cle, "loss_pse": loss_pse,
            "mul_loss": mul_loss, "seg_loss": seg_loss}


def _reg_losses(outs, inputs, cw_cle, cw_pse, num_data_shards: int):
    """dRAM: the four reg losses and the interval-lookup labels."""
    dense, regs = outs
    losses = _reg_heads(dense, regs, inputs["cle_labels"],
                        inputs["pse_labels"], inputs["ems5"],
                        inputs["lungs5"], cw_cle, cw_pse, num_data_shards)
    return losses, (ratio_to_label_batch(regs[0].detach(), CLE_RATIO_MAP),
                    ratio_to_label_batch(regs[1].detach(), PSE_RATIO_MAP))


def _cls_losses(outs, inputs, cw_cle, cw_pse, num_data_shards: int):
    """CLS (``steps.py:253-266``): weighted CE of the pooled logits, and
    their ``argmax``.  The JAX step does not divide by the data shards."""
    _, logits = outs
    loss_cle = weighted_cross_entropy(logits[0], inputs["cle_labels"], cw_cle)
    loss_pse = weighted_cross_entropy(logits[1], inputs["pse_labels"], cw_pse)
    return ({"loss": loss_cle + loss_pse, "loss_cle": loss_cle,
             "loss_pse": loss_pse},
            (logits[0].detach().argmax(-1), logits[1].detach().argmax(-1)))


def _raise_non_finite(named):
    """``FloatingPointError`` naming the first of the ``(name, tensor)``
    pairs that holds a NaN or an infinity (reads the values back)."""
    for name, t in named:
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"debug_nans: non-finite {name}")


def _make_train_step(losses_fn, model, optimizer, num_data_shards, augment,
                     accum_steps, compute_dtype, device, fused_input,
                     target_size, debug_nans=False):
    """The train step both strategies share: returns ``step(batch, lr,
    cle_class_weights, pse_class_weights, generator=None, mark=None) ->
    (metrics, preds)``.

    ``losses_fn(outs, inputs, cw_cle, cw_pse, num_data_shards) -> (losses,
    (pred_cle, pred_pse))`` turns the model's outputs into the losses, of
    which ``losses["loss"]`` is differentiated.  ``batch``: host arrays or
    tensors ``image``, ``lung_mask``, ``em_mask`` (B, D, H, W) or, with
    ``fused_input``, ``image_raw``, ``lung_raw`` (B, Dp, Hp, Wp) and
    ``in_sizes`` (B, 3), preprocessed to ``target_size`` on the device;
    and ``cls_label``/``pse_label`` (B,).  ``generator``: the
    augmentation's ``torch.Generator`` (on ``device``; needed when
    ``augment``): its seed and the global row index seed each row's draws
    (:func:`~..transforms.batch_augment.draw_augment_params`).
    ``mark(name)``, if given, is called as each phase begins
    (``preprocess`` with ``fused_input``, ``augment``, ``forward``,
    ``backward``, ``optimizer``) and with ``done`` at the end — a hook for
    timing.  ``debug_nans``: raise ``FloatingPointError`` naming the first
    non-finite loss (before the backward) or parameter gradient (after
    it); this reads values back from the device.  Under data parallelism
    ``model`` is the DDP module, each row's augmentation draws are those of
    its row of the global batch, and the losses are the global batch's
    (``losses/losses.py``).  ``metrics`` are the losses
    as detached scalar tensors (the mean over microbatches), ``preds`` the
    predicted and true labels of the whole batch."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def micro(batch, cw_cle, cw_pse, generator, mark, first_row, sync):
        if fused_input:
            mark("preprocess")
        images, lungs, ems = _batch_inputs(batch, fused_input, target_size,
                                           device)
        cle_labels = _as_tensor(batch["cls_label"], device, torch.long)
        pse_labels = _as_tensor(batch["pse_label"], device, torch.long)
        if augment:
            mark("augment")
            # the masks are only consumed at dense-map resolution (and not
            # at all by the CLS losses), so the augmentation emits them
            # there directly (never upsampling); the image does not depend
            # on it
            mask_out = dense_map_size(images.shape[1:4])
            if any(o > i for o, i in zip(mask_out, images.shape[1:4])):
                mask_out = None
            draws = draw_augment_params(generator, images.shape[0],
                                        tuple(images.shape[1:4]), first_row)
            images, lungs, ems = augment_batch(images, lungs, ems, draws,
                                               mask_out)
        mark("forward")
        slabs = spatial.can_shard(images.shape[2])
        if slabs:       # this rank's H slab of the whole-volume inputs
            images, lungs, ems = (spatial.shard_h(t, 2)
                                  for t in (images, lungs, ems))
        x = images[..., None].to(compute_dtype)
        inputs = {"lungs5": lungs[..., None], "ems5": ems[..., None],
                  "cle_labels": cle_labels, "pse_labels": pse_labels}
        # the backward too: remat recomputes the forward on the slabs
        with spatial.sharded(slabs), \
                (contextlib.nullcontext() if sync else model.no_sync()):
            outs = model(x, inputs["lungs5"])
            losses, (pred_cle, pred_pse) = losses_fn(outs, inputs, cw_cle,
                                                     cw_pse, num_data_shards)
            if debug_nans:
                _raise_non_finite(losses.items())
            mark("backward")
            try:
                losses["loss"].backward()
            except RuntimeError as exc:     # anomaly mode's NaN in a backward
                if debug_nans and "nan" in str(exc):
                    raise FloatingPointError(f"debug_nans: {exc}") from exc
                raise
        preds = {"pred_cle_labels": pred_cle, "pred_pse_labels": pred_pse,
                 "cle_labels": cle_labels.to(torch.int32),
                 "pse_labels": pse_labels.to(torch.int32)}
        return {k: v.detach() for k, v in losses.items()}, preds

    def step(batch: Dict, lr: float, cle_class_weights, pse_class_weights,
             generator: Optional[torch.Generator] = None,
             mark: Optional[Callable[[str], None]] = None):
        if augment and generator is None:
            raise ValueError("augment=True needs a torch.Generator")
        mark = mark or (lambda name: None)
        model.train()
        cw_cle = _as_tensor(cle_class_weights, device, torch.float32)
        cw_pse = _as_tensor(pse_class_weights, device, torch.float32)
        optimizer.zero_grad(set_to_none=True)
        b = len(batch["cls_label"])
        if b % accum_steps:
            raise ValueError(f"batch {b} must divide by accum_steps "
                             f"{accum_steps}")
        mb = b // accum_steps
        n_data, d = mesh().data, coords()[0]
        ddp = isinstance(model, torch.nn.parallel.DistributedDataParallel)
        # micro-batch i: global rows [i*G/a, (i+1)*G/a) of G = D*b, rank d
        # holding mb of them from row i*G/a + d*mb
        outs = [micro({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                      cw_cle, cw_pse, generator, mark,
                      i * n_data * mb + d * mb,
                      not ddp or i == accum_steps - 1)
                for i in range(accum_steps)]
        mark("optimizer")
        if debug_nans:
            _raise_non_finite((f"gradient of {n}", p.grad)
                              for n, p in model.named_parameters())
        if accum_steps > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        set_lr(optimizer, float(lr))
        optimizer.step()
        mark("done")
        metrics = {k: torch.stack([o[0][k] for o in outs]).mean()
                   for k in outs[0][0]}
        preds = {k: torch.cat([o[1][k] for o in outs]) for k in outs[0][1]}
        return metrics, preds

    return step


def make_reg_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        num_data_shards: int = 1, augment: bool = True,
                        accum_steps: int = 1,
                        compute_dtype: torch.dtype = torch.float32,
                        device=None, fused_input: bool = False,
                        target_size=(128, 224, 288), debug_nans=False):
    """The dRAM train step (:func:`_make_train_step`); ``metrics``:
    :data:`METRICS`."""
    return _make_train_step(_reg_losses, model, optimizer, num_data_shards,
                            augment, accum_steps, compute_dtype, device,
                            fused_input, target_size, debug_nans)


def make_cls_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        num_data_shards: int = 1, augment: bool = True,
                        accum_steps: int = 1,
                        compute_dtype: torch.dtype = torch.float32,
                        device=None, fused_input: bool = False,
                        target_size=(128, 224, 288), debug_nans=False):
    """The CLS train step (:func:`_make_train_step`, JAX
    ``steps.py:226-308``); ``metrics``: :data:`CLS_METRICS`."""
    return _make_train_step(_cls_losses, model, optimizer, num_data_shards,
                            augment, accum_steps, compute_dtype, device,
                            fused_input, target_size, debug_nans)


def make_eval_step(model: torch.nn.Module, mode: str = "reg",
                   compute_dtype: torch.dtype = torch.float32, device=None,
                   fused_input: bool = False, target_size=(128, 224, 288)):
    """Eval step (``steps.py:311-340``): ``step(batch) ->
    {pred_cle_labels, pred_pse_labels, cle_labels, pse_labels, dense_cle,
    dense_pse}``.  The batch holds host-preprocessed ``image`` and
    ``lung_mask`` or, with ``fused_input``, the raw padded volumes that
    the fused preprocess takes to ``target_size`` on the device.  Runs the
    eval forward (the model is put in ``.eval()``, so its eval kernels
    serve it); ``mode`` ``"reg"`` looks the lesion fractions up in the
    score intervals, ``"cls"`` takes the ``argmax`` of the pooled
    logits."""
    if mode not in ("reg", "cls"):
        raise ValueError(f"mode must be 'reg' or 'cls', not {mode!r}")
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            x, lungs, _ = _batch_inputs(batch, fused_input, target_size,
                                        device)
            dense, heads = spatial.forward_slabs(
                model, x[..., None].to(compute_dtype), lungs[..., None])
            if mode == "reg":
                pred_cle = ratio_to_label_batch(heads[0], CLE_RATIO_MAP)
                pred_pse = ratio_to_label_batch(heads[1], PSE_RATIO_MAP)
            else:
                pred_cle, pred_pse = heads[0].argmax(-1), heads[1].argmax(-1)
            return {
                "pred_cle_labels": pred_cle, "pred_pse_labels": pred_pse,
                "cle_labels": _as_tensor(batch["cls_label"], device,
                                         torch.int32),
                "pse_labels": _as_tensor(batch["pse_label"], device,
                                         torch.int32),
                "dense_cle": dense[0], "dense_pse": dense[1]}

    return step


def make_predict_step(model: torch.nn.Module, batch_lung_norm: bool = False,
                      compute_dtype: torch.dtype = torch.float32,
                      device=None):
    """Deployment predict step on host-preprocessed inputs
    (``steps.py:343-377``): ``step(images, lungs, ess, mark=None)`` on
    (B, D, H, W) arrays or tensors -> ``cle_dense_outs`` and
    ``pse_dense_outs`` (the full-resolution maps times ``ess``, (B, D, H,
    W) float32) and ``cle_precentages`` / ``pse_precentages`` ((B,); the
    JAX key names, typo included).  Both numerators are one kernel-F call
    on the two upsampled maps with ``ess`` as the mask.

    ``batch_lung_norm=False``: each sample divides by its own lung volume;
    ``True``: every sample divides by the whole batch's (the reference's
    strict parity at batch > 1).  ``mark(name)``, if given, is called as
    each phase begins (``forward``, ``reduction``), by the model with
    ``decoder`` between its trunk and its decoder, and with ``done`` at
    the end — a hook for timing."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def step(images, lungs, ess, mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda name: None)
        model.eval()
        with torch.inference_mode():
            x = _as_tensor(images, device, torch.float32)[..., None]
            lungs5 = _as_tensor(lungs, device, torch.float32)[..., None]
            ess5 = _as_tensor(ess, device, torch.float32)[..., None]
            mark("forward")
            dense, _ = spatial.forward_slabs(model, x.to(compute_dtype),
                                             lungs5, mark)
            mark("reduction")
            full = resize_linear_matmul(torch.cat(dense, -1), x.shape[1:4],
                                        (1, 2, 3), align_corners=True)
            num, _ = masked_sums(full, ess5)
            lung_sums = (torch.sum(lungs5) if batch_lung_norm else
                         torch.sum(lungs5, dim=(1, 2, 3, 4))[:, None])
            pct = num / lung_sums
            full = full * ess5
            out = {"cle_dense_outs": full[..., 0],
                   "pse_dense_outs": full[..., 1],
                   "cle_precentages": pct[:, 0], "pse_precentages": pct[:, 1]}
            mark("done")
            return out

    return step
