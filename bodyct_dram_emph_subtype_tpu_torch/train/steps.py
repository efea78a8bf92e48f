"""The dRAM (regression) train step and the eval step.

Counterpart of ``bodyct_dram_emph_subtype_tpu/train/steps.py``'s
``make_reg_train_step`` and ``make_eval_step`` (reference
``models.py:539-592``, the TRAIN and VAL/TEST branches of ``shared_step``):

- train: on-device augmentation -> train-mode forward (BatchNorm batch
  statistics) -> the four reg losses ``(cle + pse) / num_data_shards +
  2 * mutex_dice + coverage_bce`` -> backward -> one Adam update;
- ``accum_steps > 1``: the batch splits into microbatches run one after
  the other, gradients averaged, BatchNorm running statistics chained
  through them, one Adam update (``steps.py:196-221``);
- eval: eval forward (kernels A, B and C) + predicted labels.

The JAX step is one jitted program; the port runs eagerly.  Augmentation
draws its random numbers from the ``torch.Generator`` it is handed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import CLE_RATIO_MAP, PSE_RATIO_MAP
from ..losses import (generate_regression_labels, interval_regression_loss,
                      ratio_to_label_batch, segmentation_losses)
from ..ops.resize import resize_nearest
from ..transforms.batch_augment import augment_batch, draw_augment_params
from .state import set_lr

METRICS = ("loss", "loss_cle", "loss_pse", "mul_loss", "seg_loss")


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


def make_reg_train_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        num_data_shards: int = 1, augment: bool = True,
                        accum_steps: int = 1,
                        compute_dtype: torch.dtype = torch.float32,
                        device=None):
    """Returns ``step(batch, lr, cle_class_weights, pse_class_weights,
    generator=None, mark=None) -> (metrics, preds)``.

    ``batch``: host arrays or tensors ``image``, ``lung_mask``, ``em_mask``
    (B, D, H, W) and ``cls_label``/``pse_label`` (B,).  ``generator``: the
    augmentation's ``torch.Generator`` (on ``device``; needed when
    ``augment``).  ``mark(name)``, if given, is called as each phase
    begins (``augment``, ``forward``, ``backward``, ``optimizer``) and with
    ``done`` at the end — a hook for timing.  ``metrics`` are detached
    scalar tensors (the mean over microbatches), ``preds`` the predicted
    and true labels of the whole batch."""
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def micro(batch, cw_cle, cw_pse, generator, mark):
        images = _as_tensor(batch["image"], device, torch.float32)
        lungs = _as_tensor(batch["lung_mask"], device, torch.float32)
        ems = _as_tensor(batch["em_mask"], device, torch.float32)
        cle_labels = _as_tensor(batch["cls_label"], device, torch.long)
        pse_labels = _as_tensor(batch["pse_label"], device, torch.long)
        if augment:
            mark("augment")
            # the masks are only consumed at dense-map resolution, so the
            # augmentation emits them there directly (never upsampling)
            mask_out = dense_map_size(images.shape[1:4])
            if any(o > i for o, i in zip(mask_out, images.shape[1:4])):
                mask_out = None
            draws = draw_augment_params(generator, images.shape[0],
                                        tuple(images.shape[1:4]))
            images, lungs, ems = augment_batch(images, lungs, ems, draws,
                                               mask_out)
        mark("forward")
        x = images[..., None].to(compute_dtype)
        lungs5, ems5 = lungs[..., None], ems[..., None]
        dense, regs = model(x, lungs5)
        losses = _reg_heads(dense, regs, cle_labels, pse_labels, ems5,
                            lungs5, cw_cle, cw_pse, num_data_shards)
        mark("backward")
        losses["loss"].backward()
        with torch.no_grad():
            preds = {"pred_cle_labels": ratio_to_label_batch(regs[0].detach(),
                                                             CLE_RATIO_MAP),
                     "pred_pse_labels": ratio_to_label_batch(regs[1].detach(),
                                                             PSE_RATIO_MAP),
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
        outs = [micro({k: batch[k][i * mb:(i + 1) * mb] for k in
                       ("image", "lung_mask", "em_mask", "cls_label",
                        "pse_label")}, cw_cle, cw_pse, generator, mark)
                for i in range(accum_steps)]
        mark("optimizer")
        if accum_steps > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        set_lr(optimizer, float(lr))
        optimizer.step()
        mark("done")
        metrics = {k: torch.stack([o[0][k] for o in outs]).mean()
                   for k in METRICS}
        preds = {k: torch.cat([o[1][k] for o in outs]) for k in outs[0][1]}
        return metrics, preds

    return step


def make_eval_step(model: torch.nn.Module, mode: str = "reg",
                   compute_dtype: torch.dtype = torch.float32, device=None):
    """Eval step on host-preprocessed inputs (``steps.py:311-340``):
    ``step(batch) -> {pred_cle_labels, pred_pse_labels, cle_labels,
    pse_labels, dense_cle, dense_pse}``.  Runs the eval forward (the
    model is put in ``.eval()``, so kernels A, B and C serve it)."""
    if mode != "reg":
        raise NotImplementedError(
            "the CLS strategy needs ResNetSegCls, which is not ported yet "
            "(ROADMAP section 1, 'ResNetSegCls and ResNet')")
    device = torch.device(device) if device is not None else \
        next(model.parameters()).device

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            x = _as_tensor(batch["image"], device, torch.float32)
            lungs = _as_tensor(batch["lung_mask"], device, torch.float32)
            dense, regs = model(x[..., None].to(compute_dtype),
                                lungs[..., None])
            return {
                "pred_cle_labels": ratio_to_label_batch(regs[0],
                                                        CLE_RATIO_MAP),
                "pred_pse_labels": ratio_to_label_batch(regs[1],
                                                        PSE_RATIO_MAP),
                "cle_labels": _as_tensor(batch["cls_label"], device,
                                         torch.int32),
                "pse_labels": _as_tensor(batch["pse_label"], device,
                                         torch.int32),
                "dense_cle": dense[0], "dense_pse": dense[1]}

    return step
