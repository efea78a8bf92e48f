"""Optimizer assembly: Adam with the per-epoch exponential decay.

Counterpart of ``bodyct_dram_emph_subtype_tpu/train/state.py``: the
reference's Adam (torch defaults b1=0.9, b2=0.999, eps=1e-8) with lr decayed
x0.95 per epoch (``models.py:685-698``).  ``torch.optim.Adam`` applies
``lr * m_hat / (sqrt(v_hat) + eps)``, the update of ``optax.scale_by_adam``
followed by ``-lr`` (``train/state.py:41-58``); the JAX package passes the
epoch's lr into its step, the port sets it in ``param_groups``.
"""
from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def epoch_lr(base_lr: float, epoch: int, gamma: float = 0.95) -> float:
    """torch ``ExponentialLR``: lr * gamma^epoch."""
    return base_lr * (gamma ** int(epoch))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
