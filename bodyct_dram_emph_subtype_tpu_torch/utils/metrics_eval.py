"""Host-side evaluation metrics: accuracy, macro-F1, linearly-weighted kappa.

The reference logs only accuracy from code (``models.py:315-316``); its
README reports F1 and linearly-weighted Cohen's kappa (``README.md:35-38``),
computed offline.  All three are computed at epoch end so BASELINE.md's
numbers are directly comparable from the training logs.  Numpy-only copy of
``bodyct_dram_emph_subtype_tpu/utils/metrics_eval.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def confusion(y_true, y_pred, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(np.asarray(y_true).astype(int),
                    np.asarray(y_pred).astype(int)):
        cm[t, p] += 1
    return cm


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    return float((y_true == np.asarray(y_pred)).mean()) if len(y_true) else 0.0


def macro_f1(y_true, y_pred, n_classes: int) -> float:
    cm = confusion(y_true, y_pred, n_classes)
    f1s = []
    for c in range(n_classes):
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c].sum() - tp
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s))


def weighted_kappa(y_true, y_pred, n_classes: int,
                   weights: str = "linear") -> float:
    """Cohen's kappa with linear (or quadratic) disagreement weights."""
    cm = confusion(y_true, y_pred, n_classes).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    i = np.arange(n_classes)
    diff = np.abs(i[:, None] - i[None, :]).astype(np.float64)
    w = diff if weights == "linear" else diff ** 2
    expected = np.outer(cm.sum(axis=1), cm.sum(axis=0)) / n
    denom = (w * expected).sum()
    if denom == 0:
        return 0.0
    return float(1.0 - (w * cm).sum() / denom)


def classification_report(y_true, y_pred, n_classes: int,
                          prefix: str = "") -> Dict[str, float]:
    return {
        f"{prefix}acc": accuracy(y_true, y_pred),
        f"{prefix}f1": macro_f1(y_true, y_pred, n_classes),
        f"{prefix}kappa_linear": weighted_kappa(y_true, y_pred, n_classes),
    }
