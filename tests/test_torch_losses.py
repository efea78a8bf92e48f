"""Every loss of the port against the JAX package's, values and gradients.

Same numpy inputs on both sides, float32; values and gradients rtol 1e-6
(atol 1e-7 for gradient elements that are zero up to rounding).  The
sums here run over at most 2x2x3x4 elements: XLA on the CPU sums in
sequence, and its float32 error already reaches 1.3e-6 at 384.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data.datasets import (CLE_RATIO_MAP,
                                                        PSE_RATIO_MAP)
from bodyct_dram_emph_subtype_tpu.losses import losses as jl
from bodyct_dram_emph_subtype_tpu_torch.losses import losses as tl

RTOL, ATOL = 1e-6, 1e-7


def _grad_torch(fn, *arrays, wrt=0):
    ts = [torch.tensor(a, requires_grad=(i == wrt))
          if a.dtype == np.float32 else torch.tensor(a)
          for i, a in enumerate(arrays)]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), ts[wrt].grad.numpy()


def _grad_jax(fn, *arrays, wrt=0):
    args = [jnp.asarray(a) for a in arrays]
    with jax.default_matmul_precision("highest"):
        val, g = jax.value_and_grad(fn, argnums=wrt)(*args)
    return np.asarray(val), np.asarray(g)


def _check(fn_t, fn_j, *arrays, wrt=0):
    tv, tg = _grad_torch(fn_t, *arrays, wrt=wrt)
    jv, jg = _grad_jax(fn_j, *arrays, wrt=wrt)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


def test_weighted_cross_entropy():
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 6).astype(np.float32)
    labels = np.asarray([0, 3, 5, 3, 1], np.int64)
    w = (rng.rand(6) + 0.2).astype(np.float32)
    _check(tl.weighted_cross_entropy, jl.weighted_cross_entropy, logits,
           labels, w)


@pytest.mark.parametrize("ratio_map", [CLE_RATIO_MAP, PSE_RATIO_MAP])
def test_regression_labels_and_interval_loss(ratio_map):
    rng = np.random.RandomState(1)
    n = len(ratio_map)
    labels = np.arange(n, dtype=np.int64)
    bands_t = tl.generate_regression_labels(torch.from_numpy(labels),
                                            ratio_map)
    bands_j = jl.generate_regression_labels(jnp.asarray(labels), ratio_map)
    np.testing.assert_array_equal(bands_t.numpy(), np.asarray(bands_j))
    outs = rng.uniform(0.01, 0.6, n).astype(np.float32)
    w = (rng.rand(n) + 0.1).astype(np.float32)
    bands = np.asarray(bands_j)
    _check(tl.interval_regression_loss, jl.interval_regression_loss, outs,
           bands, w)


def test_dice_and_binary_dice():
    rng = np.random.RandomState(2)
    y = rng.rand(2, 2, 3, 4, 1).astype(np.float32)
    y_hat = rng.rand(2, 2, 3, 4, 1).astype(np.float32)
    _check(lambda a, b: tl.dice_coef(a, b, 1e-7),
           lambda a, b: jl.dice_coef(a, b, 1e-7), y, y_hat)
    _check(tl.binary_dice, jl.binary_dice, y, y_hat, wrt=1)


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("positives", [0.02, 0.6])
def test_masked_balanced_bce(with_mask, positives):
    """Includes the alpha-from-batch-size quirk: with few positives
    1 - sum(t)/B stays inside [0.3, 0.7] only for tiny sums."""
    rng = np.random.RandomState(3)
    t = (rng.rand(2, 2, 3, 4, 1) < positives).astype(np.float32)
    p = rng.rand(2, 2, 3, 4, 1).astype(np.float32)
    mask = (rng.rand(2, 2, 3, 4, 1) > 0.3).astype(np.float32)
    if with_mask:
        _check(lambda a, b, m: tl.masked_balanced_bce(a, b, m, 0.85),
               lambda a, b, m: jl.masked_balanced_bce(a, b, m, 0.85),
               t, p, mask, wrt=1)
    else:
        _check(tl.masked_balanced_bce, jl.masked_balanced_bce, t, p, wrt=1)


@pytest.mark.parametrize("wrt", [0, 1])
def test_segmentation_losses(wrt):
    rng = np.random.RandomState(4)
    cle = (rng.rand(2, 2, 3, 4, 1) * 0.5).astype(np.float32)
    pse = (rng.rand(2, 2, 3, 4, 1) * 0.5).astype(np.float32)
    ems = (rng.rand(2, 2, 3, 4, 1) > 0.7).astype(np.float32)
    lungs = (rng.rand(2, 2, 3, 4, 1) > 0.2).astype(np.float32)
    for i in range(2):
        _check(lambda *a: tl.segmentation_losses(*a)[i],
               lambda *a: jl.segmentation_losses(*a)[i],
               cle, pse, ems, lungs, wrt=wrt)


def test_ratio_to_label_batch():
    ratios = np.asarray([0.0, 0.0099, 0.01, 0.07, 0.15, 0.25, 0.31, 0.99,
                         1.0001, 1.5], np.float32)
    for m in (CLE_RATIO_MAP, PSE_RATIO_MAP):
        got = tl.ratio_to_label_batch(torch.from_numpy(ratios), m)
        want = jl.ratio_to_label_batch(jnp.asarray(ratios), m)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
