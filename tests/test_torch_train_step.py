"""One dRAM train step of the port against the JAX package's, on the CPU.

``med3ddramtiny`` in float32, B=2, input 16x24x32, augmentation off,
weights carried from JAX with ``state_dict_from_jax``; the JAX model is
built with ``packed_decoder=True`` (at this size its packed convs go to
XLA, the same maths as the roll kernels).  JAX runs under
``default_matmul_precision("highest")``.  Tolerances: the loss and its 4
components rtol 1e-5; every parameter gradient rtol 1e-4, atol 1e-6 plus
3e-3 of its peak (``GRAD_PEAK_ATOL``: the two frameworks sum the conv and BN
reductions in other orders); the
updated BatchNorm running statistics rtol 1e-5, which pins the biased
variance (torch's own ``F.batch_norm`` would store n/(n-1) of it, 2% at
layer4 here).  The coverage loss and the total hold rtol 5e-5: the JAX
reference's own float32 sum is off by 1.7e-5 there (``SEG_RTOL``).

The JAX step's gradients are read from a pass-through optax
transformation that stores them as its state (lr 0 leaves the params
alone); the port's are the parameters' ``.grad`` after a step at lr 0.
Adam is compared separately on identical gradients: right after the first
step ``m_hat/sqrt(v_hat) = g/|g|``, so post-step parameters would amplify
any gradient difference near zero to 2*lr.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.state import TrainState
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_reg_train_step as jax_reg_step
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, optimizer_state_from_jax, state_dict_from_jax)
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import \
    make_reg_train_step

SHAPE = (16, 24, 32)
# XLA on the CPU sums the coverage BCE's 3072 weights in float32 with an
# error of 1.7e-5 of the float64 sum (measured: 1898.768 vs 1898.800; the
# port's torch.sum agrees with float64 to 1e-7), so the coverage term and
# the total hold 5e-5; the other three components hold 1e-5
SEG_RTOL = 5e-5
# Gradients hold rtol 1e-4 with atol 1e-6 plus 3e-3 of the tensor's peak:
# train BN's backward subtracts batch means of the output gradient, and the
# float32 order noise of those sums (XLA sums sequentially, see above)
# survives the cancellation.  Measured: at most 2.1e-3 of the peak, on a
# few near-zero elements of the decoder conv weights (us2.conv0); 3e-3
# leaves a margin.  Every element still holds rtol 1e-4 or that bound.
GRAD_PEAK_ATOL = 3e-3
CW_CLE = np.asarray([0.2, 0.25, 0.15, 0.2, 0.1, 0.1], np.float32)
CW_PSE = np.asarray([0.3, 0.5, 0.2], np.float32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _to_torch_layout(arr):
    arr = np.asarray(arr, np.float32)
    return arr.transpose(4, 3, 0, 1, 2) if arr.ndim == 5 else arr


def _grad_keeper():
    """optax transformation whose update is the gradient and whose state
    is the last gradient."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def setup():
    model = jax_model("med3ddramtiny", packed_decoder=True)
    x0 = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(3),
                                                   x0, x0)))
    # the coverage BCE takes log(1 - clip(cle + pse)): with the He-init
    # heads the two maps are saturated or sum to about 1, where that log
    # turns float32 order noise (1e-6 relative after a few train-BN
    # layers) into 3e-5 of the loss.  Small head weights and a negative
    # head bias put both maps near 0.2, so the comparison sees the algorithm
    for i in range(2):
        fc = variables["params"][f"fc{i}"]
        fc["kernel"] = fc["kernel"] * np.float32(0.05)
        fc["bias"] = np.full_like(fc["bias"], -1.5)
    rng = np.random.RandomState(0)
    batch = {
        "image": rng.randn(2, *SHAPE).astype(np.float32),
        "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
        "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
        "cls_label": np.asarray([3, 0], np.int32),
        "pse_label": np.asarray([1, 2], np.int32),
    }
    return model, variables, batch


def _jax_step(model, variables, batch, accum_steps):
    tx = _grad_keeper()
    state = TrainState.create(variables, tx)
    step = jax_reg_step(model, tx, augment=False, accum_steps=accum_steps)
    with jax.default_matmul_precision("highest"):
        new_state, metrics, preds = step(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(0.0), jnp.asarray(CW_CLE), jnp.asarray(CW_PSE),
            jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new_state.opt_state),
            jax.tree.map(np.asarray, new_state.batch_stats),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, preds))


def _port_step(variables, batch, accum_steps):
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = make_optimizer(port.parameters())
    step = make_reg_train_step(port, opt, augment=False,
                               accum_steps=accum_steps)
    metrics, preds = step(batch, 0.0, CW_CLE, CW_PSE)
    return port, {k: float(v) for k, v in metrics.items()}, preds


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(setup, accum_steps):
    """Loss + components, every gradient, the BN running statistics and
    the predicted labels of one step (``accum_steps=2``: the JAX
    ``step_accum``)."""
    model, variables, batch = setup
    j_grads, j_stats, j_metrics, j_preds = _jax_step(model, variables, batch,
                                                     accum_steps)
    port, metrics, preds = _port_step(variables, batch, accum_steps)
    assert set(metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(metrics[k], j_metrics[k],
                                   rtol=SEG_RTOL if k in ("seg_loss", "loss")
                                   else 1e-5, err_msg=k)
    params = dict(port.named_parameters())
    flat = _flat(j_grads)
    assert len(flat) == len(params)
    for path, g in flat.items():
        key = flax_path_to_torch_key("params", path)
        g = _to_torch_layout(g)
        np.testing.assert_allclose(
            params[key].grad.numpy(), g, rtol=1e-4,
            atol=1e-6 + GRAD_PEAK_ATOL * np.abs(g).max(), err_msg=key)
    buffers = dict(port.named_buffers())
    for path, v in _flat(j_stats).items():
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
              "pse_labels"):
        np.testing.assert_array_equal(preds[k].numpy(), j_preds[k])


def test_batch_norm_train_matches_flax():
    """The port's train BN against flax ``nn.BatchNorm`` (momentum 0.9) at
    n = 48 voxels: output, running mean and the BIASED running variance
    (the unbiased one differs by 2% here)."""
    from flax import linen as fnn
    from bodyct_dram_emph_subtype_tpu_torch.models.blocks import \
        batch_norm_train
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 2, 3, 4, 8) * 2 + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(rng.rand(8) + 0.5, jnp.float32),
                    "bias": jnp.asarray(rng.randn(8), jnp.float32)},
         "batch_stats": v["batch_stats"]}
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tbn = torch.nn.BatchNorm3d(8)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        tbn.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
    got = batch_norm_train(torch.from_numpy(x), tbn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 8).var(0, ddof=1)
    assert np.all(np.abs(tbn.running_var.numpy() - unbiased)
                  > 1e-3 * unbiased)


def test_adam_matches_optax_over_three_steps():
    """torch.optim.Adam at lr == optax.scale_by_adam followed by -lr, over
    three steps on the same gradients."""
    rng = np.random.RandomState(1)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) * s for s in (1.0, 0.1, 3.0)]
    lr = 1e-3
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], lr=lr)
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda v: -lr * v, u))
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)


def test_optimizer_state_from_jax_round_trips(setup):
    """optax Adam state after a JAX step -> the port's Adam: step count,
    first and second moments equal; one further step on the same
    gradients then matches optax."""
    model, variables, batch = setup
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    state = TrainState.create(variables, tx)
    step = jax_reg_step(model, tx, augment=False)
    with jax.default_matmul_precision("highest"):
        new_state, _, _ = step(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(1e-3), jnp.asarray(CW_CLE), jnp.asarray(CW_PSE),
            jax.random.PRNGKey(0))
    adam = new_state.opt_state
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, new_state.params),
         "batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)}))
    opt = make_optimizer(port.parameters(), lr=1e-3)
    opt.load_state_dict({"state": optimizer_state_from_jax(adam, port),
                         "param_groups": opt.state_dict()["param_groups"]})
    params = list(port.parameters())
    names = {id(p): n for n, p in port.named_parameters()}
    mu, nu = _flat(jax.tree.map(np.asarray, adam.mu)), \
        _flat(jax.tree.map(np.asarray, adam.nu))
    by_key = {flax_path_to_torch_key("params", k): k for k in mu}
    for p in params:
        s = opt.state[p]
        path = by_key[names[id(p)]]
        assert float(s["step"]) == int(adam.count)
        np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                      _to_torch_layout(mu[path]))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                      _to_torch_layout(nu[path]))
    # one more Adam step on identical gradients
    rng = np.random.RandomState(2)
    g_np = {k: rng.randn(*v.shape).astype(np.float32) for k, v in mu.items()}
    u, _ = tx.update(jax.tree.map(jnp.asarray, _unflat(g_np)), adam,
                     new_state.params)
    want = optax.apply_updates(new_state.params,
                               jax.tree.map(lambda v: -1e-3 * v, u))
    for p in params:
        p.grad = torch.from_numpy(_to_torch_layout(g_np[by_key[names[id(p)]]])
                                  .copy())
    opt.step()
    # optax's second-step bias correction 1 - 0.999**2 cancels in float32
    # (3e-5 relative; torch takes it in float64), so the update holds 5e-5
    # of lr
    for path, w in _flat(jax.tree.map(np.asarray, want)).items():
        key = flax_path_to_torch_key("params", path)
        np.testing.assert_allclose(dict(port.named_parameters())[key]
                                   .detach().numpy(), _to_torch_layout(w),
                                   rtol=1e-6, atol=5e-5 * 1e-3, err_msg=key)


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out
