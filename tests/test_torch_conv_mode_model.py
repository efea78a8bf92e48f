"""The port's model under the conv modes ``pallas``, ``tapmm`` and ``flat``
(plain versions on the CPU) against the JAX model under the same mode, its
Pallas kernels in interpret mode and its matmuls at ``highest`` precision.

- Eval forward of ``med3ddramtiny`` in each mode, float32, both dense maps
  and both lesion fractions within rtol 1e-4 / atol 1e-5, the unpacked
  decoder (the JAX trainer's default) and, in mode ``pallas``, the packed
  one (the bf16 processor's).  The ``tapmm`` input is 96 wide: its JAX
  gate refuses rows narrower than 24.  Each forward's conv-mode kernel
  calls equal the JAX package's, site for site (``mode_conv_sites``).
- One train step in mode ``pallas`` (the unpacked decoder): loss, every
  gradient and the BN running statistics within the bounds of
  ``tests/test_torch_train_step.py``.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.ops import flat_conv as jfc
from bodyct_dram_emph_subtype_tpu.ops import pallas_conv as jpc
from bodyct_dram_emph_subtype_tpu.ops import tap_conv as jtc
from bodyct_dram_emph_subtype_tpu.train.state import TrainState
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_reg_train_step as jax_reg_step
from bodyct_dram_emph_subtype_tpu_torch.models import blocks as tblocks
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import \
    mode_conv_sites
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, state_dict_from_jax)
from bodyct_dram_emph_subtype_tpu_torch.ops import roll_conv as trc
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import \
    make_reg_train_step
from test_torch_train_step import (CW_CLE, CW_PSE, GRAD_PEAK_ATOL, SEG_RTOL,
                                   _flat, _grad_keeper, _to_torch_layout)

IMPLS = ((jpc, "_pallas_conv3d_impl", "pallas_conv3d"),
         (jtc, "_tap_conv3d_impl", "tap_conv3d"),
         (jfc, "_flat_conv_impl", "flat_conv3d"))


@pytest.fixture
def mode_calls(monkeypatch):
    """Set both packages' conv mode with ``set_mode(mode)``; returns the
    recorded (op, input shape) calls of the JAX kernels and of the port's
    conv-mode Function."""
    calls = {"jax": [], "port": []}
    for mod, name, op in IMPLS:
        impl = getattr(mod, name)

        def rec(x, kernel, *args, _impl=impl, _op=op, **kw):
            calls["jax"].append((_op, tuple(x.shape)))
            return _impl(x, kernel, *args, **kw)

        monkeypatch.setattr(mod, name, rec)
    apply = trc._IdentityConv3d.apply

    def rec_port(x, kernel, dilation, op):
        calls["port"].append((op, tblocks.jax_conv_shape(x.shape, dilation)))
        return apply(x, kernel, dilation, op)

    monkeypatch.setattr(trc._IdentityConv3d, "apply", rec_port)
    before = tblocks.get_conv3d_mode()

    def set_mode(mode):
        monkeypatch.setattr(jblocks, "_CONV3D_MODE", mode)
        tblocks.set_conv3d_mode(mode)

    yield set_mode, calls
    tblocks.set_conv3d_mode(before)


def _data(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *shape, 1).astype(np.float32)
    lung = (rng.rand(1, *shape, 1) > 0.3).astype(np.float32)
    return x, lung


@pytest.mark.parametrize("mode,packed,shape", [
    ("pallas", False, (16, 32, 32)), ("pallas", True, (16, 32, 32)),
    ("tapmm", False, (16, 32, 96)), ("flat", False, (16, 32, 32))])
def test_tiny_forward_matches_jax_in_conv_mode(mode_calls, mode, packed,
                                               shape):
    set_mode, calls = mode_calls
    x, lung = _data(shape, 0)
    model = jax_model("med3ddramtiny", packed_decoder=packed)
    xj, lj = jnp.asarray(x), jnp.asarray(lung)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), xj, lj))
    set_mode(mode)
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        dense, regs = jax.jit(functools.partial(model.apply, train=False))(
            variables, xj, lj)
    port = get_model_by_name("med3ddramtiny", packed_decoder=packed)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        tdense, tregs = port(torch.from_numpy(x), torch.from_numpy(lung))
    for got, want in zip(list(tdense) + list(tregs), list(dense) + list(regs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    sites = mode_conv_sites(port, mode, 1, shape, torch.float32)
    assert sites and len(calls["jax"]) == len(sites)
    assert collections.Counter(calls["port"]) \
        == collections.Counter(calls["jax"])


SHAPE = (16, 24, 32)


def test_train_step_matches_jax_in_pallas_mode(mode_calls):
    """One med3ddramtiny step (B=2, float32, augmentation off, unpacked
    decoder) in mode ``pallas``: the kernel-A forward sites with the
    cuDNN-style backward against JAX's Pallas forward + XLA backward."""
    set_mode, calls = mode_calls
    model = jax_model("med3ddramtiny")
    x0 = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(3),
                                                   x0, x0)))
    for i in range(2):      # keep the maps off the coverage loss's clip
        fc = variables["params"][f"fc{i}"]
        fc["kernel"] = fc["kernel"] * np.float32(0.05)
        fc["bias"] = np.full_like(fc["bias"], -1.5)
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(2, *SHAPE).astype(np.float32),
             "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
             "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
             "cls_label": np.asarray([3, 0], np.int32),
             "pse_label": np.asarray([1, 2], np.int32)}
    set_mode("pallas")
    tx = _grad_keeper()
    state = TrainState.create(variables, tx)
    step = jax_reg_step(model, tx, augment=False)
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        new_state, j_metrics, _ = step(
            state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(0.0), jnp.asarray(CW_CLE), jnp.asarray(CW_PSE),
            jax.random.PRNGKey(0))
    j_grads = _flat(jax.tree.map(np.asarray, new_state.opt_state))
    j_stats = _flat(jax.tree.map(np.asarray, new_state.batch_stats))

    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = make_optimizer(port.parameters())
    metrics, _ = make_reg_train_step(port, opt, augment=False)(
        batch, 0.0, CW_CLE, CW_PSE)
    sites = mode_conv_sites(port, "pallas", 2, SHAPE, torch.float32)
    assert len(calls["port"]) == len(sites) > 0
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=SEG_RTOL if k in ("seg_loss", "loss")
                                   else 1e-5, err_msg=k)
    params = dict(port.named_parameters())
    assert len(j_grads) == len(params)
    for path, g in j_grads.items():
        key = flax_path_to_torch_key("params", path)
        g = _to_torch_layout(g)
        np.testing.assert_allclose(
            params[key].grad.numpy(), g, rtol=1e-4,
            atol=1e-6 + GRAD_PEAK_ATOL * np.abs(g).max(), err_msg=key)
    buffers = dict(port.named_buffers())
    for path, v in j_stats.items():
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
