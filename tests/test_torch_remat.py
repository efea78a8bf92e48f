"""Activation checkpointing (``remat``) of the port against the JAX
package's, on the CPU.

- ``remat_scopes`` equals JAX ``models/resnet3d.py::remat_scopes``.
- One train step of ``med3ddramtiny`` (float32, B=2, 16x24x32, packed
  decoder, augmentation off) under ``remat`` "all", "layer1,layer2,decoder"
  and "none" against the same step without remat: the loss and its
  components, every gradient and every BatchNorm buffer bit-equal (eager
  recompute on the CPU runs the same ops in the same order), each running
  statistic updated once (``num_batches_tracked`` 1), and the backward
  recomputing the ``roll_conv_packed`` forwards that
  ``train_remat_sites`` names (counted at the kernel-A wrapper's plain
  version).  The same for the CLS step of ``med3dtiny``.
- Port ``remat="all"`` against the JAX step built with ``remat="all"`` on
  carried-over weights, in ``test_torch_train_step.py``'s bounds.
- The eval forward ignores ``remat``: bit-equal, nothing checkpointed.
- ``train_roll_launches(sites, remat)`` against the JAX train step's
  kernel sites at the deployment shape (B=2, 128x224x288, bf16, conv mode
  ``roll``): the ``pallas_call`` equations of ``jax.make_jaxpr`` of the
  gradient, recompute included, counted in the program and in its
  sub-programs (abstract: no FLOP runs).  JAX runs the recompute inside
  its ``jax.checkpoint`` program, so Python recorders around the kernels
  would not see it.
"""
import collections
import functools

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    remat_scopes as jax_remat_scopes
from bodyct_dram_emph_subtype_tpu.parallel import mesh as jmesh
from bodyct_dram_emph_subtype_tpu_torch.models import blocks
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import (BasicBlock,
                                                              Bottleneck)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    TRAIN_ROLL_SITES, remat_scopes, train_remat_sites, train_roll_launches,
    train_roll_sites)
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, state_dict_from_jax)
from bodyct_dram_emph_subtype_tpu_torch.ops import roll_conv
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
    make_cls_train_step, make_reg_train_step)
from tests.test_torch_routing import _jax_refused
from tests.test_torch_train_step import (CW_CLE, CW_PSE, GRAD_PEAK_ATOL,
                                         SEG_RTOL, _flat, _jax_step,
                                         _to_torch_layout)

SHAPE = (16, 24, 32)
REMATS = ["all", "layer1,layer2,decoder", "none"]


@pytest.mark.parametrize("remat", [True, False, None, "all", "none",
                                   " layer1 , decoder", "layer3,layer4"])
def test_remat_scopes_equal_jax(remat):
    assert remat_scopes(remat) == jax_remat_scopes(remat)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(2, *SHAPE).astype(np.float32),
        "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
        "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
        "cls_label": np.asarray([3, 0], np.int32),
        "pse_label": np.asarray([1, 2], np.int32),
    }


class _Counting:
    """Counts the calls of ``roll_conv._identity_a`` (the kernel-A
    forward of ``roll_conv_packed``) and of ``blocks.checkpointed``."""

    def __init__(self, monkeypatch):
        self.a = self.checkpointed = 0
        identity_a, checkpointed = roll_conv._identity_a, blocks.checkpointed

        def count_a(*args, **kw):
            self.a += 1
            return identity_a(*args, **kw)

        def count_checkpointed(*args, **kw):
            self.checkpointed += 1
            return checkpointed(*args, **kw)

        monkeypatch.setattr(roll_conv, "_identity_a", count_a)
        from bodyct_dram_emph_subtype_tpu_torch.models import resnet3d
        monkeypatch.setattr(resnet3d, "checkpointed", count_checkpointed)


def _port_step(arch, remat, batch, state=None):
    model = get_model_by_name(arch, packed_decoder=True, remat=remat)
    if state is not None:
        model.load_state_dict(state, strict=True)
    make = make_reg_train_step if "dram" in arch else make_cls_train_step
    step = make(model, make_optimizer(model.parameters()), augment=False)
    metrics, preds = step(batch, 0.0, CW_CLE, CW_PSE)
    return model, metrics, preds


@pytest.mark.parametrize("arch", ["med3ddramtiny", "med3dtiny"])
@pytest.mark.parametrize("remat", REMATS)
def test_remat_step_is_bit_equal_to_no_remat(monkeypatch, arch, remat):
    batch = _batch()
    want_model, want_metrics, want_preds = _port_step(arch, None, batch)
    count = _Counting(monkeypatch)
    model, metrics, preds = _port_step(arch, remat, batch)
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        assert torch.equal(metrics[k], v), k
    for k, v in want_preds.items():
        assert torch.equal(preds[k], v), k
    want_params = dict(want_model.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, want_params[n].grad), n
    want_buffers = dict(want_model.named_buffers())
    for n, b in model.named_buffers():
        assert torch.equal(b, want_buffers[n]), n
        if n.endswith("num_batches_tracked"):
            assert int(b) == 1, n          # updated once, not again
    sites = train_roll_sites((1, 1, 1, 1), BasicBlock, packed_decoder=True)
    recomputed = train_remat_sites(sites, remat)
    assert count.a == len(sites) + len(recomputed)
    # one checkpoint per block of each named layer and per us1/us2 stage
    scopes = remat_scopes(remat)
    assert count.checkpointed == len(scopes - {"decoder"}) \
        + 2 * ("decoder" in scopes)


def test_remat_all_matches_jax_remat_all():
    """``remat="all"`` on both sides, ``test_torch_train_step.py``'s
    weights, batch and bounds."""
    model = jax_model("med3ddramtiny", packed_decoder=True, remat="all")
    x0 = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(3),
                                                   x0, x0)))
    for i in range(2):
        fc = variables["params"][f"fc{i}"]
        fc["kernel"] = fc["kernel"] * np.float32(0.05)
        fc["bias"] = np.full_like(fc["bias"], -1.5)
    batch = _batch()
    j_grads, j_stats, j_metrics, j_preds = _jax_step(model, variables,
                                                     batch, 1)
    port, metrics, preds = _port_step("med3ddramtiny", "all", batch,
                                      state_dict_from_jax(variables))
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v,
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
    for k in ("pred_cle_labels", "pred_pse_labels"):
        np.testing.assert_array_equal(preds[k].numpy(), j_preds[k])


@pytest.mark.parametrize("arch", ["med3ddramtiny", "med3dtiny"])
def test_eval_forward_ignores_remat(monkeypatch, arch):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, *SHAPE, 1).astype(np.float32))
    lungs = torch.from_numpy((rng.rand(2, 8, 12, 16, 1) > 0.3)
                             .astype(np.float32))
    want = get_model_by_name(arch, packed_decoder=True)(x, lungs)
    count = _Counting(monkeypatch)
    got = get_model_by_name(arch, packed_decoder=True, remat="all")(x, lungs)
    for a, b in zip(want, got):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    assert count.checkpointed == 0


# ---- the launch counts against the JAX train step's kernel sites ----

B, SIZE = 2, (128, 224, 288)
ARCHS = {"med3ddram": ((3, 4, 6, 3), BasicBlock),
         "med3ddram50": ((3, 4, 6, 3), Bottleneck)}


def _pallas_calls(jaxpr, counts):
    """Count the ``pallas_call`` equations of ``jaxpr`` and of its
    sub-programs by their first output's leading dimension: B for the
    activation-shaped roll-conv forward, recompute and dgrad, 3 for the
    weight gradient."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            lead = eqn.params["out_avals"][0].shape[0]
            counts["impl" if lead == B else "wgrad"] += 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    _pallas_calls(sub.jaxpr, counts)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    _pallas_calls(sub, counts)
    return counts


@pytest.mark.parametrize("arch,remat", [("med3ddram", "all"),
                                        ("med3ddram", "layer3,layer4"),
                                        ("med3ddram50", "all")])
def test_remat_launches_equal_the_jax_kernel_sites(monkeypatch, arch, remat):
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "roll")
    monkeypatch.setattr(jmesh, "_ACTIVE_MESH", None)
    model = jax_model(arch, dtype=jnp.bfloat16, packed_decoder=True,
                      remat=remat)
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    variables = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, a, train=False), x)

    def loss(params, stats, a):
        (dense, regs), _ = model.apply(
            {"params": params, "batch_stats": stats}, a, a, train=True,
            mutable=["batch_stats"])
        return sum(jnp.sum(d) for d in dense) + sum(jnp.sum(r) for r in regs)

    program = jax.make_jaxpr(jax.grad(loss))(variables["params"],
                                             variables["batch_stats"], x)
    got = _pallas_calls(program.jaxpr, collections.Counter())
    layers, block = ARCHS[arch]
    sites = train_roll_sites(layers, block, packed_decoder=True)
    # the port's kernels take med3ddram50's C = 2304 us1.conv0, which the
    # JAX VMEM budget sends to XLA (test_torch_routing.py)
    refused = set(_jax_refused(arch, True))
    kept = tuple(s for s in sites if s[0] not in refused)
    launches = train_roll_launches(kept, remat)
    assert got["impl"] == launches["conv3x3x3_affine"]
    # us3's weight gradient stays on XLA in JAX; kernel D takes it
    assert got["wgrad"] == launches["conv3x3x3_wgrad"] - 1
    want = {("med3ddram", "all"): (32, 11), ("med3ddram", "layer3,layer4"):
            (22, 11), ("med3ddram50", "all"): (14, 5)}[arch, remat]
    full = train_roll_launches(sites, remat)
    assert (full["conv3x3x3_affine"], full["conv3x3x3_wgrad"]) == want


def test_remat_sites_of_the_unpacked_decoder():
    sites = train_roll_sites(packed_decoder=False)
    assert train_remat_sites(sites, "all") == sites
    assert train_remat_sites(sites, "decoder") == ()
    assert train_roll_launches(sites, "all")["conv3x3x3_affine"] == 18
    assert train_remat_sites(TRAIN_ROLL_SITES, "decoder") == tuple(
        s for s in TRAIN_ROLL_SITES if s[0].startswith(("us1", "us2")))
