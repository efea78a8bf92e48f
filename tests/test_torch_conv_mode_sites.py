"""Where the JAX package's conv modes and quad stem put their Pallas kernels
at the deployment shape, against the port's site lists.

The JAX ``med3ddram`` is traced abstractly (``jax.eval_shape``: no FLOP
runs) at B=2, 128x224x288, bf16, with recorders around ``pl.pallas_call``
(every kernel site, by kernel module) and around the three conv-mode
kernels (input and kernel shapes).  Expected, per forward:

- ``pallas``: 26 sites with the packed decoder (the bf16 processor), 31
  with the unpacked one (the trainer's default);
- ``tapmm``: 13 / 18;
- ``flat``: 18 either way (layer3/4 only);
- ``roll``: 7; ``roll`` with the quad stem: 8 (kernel 9 + layer1 through
  ``fused_layer1``).

The port's :func:`mode_conv_sites` must list exactly the JAX conv-mode
sites (the dilated layers' as subgrid shapes), and :func:`roll_eval_sites`
the roll sites.  The train step (bf16, unpacked decoder, ``jax.grad``)
has 31 / 18 / 18 sites, all in the forward: the custom VJPs run their
backward on XLA.
"""
import collections

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import experimental as jexp
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.ops import flat_conv as jfc
from bodyct_dram_emph_subtype_tpu.ops import pallas_conv as jpc
from bodyct_dram_emph_subtype_tpu.ops import tap_conv as jtc
from bodyct_dram_emph_subtype_tpu.parallel import mesh as jmesh
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import jax_conv_shape
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    mode_conv_sites, roll_eval_sites)

B, SIZE = 2, (128, 224, 288)
MODULES = {"pallas": "pallas_conv", "tapmm": "tap_conv", "flat": "flat_conv"}


@pytest.fixture(scope="module")
def variables():
    model = jax_model("med3ddram", dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    return jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, a, train=False), x)


def _trace(monkeypatch, variables, mode, packed, train=False, quad=False):
    """(kernel modules of every pallas_call, [(op, x shape, kernel shape)]
    of the conv-mode kernels) of one abstract JAX forward (or, with
    ``train``, one gradient of the train forward)."""
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", mode)
    monkeypatch.setattr(jmesh, "_ACTIVE_MESH", None)
    monkeypatch.setattr(jexp, "_QUAD_STEM_ENABLE", quad)
    sites, convs = [], []
    call = pl.pallas_call

    def rec_call(body, *args, **kw):
        sites.append(getattr(body, "func", body).__module__.rsplit(".")[-1])
        return call(body, *args, **kw)

    monkeypatch.setattr(pl, "pallas_call", rec_call)
    for mod, name, op in ((jpc, "_pallas_conv3d_impl", "pallas_conv3d"),
                          (jtc, "_tap_conv3d_impl", "tap_conv3d"),
                          (jfc, "_flat_conv_impl", "flat_conv3d")):
        impl = getattr(mod, name)

        def rec(x, kernel, *args, _impl=impl, _op=op, **kw):
            convs.append((_op, tuple(x.shape), tuple(kernel.shape)))
            return _impl(x, kernel, *args, **kw)

        monkeypatch.setattr(mod, name, rec)
    model = jax_model("med3ddram", dtype=jnp.bfloat16,
                      packed_decoder=packed, remat="none")
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    if not train:
        jax.eval_shape(lambda v, a: model.apply(v, a, a, train=False),
                       variables, x)
        return sites, convs

    def loss(params, stats, a):
        (dense, regs), _ = model.apply(
            {"params": params, "batch_stats": stats}, a, a, train=True,
            mutable=["batch_stats"])
        return sum(jnp.sum(d) for d in dense) + sum(jnp.sum(r) for r in regs)

    jax.eval_shape(jax.grad(loss), variables["params"],
                   variables["batch_stats"], x)
    return sites, convs


def _port_sites(mode, packed):
    model = get_model_by_name("med3ddram", packed_decoder=packed)
    return [(op, jax_conv_shape(shape, d), k) for _, shape, k, d, op in
            mode_conv_sites(model, mode, B, SIZE, torch.bfloat16)]


@pytest.mark.parametrize("mode,packed,n", [
    ("pallas", True, 26), ("pallas", False, 31), ("tapmm", True, 13),
    ("tapmm", False, 18), ("flat", True, 18), ("flat", False, 18)])
def test_conv_mode_sites_equal_the_jax_kernel_sites(monkeypatch, variables,
                                                    mode, packed, n):
    sites, convs = _trace(monkeypatch, variables, mode, packed)
    assert len(sites) == len(convs) == n
    assert set(sites) == {MODULES[mode]}
    assert collections.Counter(_port_sites(mode, packed)) \
        == collections.Counter(convs)


@pytest.mark.parametrize("quad", [False, True])
def test_roll_eval_sites_equal_the_jax_kernel_sites(monkeypatch, variables,
                                                    quad):
    sites, convs = _trace(monkeypatch, variables, "roll", True, quad=quad)
    assert convs == [] and len(sites) == (8 if quad else 7)
    want = [mod for _, mod, _ in roll_eval_sites((3, 4, 6, 3), quad)]
    assert collections.Counter(sites) == collections.Counter(want)
    launches = collections.Counter()
    for _, _, counts in roll_eval_sites((3, 4, 6, 3), quad):
        launches.update(counts)
    # the port's launch counts per forward (chip_smoke.py checks them)
    assert launches == ({"stem_pool": 1, "conv3x3x3_affine": 16,
                         "conv3x3x3_heads_sigmoid": 1} if quad else
                        {"max_pool3d_k3s2p1": 1, "conv3x3x3_affine": 16,
                         "conv3x3x3_heads_sigmoid": 1})


@pytest.mark.parametrize("mode,n", [("pallas", 31), ("tapmm", 18),
                                    ("flat", 18)])
def test_train_step_sites_are_forward_only(monkeypatch, variables, mode, n):
    sites, convs = _trace(monkeypatch, variables, mode, False, train=True)
    # every pallas_call is a forward conv-mode site: the gradient adds none
    assert len(sites) == len(convs) == n
    assert collections.Counter(_port_sites(mode, False)) \
        == collections.Counter(convs)
