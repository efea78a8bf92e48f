"""The pair-stem switch of the port against the JAX package's, on the CPU.

- The gate: ``use_pair_stem`` with the switch on and off, in training, with
  the unpacked decoder and outside conv mode ``roll``, as
  ``tests/test_packed_decoder.py::test_pair_stem_pool_path_matches_direct``
  tests JAX's, and on inputs whose d, h, w or channels miss the JAX
  divisibility gate: equal to JAX's gate where the size floor
  ``_ROLL_MIN_ELEMS`` is patched to 0 on both sides, as that test patches
  it (the JAX gate's kernel plan holds at these sizes; at a stem depth
  below 8 it does not, and the port's gate, which copies no kernel plan,
  still holds).
- The model (``ResNetSegReg`` layers (2, 1, 1, 1), packed decoder,
  float32, 1x16x32x32) with the switch on: against the JAX model with its
  switch on (Pallas kernels in interpret mode, as the JAX test runs them),
  maps and fractions within that test's rtol 1e-4 / atol 1e-5; and
  bit-equal to the port with the switch off, with the same kernel-wrapper
  calls (C 1 and 4 A in ``fused_pool_layer1``, 4 A in the decoder, B 1),
  which are ``roll_eval_sites``' launches.
- A Bottleneck arch: JAX's pair path fails on the model's variables; the
  port raises ``ValueError``.
"""
import collections
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import experimental as jexp
from bodyct_dram_emph_subtype_tpu.models import packed as jpacked
from bodyct_dram_emph_subtype_tpu.models.blocks import \
    Bottleneck as JBottleneck
from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    ResNetSegReg as JaxSegReg
from bodyct_dram_emph_subtype_tpu_torch.models import blocks as tblocks
from bodyct_dram_emph_subtype_tpu_torch.models import experimental as texp
from bodyct_dram_emph_subtype_tpu_torch.models import resnet3d as tresnet
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import (BasicBlock,
                                                              Bottleneck)
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from bodyct_dram_emph_subtype_tpu_torch.ops import layer1_kernel

LAYERS = (2, 1, 1, 1)


@pytest.fixture
def roll(monkeypatch):
    """Conv mode ``roll`` and the size floor 0 on both sides."""
    for mod in (jpacked, texp):
        monkeypatch.setattr(mod, "_ROLL_MIN_ELEMS", 0)
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "roll")
    before = tblocks.get_conv3d_mode()
    tblocks.set_conv3d_mode("roll")
    yield
    tblocks.set_conv3d_mode(before)


def _switch(monkeypatch, on):
    monkeypatch.setattr(jexp, "_PAIR_STEM_ENABLE", on)
    monkeypatch.setattr(texp, "_PAIR_STEM_ENABLE", on)


@pytest.mark.parametrize("shape", [(1, 16, 32, 32, 1), (2, 16, 12, 24, 1),
                                   (1, 18, 32, 32, 1), (1, 16, 30, 32, 1),
                                   (1, 16, 32, 36, 1), (1, 16, 32, 32, 2),
                                   (16, 32, 32, 1)])
def test_gate_equals_jax(monkeypatch, roll, shape):
    for on in (False, True):
        _switch(monkeypatch, on)
        for train, packed in ((False, True), (True, True), (False, False)):
            want = jexp.use_pair_stem(shape, train, packed, jnp.float32, 2)
            got = texp.use_pair_stem(shape, train, packed, torch.float32, 2)
            assert got == want, (on, train, packed)
    assert texp.use_pair_stem(shape, False, True, torch.float32, 2) == (
        len(shape) == 5 and shape[-1] == 1
        and shape[1] % 4 == shape[2] % 4 == shape[3] % 8 == 0)
    tblocks.set_conv3d_mode("direct")
    assert not texp.use_pair_stem(shape, False, True, torch.float32, 2)


def test_gate_copies_no_kernel_plan(monkeypatch, roll):
    """JAX's pool + layer1 kernel plan (``supports_fused_pool_layer1``)
    also refuses a pooled depth below 4; the port's C and A take every
    shape, and the pair route is its default route, so its gate holds."""
    _switch(monkeypatch, True)
    shape = (2, 8, 12, 24, 1)
    assert not jexp.use_pair_stem(shape, False, True, jnp.float32, 2)
    assert texp.use_pair_stem(shape, False, True, torch.float32, 2)


def _inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 16, 32, 32, 1) * 0.2).astype(np.float32)
    lung = (rng.rand(1, 8, 16, 16, 1) > 0.3).astype(np.float32)
    return x, lung


class _Calls:
    """The calls of the eval kernel wrappers, by the port kernel they
    launch on a CUDA tensor."""

    def __init__(self, monkeypatch):
        self.counts = collections.Counter()
        for mod, name, kernel in (
                (layer1_kernel, "max_pool_k3s2p1", "max_pool3d_k3s2p1"),
                (layer1_kernel, "roll_conv_affine_relu", "conv3x3x3_affine"),
                (tblocks, "roll_conv_affine_relu", "conv3x3x3_affine"),
                (tresnet, "roll_conv_heads_sigmoid",
                 "conv3x3x3_heads_sigmoid")):
            monkeypatch.setattr(mod, name, self._counted(
                getattr(mod, name), kernel))

    def _counted(self, fn, kernel):
        def call(*args, **kw):
            self.counts[kernel] += 1
            return fn(*args, **kw)
        return call


def test_pair_stem_model_matches_jax_and_the_default_route(monkeypatch,
                                                           roll):
    x, lung = _inputs()
    model = JaxSegReg(layers=LAYERS, packed_decoder=True)
    xj, lj = jnp.asarray(x), jnp.asarray(lung)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), xj, lj))
    _switch(monkeypatch, True)
    assert jexp.use_pair_stem(x.shape, False, True, jnp.float32, 2)
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        dense, regs = jax.jit(functools.partial(model.apply, train=False))(
            variables, xj, lj)

    port = tresnet.ResNetSegReg(BasicBlock, LAYERS, packed_decoder=True)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = {}
    calls = _Calls(monkeypatch)
    for on in (True, False):
        _switch(monkeypatch, on)
        assert texp.use_pair_stem(x.shape, False, True, torch.float32,
                                  2) == on
        calls.counts.clear()
        with torch.inference_mode():
            got[on] = port(torch.from_numpy(x), torch.from_numpy(lung))
        got[on, "calls"] = dict(calls.counts)
    tdense, tregs = got[True]
    for a, b in zip(list(tdense) + list(tregs), list(dense) + list(regs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(list(tdense) + list(tregs),
                    list(got[False][0]) + list(got[False][1])):
        assert torch.equal(a, b)
    assert got[True, "calls"] == got[False, "calls"] == tresnet.site_launches(
        tresnet.roll_eval_sites(LAYERS, packed_decoder=True))
    assert got[True, "calls"]["conv3x3x3_affine"] == 8


def test_pair_stem_refuses_a_bottleneck_arch(monkeypatch, roll):
    x, lung = _inputs()
    model = JaxSegReg(block=JBottleneck, layers=(1, 1, 1, 1),
                      packed_decoder=True)
    xj, lj = jnp.asarray(x), jnp.asarray(lung)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), xj, lj)
    port = tresnet.ResNetSegReg(Bottleneck, (1, 1, 1, 1),
                                packed_decoder=True)
    port.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables)), strict=True)
    _switch(monkeypatch, True)
    assert jexp.use_pair_stem(x.shape, False, True, jnp.float32, 1)
    with pytest.raises(flax.errors.ScopeParamShapeError), \
            pltpu.force_tpu_interpret_mode():
        model.apply(variables, xj, lj, train=False)
    with pytest.raises(ValueError, match="Bottleneck"), \
            torch.inference_mode():
        port(torch.from_numpy(x), torch.from_numpy(lung))
