"""Where the port takes its kernels under conv mode ``roll``, against the
JAX package's routing, for both decoders.

1. At the deployment shape (B=2, 128x224x288, bf16).  The JAX model is
   traced abstractly (``jax.eval_shape``: no FLOP runs) for med3ddram and
   med3ddram50 with ``packed_decoder`` False and True:

   - eval: recorders around ``pl.pallas_call`` give the kernel module of
     every site; :func:`roll_eval_sites` must list the same;
   - train: ``jax.grad`` of the train forward with recorders around the
     roll-conv forward/dgrad (``_roll_conv_impl``) and the wgrad kernel;
     :func:`train_roll_sites` must list the forward sites, shape by
     shape.  Expected: med3ddram 11 sites packed, layer1's 6 unpacked;
     med3ddram50 the 5 decoder convs packed, none unpacked.

   Every JAX gate passes there but one: the roll kernel's VMEM plan
   (``supports_roll_conv``) refuses med3ddram50's us1.conv0, whose input
   has C = 2048 + 256 = 2304 channels, in eval and in training, so the
   JAX package runs that conv on XLA.  The port does not copy the VMEM
   budgets (``models/resnet3d.py``) and takes its kernels there: the
   tests require the JAX sites to be the port's minus exactly the ones
   the JAX gate ``_roll_mode_supported`` refuses, and that to be this one
   conv.

2. Off the deployment shape the JAX TPU gates (VMEM plans and the size
   floor ``_ROLL_MIN_ELEMS``) fail and the JAX package runs XLA where the
   port, which does not copy those budgets, still takes its kernels
   (``models/resnet3d.py``).  med3ddramtiny (resnettinysegreg) at
   16x32x32 in bf16 with ``packed_decoder=False``: the forward and one
   train step of the port against JAX in conv mode ``roll`` (Pallas in
   interpret mode), the routes on each side recorded and stated, the
   numbers within the calibrated bf16 bounds of
   ``tests/test_composed_oracle.py:246-262`` (lesion fractions |d| <
   5e-3, map mean |d| < 1.5e-2, flip rate (|d| > 0.5) < 5e-3).
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.models import packed as jpacked
from bodyct_dram_emph_subtype_tpu.ops import roll_conv as jrc
from bodyct_dram_emph_subtype_tpu.parallel import mesh as jmesh
from bodyct_dram_emph_subtype_tpu_torch.models import blocks as tblocks
from bodyct_dram_emph_subtype_tpu_torch.models import resnet3d as tresnet
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import (BasicBlock,
                                                              Bottleneck)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    roll_eval_sites, site_launches, train_roll_launches,
    train_roll_site_shapes, train_roll_sites)
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import \
    make_reg_train_step

B, SIZE = 2, (128, 224, 288)
ARCHS = {"med3ddram": ((3, 4, 6, 3), BasicBlock),
         "med3ddram50": ((3, 4, 6, 3), Bottleneck)}


@pytest.fixture(scope="module")
def jax_variables():
    out = {}
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    for arch in ARCHS:
        model = jax_model(arch, dtype=jnp.bfloat16)
        out[arch] = jax.eval_shape(
            lambda a, m=model: m.init(jax.random.PRNGKey(0), a, a,
                                      train=False), x)
    return out


def _logical(packed_shape):
    b, d, h, wh, c2 = packed_shape
    return (b, d, h, 2 * wh, c2 // 2)


def _jax_refused(arch, packed):
    """Names of the port's roll-conv sites whose W-pair packed shape the
    JAX gate ``_roll_mode_supported`` refuses (a TPU budget the port does
    not copy)."""
    layers, block = ARCHS[arch]
    out = []
    for name, (b, d, h, w, c), o in train_roll_site_shapes(
            B, SIZE, train_roll_sites(layers, block, packed)):
        if not jpacked._roll_mode_supported((b, d, h, w // 2, 2 * c),
                                            (3, 3, 3, c, o), 2):
            out.append(name)
    return out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_jax_tpu_budgets_refuse_only_c2304(monkeypatch, arch, packed):
    _roll_mode(monkeypatch)
    want = ["us1.conv_blocks.0.0"] if (arch, packed) == ("med3ddram50",
                                                          True) else []
    assert _jax_refused(arch, packed) == want
    if want:
        # the VMEM plan, not the lane gate, refuses it
        assert jrc._plan((B, 32, 56, 36, 4608), 64, 2) is None
        assert jrc._plan((B, 32, 56, 36, 4608), 64, 2,
                         vmem_budget=2 ** 40) is not None


def _roll_mode(monkeypatch):
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "roll")
    monkeypatch.setattr(jmesh, "_ACTIVE_MESH", None)


def _record_pallas(monkeypatch):
    sites = []
    call = pl.pallas_call

    def rec_call(body, *args, **kw):
        sites.append(getattr(body, "func", body).__module__.rsplit(".")[-1])
        return call(body, *args, **kw)

    monkeypatch.setattr(pl, "pallas_call", rec_call)
    return sites


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_eval_sites_equal_the_jax_kernel_sites(monkeypatch, jax_variables,
                                               arch, packed):
    _roll_mode(monkeypatch)
    sites = _record_pallas(monkeypatch)
    model = jax_model(arch, dtype=jnp.bfloat16, packed_decoder=packed,
                      remat="none")
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    jax.eval_shape(lambda v, a: model.apply(v, a, a, train=False),
                   jax_variables[arch], x)
    layers, block = ARCHS[arch]
    want = roll_eval_sites(layers, packed_decoder=packed, block=block)
    refused = _jax_refused(arch, packed)
    assert collections.Counter(sites) == collections.Counter(
        mod for name, mod, _ in want if name not in refused)
    launches = site_launches(want)
    a = launches.get("conv3x3x3_affine", 0)
    if block is BasicBlock:
        # pool + layer1 (C + 6 A), layer2 tail (6 A), packed: 4 A + B
        assert a == (16 if packed else 12)
        assert launches["max_pool3d_k3s2p1"] == 1
    else:
        assert a == (4 if packed else 0)
        assert launches["max_pool3d_k3s2p1"] == 1
    assert launches.get("conv3x3x3_heads_sigmoid", 0) == int(packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_sites_equal_the_jax_kernel_sites(monkeypatch, jax_variables,
                                                arch, packed):
    _roll_mode(monkeypatch)
    sites = _record_pallas(monkeypatch)
    calls = []
    impl, wgrad = jrc._roll_conv_impl, jrc.roll_conv_wgrad

    def rec_impl(xp, kernel, *args, **kw):
        calls.append(("impl", tuple(xp.shape), tuple(kernel.shape)))
        return impl(xp, kernel, *args, **kw)

    def rec_wgrad(xp, g, kernel_shape, *args, **kw):
        calls.append(("wgrad", tuple(xp.shape), tuple(kernel_shape)))
        return wgrad(xp, g, kernel_shape, *args, **kw)

    monkeypatch.setattr(jrc, "_roll_conv_impl", rec_impl)
    monkeypatch.setattr(jrc, "roll_conv_wgrad", rec_wgrad)
    model = jax_model(arch, dtype=jnp.bfloat16, packed_decoder=packed,
                      remat="none")
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    variables = jax_variables[arch]

    def loss(params, stats, a):
        (dense, regs), _ = model.apply(
            {"params": params, "batch_stats": stats}, a, a, train=True,
            mutable=["batch_stats"])
        return sum(jnp.sum(d) for d in dense) + sum(jnp.sum(r) for r in regs)

    jax.eval_shape(jax.grad(loss), variables["params"],
                   variables["batch_stats"], x)
    layers, block = ARCHS[arch]
    want = train_roll_sites(layers, block, packed)
    n = {("med3ddram", True): 11, ("med3ddram", False): 6,
         ("med3ddram50", True): 5, ("med3ddram50", False): 0}[arch, packed]
    assert len(want) == n
    impls = [c for c in calls if c[0] == "impl"]
    wgrads = [c for c in calls if c[0] == "wgrad"]
    # every pallas_call of the step is a roll-conv kernel
    assert set(sites) <= {"roll_conv"}
    refused = _jax_refused(arch, packed)
    shapes = [s for s in train_roll_site_shapes(B, SIZE, want)
              if s[0] not in refused]
    m = len(shapes)
    assert len(impls) == 2 * m
    got_fwd = collections.Counter((_logical(s), k) for _, s, k in impls[:m])
    assert got_fwd == collections.Counter(
        (shape, (3, 3, 3, shape[-1], o)) for _, shape, o in shapes)
    # the wgrad kernel at every site but us3 (its 2*32 gradient lanes go
    # to XLA); the port's kernel D takes all of them
    assert collections.Counter(_logical(s) for _, s, _ in wgrads) \
        == collections.Counter(shape for name, shape, _ in shapes
                               if name != "us3.0")
    assert train_roll_launches(want) == {"conv3x3x3_affine": 2 * n,
                                         "conv3x3x3_wgrad": n}
    if arch == "med3ddram50" and packed:
        assert train_roll_site_shapes(B, SIZE, want)[0] == (
            "us1.conv_blocks.0.0", (B, 32, 56, 72, 2304), 64)


# ---- 2. a second shape: the routes differ, the numbers agree ----

TINY = (16, 32, 32)


def _bf16_bounds(dense, regs, want_dense, want_regs):
    for got, want in zip(dense, want_dense):
        want = np.asarray(want.astype(jnp.float32))
        got = got.detach().float().numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        delta = np.abs(got - want)
        assert delta.mean() < 1.5e-2
        assert (delta > 0.5).mean() < 5e-3
    for got, want in zip(regs, want_regs):
        np.testing.assert_array_less(
            np.abs(got.detach().float().numpy() - np.asarray(want, np.float32)),
            5e-3)


@pytest.fixture
def port_calls(monkeypatch):
    """Counts of the port's kernel entry points (their plain versions run
    on the CPU) by name."""
    calls = collections.Counter()
    for mod, name in ((tresnet, "fused_pool_layer1"),
                      (tresnet, "fused_layer1"),
                      (tresnet, "roll_conv_heads_sigmoid"),
                      (tblocks, "roll_conv_affine_relu"),
                      (tblocks, "roll_conv_packed")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, rec)
    before = tblocks.get_conv3d_mode()
    tblocks.set_conv3d_mode("roll")
    yield calls
    tblocks.set_conv3d_mode(before)


def _tiny_setup(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *TINY, 1).astype(np.float32)
    lung = (rng.rand(2, *TINY, 1) > 0.3).astype(np.float32)
    model = jax_model("med3ddramtiny", dtype=jnp.bfloat16,
                      packed_decoder=False)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lung))))
    port = get_model_by_name("med3ddramtiny", packed_decoder=False)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return model, variables, port, xb, lung


def test_tiny_bf16_forward_unpacked_decoder(monkeypatch, port_calls):
    """Eval, bf16, unpacked decoder.  JAX: pool + layer1 on its Pallas
    kernel 3 (the VMEM gate has no size floor), the decoder and heads on
    XLA.  Port: the same trunk site (kernel C + 2 A) and the decoder on
    cuDNN with the unpacked rounding chain, unfused heads.  Same route."""
    _roll_mode(monkeypatch)
    sites = _record_pallas(monkeypatch)
    model, variables, port, xb, lung = _tiny_setup(4)
    sites.clear()                      # the init traced the forward too
    with pltpu.force_tpu_interpret_mode():
        dense, regs = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
            jnp.asarray(lung))
    assert sites == ["layer1_kernel"]
    with torch.inference_mode():
        tdense, tregs = port(xb, torch.from_numpy(lung))
    assert dict(port_calls) == {"fused_pool_layer1": 1}
    _bf16_bounds(tdense, tregs, dense, regs)


def test_tiny_bf16_train_step_unpacked_decoder(monkeypatch, port_calls):
    """One bf16 train step (B=2, augmentation off), unpacked decoder.
    JAX: no kernel at all (layer1's packed convs fail the size floor
    ``_ROLL_MIN_ELEMS``; the decoder is unpacked), every conv on XLA.
    Port: layer1's two convs through ``roll_conv_packed`` (no size floor),
    the rest on cuDNN: the routes differ here.  The loss and each of its
    components within 5e-3 (relative, or absolute below 1), the lesion
    fractions' bound."""
    from bodyct_dram_emph_subtype_tpu.train.state import TrainState
    from bodyct_dram_emph_subtype_tpu.train.steps import \
        make_reg_train_step as jax_reg_step
    import optax
    _roll_mode(monkeypatch)
    sites = _record_pallas(monkeypatch)
    model, variables, port, xb, lung = _tiny_setup(5)
    rng = np.random.RandomState(6)
    batch = {"image": xb.float().numpy()[..., 0],
             "lung_mask": lung[..., 0],
             "em_mask": (rng.rand(2, *TINY) > 0.8).astype(np.float32),
             "cls_label": np.asarray([3, 0], np.int32),
             "pse_label": np.asarray([1, 2], np.int32)}
    cw_cle = np.full(6, 1 / 6, np.float32)
    cw_pse = np.full(3, 1 / 3, np.float32)
    tx = optax.sgd(0.0)
    step = jax_reg_step(model, tx, augment=False)
    _, metrics, preds = step(
        TrainState.create(variables, tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0.0),
        jnp.asarray(cw_cle), jnp.asarray(cw_pse), jax.random.PRNGKey(0))
    # the train step traces the eval forward too (its dense map size):
    # that is the only kernel site, as in the eval test
    assert set(sites) <= {"layer1_kernel"}
    port_calls.clear()
    port_step = make_reg_train_step(port, make_optimizer(port.parameters()),
                                    augment=False,
                                    compute_dtype=torch.bfloat16)
    tmetrics, _ = port_step(batch, 0.0, cw_cle, cw_pse)
    assert dict(port_calls) == {"roll_conv_packed": 2}
    assert set(tmetrics) == set(metrics)
    for key, want in metrics.items():
        got, want = float(tmetrics[key]), float(want)
        assert abs(got - want) < 5e-3 * max(abs(want), 1.0), key
