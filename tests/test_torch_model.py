"""The port's eval forward (plain versions on the CPU) against the JAX
model in conv mode ``direct`` under ``jax.default_matmul_precision(
"highest")``, both on the same weights (JAX init -> ``state_dict_from_jax``
-> ``load_state_dict(strict=True)``).  Both dense maps and both lesion
fractions within rtol 1e-4 / atol 1e-5 (float32 on both sides)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    ResNetSegReg as JaxSegReg
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import BasicBlock
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import ResNetSegReg
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax


def _jax_forward(model, x, lung):
    xj, lj = jnp.asarray(x), jnp.asarray(lung)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), xj, lj))
    with jax.default_matmul_precision("highest"):
        dense, regs = jax.jit(functools.partial(model.apply, train=False))(
            variables, xj, lj)
    return variables, dense, regs


def _compare(port, variables, dense, regs, x, lung):
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        tdense, tregs = port(torch.from_numpy(x), torch.from_numpy(lung))
    assert len(tdense) == len(dense) == 2
    for got, want in zip(tdense, dense):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    for got, want in zip(tregs, regs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_tiny_dram_forward_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 16, 32, 32, 1).astype(np.float32)
    lung = (rng.rand(1, 16, 32, 32, 1) > 0.3).astype(np.float32)
    variables, dense, regs = _jax_forward(jax_model("med3ddramtiny"), x, lung)
    _compare(get_model_by_name("med3ddramtiny"), variables, dense, regs,
             x, lung)


def test_tiny_dram_bf16_forward_within_calibrated_bounds():
    """bfloat16 on both sides, the same weights and bf16 input: the port
    (conv mode ``roll``, one rounding per fused conv epilogue) against the
    JAX model in its default mode (the unpacked blocks round the BN output
    and add the residual in bf16).  Rounding order differs, so the bounds
    are the bf16 bounds calibrated at the deployment shape
    (``tests/test_composed_oracle.py:246-262``): lesion fractions |d| <
    5e-3, map mean |d| < 1.5e-2, flip rate (|d| > 0.5) < 5e-3."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 32, 32, 1).astype(np.float32)
    lung = (rng.rand(2, 16, 32, 32, 1) > 0.3).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    model = jax_model("med3ddramtiny", dtype=jnp.bfloat16)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lung)))
    dense, regs = jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(lung))
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        tdense, tregs = port(xb, torch.from_numpy(lung))
    for got, want in zip(tdense, dense):
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape and np.isfinite(want).all()
        delta = np.abs(got.float().numpy() - want)
        assert delta.mean() < 1.5e-2
        assert (delta > 0.5).mean() < 5e-3
    for got, want in zip(tregs, regs):
        np.testing.assert_array_less(
            np.abs(got.float().numpy() - np.asarray(want, np.float32)), 5e-3)


def test_layer2_tail_forward_matches_jax():
    """layers=(1, 2, 1, 1) at 32^3: the layer2 identity tail runs
    ``fused_layer1`` (the engagement shape of
    ``test_packed_decoder.py::test_packed_model_roll_mode_matches_direct``),
    with a half-resolution lung mask."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 32, 32, 32, 1).astype(np.float32)
    lung = (rng.rand(1, 16, 16, 16, 1) > 0.5).astype(np.float32)
    variables, dense, regs = _jax_forward(JaxSegReg(layers=(1, 2, 1, 1)),
                                          x, lung)
    _compare(ResNetSegReg(BasicBlock, (1, 2, 1, 1)), variables, dense, regs,
             x, lung)


def test_lungs_default_and_eval_only():
    model = get_model_by_name("med3ddramtiny")
    before = model.bn1.running_var.clone()
    x = torch.zeros(1, 8, 16, 16, 1)
    with torch.inference_mode():
        dense, regs = model(x)
    assert dense[0].shape == (1, 4, 8, 8, 1)
    torch.testing.assert_close(regs[0], dense[0].mean(dim=(1, 2, 3, 4)))
    # eval mode reads the running statistics and leaves them alone; the
    # training forward (no longer refused) uses batch statistics, updates
    # them and is differentiable
    assert torch.equal(model.bn1.running_var, before)
    model.train()
    x = torch.randn(1, 8, 16, 16, 1, generator=torch.Generator()
                    .manual_seed(0))
    dense, regs = model(x)
    assert dense[0].shape == (1, 4, 8, 8, 1) and dense[0].requires_grad
    regs[0].sum().backward()
    assert model.conv1.weight.grad is not None
    assert not torch.equal(model.bn1.running_var, before)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_train_forward_matches_jax(block):
    """The training forward (batch statistics, roll_conv_packed sites on
    their plain versions) of a 1-block-per-layer model against JAX's
    ``train=True`` apply: both maps, both fractions and every updated BN
    running statistic.  The train BNs amplify float32 order noise, so the
    maps hold atol 5e-5 (the eval test's rtol 1e-4 stays) and the
    statistics atol 1e-5 (the Bottleneck us1 conv sums 27*2304 terms; its
    running means near 1e-3 differ by 1.8e-6)."""
    from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
    from bodyct_dram_emph_subtype_tpu_torch.models.blocks import Bottleneck
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        flax_path_to_torch_key
    jblock = jblocks.BasicBlock if block == "basic" else jblocks.Bottleneck
    tblock = BasicBlock if block == "basic" else Bottleneck
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 16, 16, 1).astype(np.float32)
    lung = (rng.rand(2, 16, 16, 16, 1) > 0.3).astype(np.float32)
    model = JaxSegReg(block=jblock, layers=(1, 1, 1, 1), packed_decoder=True)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1),
                                              jnp.asarray(x), jnp.asarray(lung)))
    with jax.default_matmul_precision("highest"):
        (dense, regs), upd = model.apply(variables, jnp.asarray(x),
                                         jnp.asarray(lung), train=True,
                                         mutable=["batch_stats"])
    port = ResNetSegReg(tblock, (1, 1, 1, 1))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.train()
    tdense, tregs = port(torch.from_numpy(x), torch.from_numpy(lung))
    for got, want in zip(list(tdense) + list(tregs), list(dense) + list(regs)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=5e-5)
    buffers = dict(port.named_buffers())

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [kv for k, v in tree.items() for kv in flat(v, prefix + (k,))]
        return [(prefix, np.asarray(tree))]

    stats = flat(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    assert len(stats) == sum(k.endswith(("running_mean", "running_var"))
                             for k in buffers)
    for path, v in stats:
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["med3d", "med3d18", "med3d50",
                                  "med3dtiny", "resnet34", "resnet50"])
def test_classification_archs_build(name):
    """Each classification arch builds, with the JAX package's
    ``n_classes``, and its state-dict keys and shapes are those of the JAX
    model's variable tree (``jax.eval_shape`` of ``init``) under
    ``flax_path_to_torch_key``."""
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        flax_path_to_torch_key
    model = jax_model(name)
    x = jax.ShapeDtypeStruct((1, 16, 16, 16, 1), jnp.float32)
    args = (x,) if name.startswith("resnet") else (x, x)
    tree = jax.eval_shape(lambda *a: model.init(jax.random.PRNGKey(0), *a,
                                                train=False), *args)
    want = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree[coll])[0]:
            path = tuple(p.key for p in path)
            shape = leaf.shape
            if len(shape) == 5:             # DHWIO -> OIDHW
                shape = (shape[4], shape[3], *shape[:3])
            want[flax_path_to_torch_key(coll, path)] = tuple(shape)
    port = get_model_by_name(name)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    heads = ["fc.weight"] if name.startswith("resnet") else \
        ["fcs.0.weight", "fcs.1.weight"]
    assert [got[k][0] for k in heads] == ([6] if len(heads) == 1 else [6, 3])


def test_unknown_arch_lists_known():
    with pytest.raises(KeyError, match="med3ddram"):
        get_model_by_name("med3ddramm")
