"""The port's classification models against the JAX package's, on the CPU.

``ResNetSegCls`` (``resnettinysegcls``) and the plain ``ResNet``, float32,
the same weights on both sides (JAX init -> ``state_dict_from_jax`` ->
``load_state_dict(strict=True)``), the JAX side in conv mode ``direct``
under ``jax.default_matmul_precision("highest")``, the port in its
default mode ``roll`` (plain versions of its kernels on the CPU).

- eval, both decoders, shortcut 'A' and 'B': the dense logits and the
  pooled logits within rtol 1e-4 / atol 1e-5 (``test_torch_model.py``'s
  bounds);
- the train forward with shortcut 'B' (layer2/3/4 block 0 take
  ``DownsampleB``): the pooled logits within rtol 1e-4 / atol 5e-5
  (``test_torch_model.py``'s train bounds), the dense logits within rtol
  1e-4 / atol 2e-5 of their peak (the train BNs amplify float32 order
  noise, and these logits are unbounded where the dRAM test's atol 5e-5
  is on sigmoid maps in [0, 1]), and
  every updated BatchNorm running statistic, the shortcut's too, within
  rtol 1e-5 (atol 1e-5);
- ``ResNet`` with ``layers=(1, 1, 1, 1)``: logits and the dense output;
- the reference keys: a CLS tree crosses ``state_dict_from_jax`` and the
  JAX package's ``convert_state_dict`` exactly, and a reference-keyed
  checkpoint loads with nothing missing or mismatched.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    ResNet as JaxResNet
from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    ResNetSegCls as JaxSegCls
from bodyct_dram_emph_subtype_tpu.models.torch_import import \
    convert_state_dict
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import (BasicBlock,
                                                              DownsampleB)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (ResNet,
                                                                ResNetSegCls)
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, load_reference_checkpoint, state_dict_from_jax)

TINY = (1, 1, 1, 1)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _init(model, *args, seed=0):
    init = jax.jit(functools.partial(model.init, train=False))
    return jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(seed),
                                              *map(jnp.asarray, args))))


def _inputs(seed, batch=1, size=(16, 32, 32)):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, *size, 1).astype(np.float32)
    lung = (rng.rand(batch, *size, 1) > 0.3).astype(np.float32)
    return x, lung


def _close(got, want, atol=1e-5, peak_atol=0.0):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=atol + peak_atol * np.abs(w).max())


@pytest.mark.parametrize("shortcut", ["A", "B"])
@pytest.mark.parametrize("packed", [False, True])
def test_tiny_cls_forward_matches_jax(packed, shortcut):
    x, lung = _inputs(0)
    model = JaxSegCls(layers=TINY, packed_decoder=packed,
                      shortcut_type=shortcut)
    variables = _init(model, x, lung)
    with jax.default_matmul_precision("highest"):
        dense, logits = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(x), jnp.asarray(lung))
    port = get_model_by_name("med3dtiny", packed_decoder=packed,
                             shortcut_type=shortcut)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    if shortcut == "B":
        assert [n for n, m in port.named_modules()
                if isinstance(m, DownsampleB)] == [
            "layer2.0.downsample", "layer3.0.downsample",
            "layer4.0.downsample"]
    with torch.inference_mode():
        tdense, tlogits = port(torch.from_numpy(x), torch.from_numpy(lung))
    assert [d.shape[-1] for d in tdense] == [6, 3]
    assert [tuple(c.shape) for c in tlogits] == [(1, 6), (1, 3)]
    _close(tdense, dense)
    _close(tlogits, logits)


def test_tiny_cls_train_forward_shortcut_b_matches_jax():
    x, lung = _inputs(1, batch=2)
    model = JaxSegCls(layers=TINY, packed_decoder=True, shortcut_type="B")
    variables = _init(model, x, lung, seed=1)
    with jax.default_matmul_precision("highest"):
        (dense, logits), upd = model.apply(
            variables, jnp.asarray(x), jnp.asarray(lung), train=True,
            mutable=["batch_stats"])
    port = ResNetSegCls(BasicBlock, TINY, packed_decoder=True,
                        shortcut_type="B")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.train()
    tdense, tlogits = port(torch.from_numpy(x), torch.from_numpy(lung))
    assert tlogits[0].requires_grad
    _close(tdense, dense, atol=0.0, peak_atol=2e-5)
    _close(tlogits, logits, atol=5e-5)
    buffers = dict(port.named_buffers())
    stats = _flat(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    assert len(stats) == sum(k.endswith(("running_mean", "running_var"))
                             for k in buffers)
    assert any("downsample" in "/".join(p) for p in stats)
    for path, v in stats.items():
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("shortcut", ["A", "B"])
def test_plain_resnet_matches_jax(shortcut):
    x, _ = _inputs(2, batch=2)
    model = JaxResNet(layers=TINY, shortcut_type=shortcut)
    variables = _init(model, x)
    with jax.default_matmul_precision("highest"):
        logits, dense = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(x))
    port = ResNet(BasicBlock, TINY, shortcut_type=shortcut)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        tlogits, tdense = port(torch.from_numpy(x))
    assert tuple(tlogits.shape) == (2, 6) and tdense.shape[1:4] == (2, 4, 4)
    _close([tlogits, tdense], [logits, dense])


@pytest.mark.parametrize("name,kw", [("med3dtiny", {}),
                                     ("med3dtiny", {"shortcut_type": "B"}),
                                     ("plain", {"shortcut_type": "B"})])
def test_cls_trees_cross_both_ways(name, kw, tmp_path):
    """JAX init -> ``state_dict_from_jax`` -> the port (strict) -> the JAX
    package's ``convert_state_dict``: nothing missing, mismatched or
    unexpected, every value equal; then the port's state dict under the
    reference's ``model.`` prefix loads greedily with 0 missing and 0
    mismatched keys (``fcs.i`` with 6/3 outputs, ``fc``,
    ``layerN.0.downsample.0/1``)."""
    x = np.zeros((1, 16, 16, 16, 1), np.float32)
    if name == "plain":
        variables = _init(JaxResNet(layers=TINY, **kw), x, seed=3)
        port, fresh = (ResNet(BasicBlock, TINY, **kw,
                              generator=torch.Generator().manual_seed(s))
                       for s in (1, 2))
    else:
        variables = _init(JaxSegCls(layers=TINY, **kw), x, x, seed=3)
        port, fresh = (get_model_by_name(
            name, generator=torch.Generator().manual_seed(s), **kw)
            for s in (1, 2))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    back, report = convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, variables)
    assert report["missing"] == report["shape_mismatch"] \
        == report["unexpected"] == 0
    want, got = _flat(variables), _flat(jax.tree.map(np.asarray, back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    path = tmp_path / "best.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               port.state_dict().items()}}, path)
    report = load_reference_checkpoint(fresh, str(path))
    assert report["missing"] == report["shape_mismatch"] \
        == report["unexpected"] == 0
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k
