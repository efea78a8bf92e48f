"""Kernel E's plain version (which CPU tensors run) against the JAX
package's ``fused_stem_pool`` (Pallas kernel 9, interpret mode), and the
port's quad stem path against the JAX one.

- ``fused_stem_pool`` at the shapes of ``tests/test_pallas_kernels.py``
  (quad columns Wq = 4 and 7): the stem and the pooled activation, float32
  within rtol 1e-4 / atol 1e-5, bfloat16 within one bf16 ulp of the JAX
  value (both accumulate in float32 in other orders and round once; the
  ulp is taken no lower than at 2^-10 of the tensor's peak).
- ``med3ddramtiny`` in conv mode ``roll`` with the quad stem switched on and
  the size floor ``_ROLL_MIN_ELEMS`` patched to 0 on both sides (as
  ``tests/test_packed_decoder.py`` patches it), eval, float32: D = 16 takes
  kernel E, D = 8 the cuDNN conv + kernel C fallback; maps and fractions
  within rtol 1e-4 / atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import experimental as jexp
from bodyct_dram_emph_subtype_tpu.models import packed as jpacked
from bodyct_dram_emph_subtype_tpu.models.packed import unpack_w
from bodyct_dram_emph_subtype_tpu.models.resnet3d import \
    ResNetSegReg as JaxSegReg
from bodyct_dram_emph_subtype_tpu.ops import stem_kernel as jsk
from bodyct_dram_emph_subtype_tpu_torch.models import blocks as tblocks
from bodyct_dram_emph_subtype_tpu_torch.models import experimental as texp
from bodyct_dram_emph_subtype_tpu_torch.models import resnet3d as tresnet
from bodyct_dram_emph_subtype_tpu_torch.models.blocks import BasicBlock
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from bodyct_dram_emph_subtype_tpu_torch.ops.stem_kernel import (
    fused_stem_pool, space_to_depth2, stem_conv_s2d_plain, stem_weights_s2d,
    supports_fused_stem)


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    mag = np.abs(ref.astype(np.float32))
    mag = np.maximum(mag, max(mag.max() * 2.0 ** -10, 2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 32, 1), (1, 16, 32, 56, 1)])
def test_fused_stem_pool_matches_pallas(shape, dtype):
    rng = np.random.RandomState(0)
    k = (rng.randn(7, 7, 7, 1, 64) * 0.05).astype(np.float32)
    mul = (rng.rand(64) + 0.5).astype(np.float32)
    add = (rng.randn(64) * 0.1).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        stem_q, pooled = jsk.fused_stem_pool(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(mul),
            jnp.asarray(add), dtype=jdt)
    b, d2, h2, wq, o = stem_q.shape
    want_stem = np.asarray(stem_q.reshape(b, d2, h2, wq * 4, o // 4)
                           .astype(jnp.float32))
    want_pool = np.asarray(unpack_w(pooled).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    stem, pool = fused_stem_pool(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(k), torch.from_numpy(mul),
                                 torch.from_numpy(add))
    assert stem.dtype == pool.dtype == tdt
    for got, want in ((stem, want_stem), (pool, want_pool)):
        got = got.float().numpy()
        assert got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("depth,fused", [(16, True), (8, False)])
def test_quad_stem_model_matches_jax(monkeypatch, depth, fused):
    rng = np.random.RandomState(depth)
    x = (rng.randn(1, depth, 32, 32, 1) * 0.2).astype(np.float32)
    lung = (rng.rand(1, depth // 2, 16, 16, 1) > 0.3).astype(np.float32)
    assert supports_fused_stem(x.shape, 64, 4) == fused
    model = JaxSegReg(layers=(1, 1, 1, 1), packed_decoder=True)
    xj, lj = jnp.asarray(x), jnp.asarray(lung)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), xj, lj))
    for mod in (jpacked, texp):
        monkeypatch.setattr(mod, "_ROLL_MIN_ELEMS", 0)
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "roll")
    monkeypatch.setattr(jexp, "_QUAD_STEM_ENABLE", True)
    monkeypatch.setattr(texp, "_QUAD_STEM_ENABLE", True)
    assert jexp.use_quad_stem(x.shape, False, True, jnp.float32)
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        dense, regs = jax.jit(functools.partial(model.apply, train=False))(
            variables, xj, lj)

    calls = []
    monkeypatch.setattr(tresnet, "fused_stem_pool",
                        lambda *a: calls.append(1) or fused_stem_pool(*a))
    before = tblocks.get_conv3d_mode()
    tblocks.set_conv3d_mode("roll")
    try:
        port = tresnet.ResNetSegReg(BasicBlock, (1, 1, 1, 1),
                                    packed_decoder=True)
        port.load_state_dict(state_dict_from_jax(variables), strict=True)
        assert texp.use_quad_stem(x.shape, False, True, torch.float32)
        assert not texp.use_quad_stem(x.shape, False, False, torch.float32)
        with torch.inference_mode():
            tdense, tregs = port(torch.from_numpy(x), torch.from_numpy(lung))
    finally:
        tblocks.set_conv3d_mode(before)
    assert len(calls) == int(fused)
    for got, want in zip(list(tdense) + list(tregs), list(dense) + list(regs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_stem_weights_s2d_layout():
    """Row ((td*4 + th)*4 + tw)*8 + (qd*2 + qh)*2 + qw of the bf16 kernel's
    weight operand is tap (2td + qd - 1, 2th + qh - 1, 2tw + qw - 1) of the
    7^3 stem weights, or zero where a tap index is -1; and channel
    (qd*2 + qh)*2 + qw of the space-to-depth voxel (i, j, k) is
    x[2i + qd, 2j + qh, 2k + qw]."""
    k = torch.arange(7 ** 3 * 3, dtype=torch.float32).reshape(7, 7, 7, 1, 3)
    ws = stem_weights_s2d(k)
    assert ws.shape == (512, 3)
    for td in range(4):
        for th in range(4):
            for tw in range(4):
                for q in range(8):
                    qd, qh, qw = q >> 2, (q >> 1) & 1, q & 1
                    i, j, l = 2 * td + qd - 1, 2 * th + qh - 1, 2 * tw + qw - 1
                    want = (k[i, j, l, 0] if min(i, j, l) >= 0
                            else torch.zeros(3))
                    assert torch.equal(
                        ws[((td * 4 + th) * 4 + tw) * 8 + q], want)
    x = torch.arange(2 * 4 * 6 * 8, dtype=torch.float32).reshape(2, 4, 6, 8, 1)
    xs = space_to_depth2(x)
    assert xs.shape == (2, 2, 3, 4, 8)
    for q in range(8):
        qd, qh, qw = q >> 2, (q >> 1) & 1, q & 1
        assert torch.equal(xs[..., q], x[:, qd::2, qh::2, qw::2, 0])


@pytest.mark.parametrize("shape", [(2, 16, 24, 32, 1), (1, 12, 20, 8, 1)])
def test_stem_conv_s2d_equals_k7_s2_conv(shape):
    """The bf16 kernel's form of the stem conv -- the stride-1 4^3 conv of
    the space-to-depth input with :func:`stem_weights_s2d` -- equals
    ``F.conv3d(k7, s2, p3)`` in float32: exactly on small integers (every
    sum exact), and within rtol 1e-6 (atol 1e-6 of the peak, for the
    summation order) on random normals."""
    import torch.nn.functional as F
    rng = np.random.RandomState(3)

    def conv(x, k):
        return F.conv3d(x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2),
                        stride=2, padding=3).permute(0, 2, 3, 4, 1)

    x = torch.from_numpy(rng.randint(-2, 3, shape).astype(np.float32))
    k = torch.from_numpy(rng.randint(-3, 4, (7, 7, 7, 1, 64))
                         .astype(np.float32))
    assert torch.equal(stem_conv_s2d_plain(x, k), conv(x, k))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    k = torch.from_numpy((rng.randn(7, 7, 7, 1, 64) * 0.05)
                         .astype(np.float32))
    want = conv(x, k)
    np.testing.assert_allclose(stem_conv_s2d_plain(x, k).numpy(),
                               want.numpy(), rtol=1e-6,
                               atol=1e-6 * want.abs().max().item())
