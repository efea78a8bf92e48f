"""The port's training conv (``roll_conv_packed``) and its weight-gradient
plain version against the JAX package's Pallas kernels in interpret mode.

At the tiny shapes of the whole-step test the JAX model never reaches
these kernels (their 128-lane and size gates send it to XLA), so this file
holds the port's VJP against the kernels themselves, at the full-lane
shapes of ``tests/test_pallas_kernels.py:189-224,304-318``: JAX takes the
W-pair packed layout (``pack_w``/``unpack_w``), the port logical NDHWC.
On the CPU the port runs its plain versions (the kernels need a card).
float32 tolerances are those of the JAX tests (rtol 1e-3, atol 1e-3 or
1e-2); the bf16 case holds 2 bf16 ulps of each value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models.packed import pack_w, unpack_w
from bodyct_dram_emph_subtype_tpu.ops import roll_conv as jrc
from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    conv3x3x3_wgrad, conv3x3x3_wgrad_plain, roll_conv_packed)


def _jax_grads(x, k, dtype=jnp.float32):
    """Forward and jax.grad of sum(roll_conv_packed(pack_w(x), k)^2)."""
    def loss(xp, kk):
        return jnp.sum(jrc.roll_conv_packed(xp, kk).astype(jnp.float32)
                       ** 2)

    xp = pack_w(jnp.asarray(x).astype(dtype))
    kk = jnp.asarray(k).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        y = jrc.roll_conv_packed(xp, kk)
        gx, gk = jax.grad(loss, argnums=(0, 1))(xp, kk)
    return [np.asarray(a.astype(jnp.float32))
            for a in (unpack_w(y), unpack_w(gx), gk)]


def _port_grads(x, k, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = torch.from_numpy(k).to(dtype).requires_grad_()
    y = roll_conv_packed(xt, kt)
    (y.float() ** 2).sum().backward()
    return y, xt.grad, kt.grad


@pytest.mark.parametrize("shape,o", [
    ((1, 4, 5, 12, 64), 64),    # full-lane: the Pallas dgrad + wgrad
    ((1, 4, 5, 24, 64), 32),    # us3 class: lane-padded dgrad, XLA wgrad
])
def test_roll_conv_packed_vjp_matches_pallas(shape, o):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) * 0.1).astype(np.float32)
    k = (rng.randn(3, 3, 3, c, o) * 0.05).astype(np.float32)
    assert jrc.supports_roll_conv(pack_w(jnp.asarray(x)).shape, k.shape, 4)
    want = _jax_grads(x, k)
    got = _port_grads(x, k)
    for g, w, atol in zip(got, want, (1e-3, 1e-2, 1e-2)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-3,
                                   atol=atol)


@pytest.mark.parametrize("b,d,h,w,c,o", [(2, 4, 5, 12, 64, 64),
                                         (1, 3, 4, 16, 192, 64)])
def test_wgrad_plain_matches_pallas_wgrad(b, d, h, w, c, o):
    rng = np.random.RandomState(1)
    x = (rng.randn(b, d, h, w, c) * 0.1).astype(np.float32)
    g = (rng.randn(b, d, h, w, o) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jrc.roll_conv_wgrad(pack_w(jnp.asarray(x)),
                                   pack_w(jnp.asarray(g)), (3, 3, 3, c, o))
    # the wrapper takes the plain version for a CPU tensor
    before = cuda_build.launches()
    got = conv3x3x3_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert cuda_build.launches() == before
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, c, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_bf16_weight_gradient_is_rounded_to_bf16():
    """In bf16 the VJP returns the float32 wgrad rounded to the weights'
    dtype (``roll_conv.py:821``), as the JAX kernel does."""
    rng = np.random.RandomState(2)
    x = (rng.randn(1, 4, 5, 12, 64) * 0.1).astype(np.float32)
    k = (rng.randn(3, 3, 3, 64, 64) * 0.05).astype(np.float32)
    y, gx, gk = _port_grads(x, k, torch.bfloat16)
    assert y.dtype == gx.dtype == gk.dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gy = 2 * y.detach().float()          # d sum(y^2) / dy, in float32 ...
    gy = gy.to(torch.bfloat16)           # ... rounded to y's dtype
    f32 = conv3x3x3_wgrad_plain(xb, gy)
    assert torch.equal(gk, f32.to(torch.bfloat16))
    assert not torch.equal(gk.float(), f32)
    _, _, jgk = _jax_grads(x, k, jnp.bfloat16)
    ref = torch.from_numpy(jgk)
    mag = ref.abs().clamp_min(ref.abs().max() * 2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert torch.all((gk.float() - ref).abs() <= 2 * ulp)
