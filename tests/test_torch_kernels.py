"""The port's kernel sites (their plain PyTorch versions, which CPU tensors
run) against the JAX package's Pallas kernels in interpret mode, at the
shapes of ``tests/test_pallas_kernels.py``.

Same inputs from numpy seeds on both sides; the JAX kernels take the W-pair
packed layout (``pack_w``) and per-packed-channel affines (``tile(v, 2)``),
the port logical NDHWC and (C,) vectors.  float32, rtol 1e-4 / atol 1e-5
(both sides accumulate in float32; only the summation order differs).
The residual stacks chain 2*NB convs of 27*C-term sums, whose order noise
reaches ~2e-5 near zero at C=128: they hold atol 5e-5 (the JAX test of the
same kernels allows 5e-4 against XLA).  The max-pool is compared bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models.packed import pack_w, unpack_w
from bodyct_dram_emph_subtype_tpu.ops import layer1_kernel as jl1
from bodyct_dram_emph_subtype_tpu.ops import maxpool_kernel as jmp
from bodyct_dram_emph_subtype_tpu.ops import roll_conv as jrc
from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.layer1_kernel import (
    fused_layer1, fused_pool_layer1)
from bodyct_dram_emph_subtype_tpu_torch.ops.maxpool_kernel import (
    max_pool_k3s2p1)
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    roll_conv_affine_relu, roll_conv_heads_sigmoid)

RTOL, ATOL = 1e-4, 1e-5
STACK_ATOL = 5e-5


def _f32(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("shape,o,relu", [((2, 5, 6, 16, 4), 6, True),
                                          ((1, 4, 6, 36, 4), 4, False)])
def test_roll_conv_affine_relu_matches_pallas(shape, o, relu):
    rng = np.random.RandomState(0)
    x = _f32(rng, shape)
    k = _f32(rng, (3, 3, 3, shape[-1], o))
    sc = rng.rand(o).astype(np.float32) + 0.5
    sh = _f32(rng, (o,))
    with pltpu.force_tpu_interpret_mode():
        want = unpack_w(jrc.roll_conv_affine_relu(
            pack_w(jnp.asarray(x)), jnp.asarray(k), jnp.tile(sc, 2),
            jnp.tile(sh, 2), relu=relu))
    got = roll_conv_affine_relu(torch.from_numpy(x), torch.from_numpy(k),
                                torch.from_numpy(sc), torch.from_numpy(sh),
                                relu=relu)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 5, 6, 16, 4), (1, 4, 6, 80, 4),
                                   (1, 4, 6, 36, 4)])
def test_roll_conv_heads_sigmoid_matches_pallas(shape):
    rng = np.random.RandomState(1)
    c, o, hn = shape[-1], 6, 2
    x = _f32(rng, shape, 0.3)
    k = _f32(rng, (3, 3, 3, c, o), 0.2)
    sc = rng.rand(o).astype(np.float32) + 0.5
    sh = _f32(rng, (o,), 0.2)
    hw = _f32(rng, (o, hn), 0.3)
    hb = _f32(rng, (hn,), 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = unpack_w(jrc.roll_conv_heads_sigmoid(
            pack_w(jnp.asarray(x)), jnp.asarray(k), jnp.tile(sc, 2),
            jnp.tile(sh, 2), jnp.asarray(hw), jnp.asarray(hb)))
    got = roll_conv_heads_sigmoid(*map(torch.from_numpy,
                                       (x, k, sc, sh, hw, hb)))
    assert got.dtype == torch.float32
    _close(got, want)


def _stack_params(rng, c, nb):
    ks = [_f32(rng, (3, 3, 3, c, c), 0.05) for _ in range(2 * nb)]
    ms = [rng.rand(c).astype(np.float32) + 0.5 for _ in range(2 * nb)]
    ads = [_f32(rng, (c,), 0.1) for _ in range(2 * nb)]
    return ks, ms, ads


def _torch_lists(*lists):
    return [[torch.from_numpy(a) for a in lst] for lst in lists]


@pytest.mark.parametrize("b,d,h,w,c,nb", [(2, 8, 16, 20, 64, 2),
                                          (1, 8, 10, 12, 128, 2)])
def test_fused_layer1_matches_pallas(b, d, h, w, c, nb):
    rng = np.random.RandomState(2)
    x = _f32(rng, (b, d, h, w, c), 0.3)
    ks, ms, ads = _stack_params(rng, c, nb)
    with pltpu.force_tpu_interpret_mode():
        want = unpack_w(jl1.fused_layer1(
            pack_w(jnp.asarray(x)), [jnp.asarray(k) for k in ks],
            [jnp.asarray(m) for m in ms], [jnp.asarray(a) for a in ads]))
    got = fused_layer1(torch.from_numpy(x), *_torch_lists(ks, ms, ads))
    _close(got, want, STACK_ATOL)


@pytest.mark.parametrize("b,d,h,w,nb", [(1, 8, 8, 24, 2), (1, 10, 8, 24, 1)])
def test_fused_pool_layer1_matches_pallas(b, d, h, w, nb):
    rng = np.random.RandomState(3)
    c = 64
    x = np.abs(_f32(rng, (b, d, h, w, c), 0.3))     # post-ReLU stem
    ks, ms, ads = _stack_params(rng, c, nb)
    with pltpu.force_tpu_interpret_mode():
        want = unpack_w(jl1.fused_pool_layer1(
            jnp.asarray(x), [jnp.asarray(k) for k in ks],
            [jnp.asarray(m) for m in ms], [jnp.asarray(a) for a in ads]))
    got = fused_pool_layer1(torch.from_numpy(x), *_torch_lists(ks, ms, ads))
    _close(got, want, STACK_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 8, 8, 32), (2, 6, 10, 12, 32),
                                   (1, 8, 14, 20, 96)])
def test_max_pool_matches_pallas_bitwise(shape, dtype):
    rng = np.random.RandomState(4)
    x = _f32(rng, shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = jmp.max_pool_k3s2p1_pallas(jnp.asarray(x).astype(jdt))
    got = max_pool_k3s2p1(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_cpu_tensors_never_launch_kernels():
    """CPU tensors take the plain versions: no launch is counted."""
    before = cuda_build.launches()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(_f32(rng, (1, 4, 6, 8, 8)))
    k = torch.from_numpy(_f32(rng, (3, 3, 3, 8, 8)))
    one, zero = torch.ones(8), torch.zeros(8)
    fused_pool_layer1(x.abs(), [k, k], [one, one], [zero, zero])
    roll_conv_heads_sigmoid(x, k, one, zero, torch.ones(8, 2),
                            torch.zeros(2))
    assert cuda_build.launches() == before
