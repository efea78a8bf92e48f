"""Kernel F's plain version and the port's ``lung_masked_fraction`` against
the JAX package: ``masked_sums_pallas`` in interpret mode and the jnp
``lung_masked_fraction`` with its ``jax.grad``, on the same numpy inputs.
JAX runs under ``jax.default_matmul_precision("highest")``.  Masked sums
within rtol 1e-5 (float32 sums in another order), lung sums exact (0/1
values); fractions within rtol 1e-5; the gradient within rtol 1e-6 (the
same float32 division and product on both sides)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.ops.masked_pool import \
    lung_masked_fraction as jax_fraction
from bodyct_dram_emph_subtype_tpu.ops.pallas_kernels import (
    lung_masked_fraction_pallas, masked_sums_pallas)
from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.masked_pool import \
    lung_masked_fraction
from bodyct_dram_emph_subtype_tpu_torch.ops.pallas_kernels import (
    MAX_CHANNELS, SUMS_BLOCKS_PER_SM, SUMS_THREADS,
    lung_masked_fraction_kernel, masked_sums, masked_sums_plain,
    masked_sums_splits)


def _inputs(shape, seed=0, lung_shape=None):
    rng = np.random.RandomState(seed)
    dense = rng.rand(*shape).astype(np.float32)
    lung = (rng.rand(*(lung_shape or shape[:4] + (1,))) > 0.4
            ).astype(np.float32)
    return dense, lung


@pytest.mark.parametrize("shape,dtype", [
    ((2, 6, 16, 128, 2), torch.float32),   # tests/test_pallas_kernels.py
    ((1, 4, 8, 128, 1), torch.float32),
    ((2, 5, 7, 9, 3), torch.float32),      # ragged, C = 3
    ((1, 3, 5, 7, 1), torch.float32),      # ragged, C = 1
    ((2, 5, 7, 9, 2), torch.bfloat16),     # widened exactly to float32
])
def test_masked_sums_match_pallas(shape, dtype):
    dense, lung = _inputs(shape)
    dt = torch.from_numpy(dense).to(dtype)
    with jax.default_matmul_precision("highest"):
        want_num, want_den = masked_sums_pallas(
            jnp.asarray(dt.float().numpy()), jnp.asarray(lung),
            interpret=True)
    before = cuda_build.launches()["masked_sums"]
    for fn in (masked_sums_plain, masked_sums):
        num, den = fn(dt, torch.from_numpy(lung))
        assert num.dtype == den.dtype == torch.float32
        assert num.shape == (shape[0], shape[-1]) and den.shape == (shape[0],)
        np.testing.assert_allclose(num.numpy(), np.asarray(want_num),
                                   rtol=1e-5)
        np.testing.assert_array_equal(den.numpy(), np.asarray(want_den))
        np.testing.assert_array_equal(den.numpy(), lung.sum((1, 2, 3, 4)))
    assert cuda_build.launches()["masked_sums"] == before   # CPU: plain
    got = lung_masked_fraction_kernel(dt, torch.from_numpy(lung))
    with jax.default_matmul_precision("highest"):
        want = lung_masked_fraction_pallas(
            jnp.asarray(dt.float().numpy()), jnp.asarray(lung),
            interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_masked_sums_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="127"):
        masked_sums(torch.zeros(1, 2, 2, 2, 128), torch.zeros(1, 2, 2, 2, 1))
    with pytest.raises(ValueError, match="lung"):
        masked_sums(torch.zeros(1, 2, 2, 2, 2), torch.zeros(1, 2, 2, 3, 1))


def test_masked_sums_splits():
    """Kernel F's launch plan: the mirrored block size and blocks per SM
    equal the ``constexpr`` values of ``csrc/masked_sums.cu``; one wave of
    2 blocks on each of the H100's 132 SMs (132 ranges per sample at
    B = 2), fewer where a block would get under 16 voxels per thread."""
    src = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                          (cuda_build.CSRC / "masked_sums.cu").read_text()))
    assert int(src["MT"]) == SUMS_THREADS == 256
    assert int(src["kBlocksPerSM"]) == SUMS_BLOCKS_PER_SM == 2
    assert int(src["kMaxC"]) == MAX_CHANNELS
    assert masked_sums_splits(2, 64 * 112 * 144) == 132
    assert masked_sums_splits(2, 128 * 224 * 288) == 132
    assert masked_sums_splits(1, 5 * 7 * 9) == 1


@pytest.mark.parametrize("eps", [0.0, 0.5])
@pytest.mark.parametrize("lung_shape", [
    (2, 4, 6, 8, 1),       # at the dense resolution
    (2, 8, 12, 16, 1),     # larger: the nearest resize runs first
])
def test_lung_masked_fraction_matches_jax(lung_shape, eps):
    dense, lung = _inputs((2, 4, 6, 8, 2), seed=1, lung_shape=lung_shape)
    with jax.default_matmul_precision("highest"):
        want = jax_fraction(jnp.asarray(dense), jnp.asarray(lung), eps=eps)
    got = lung_masked_fraction(torch.from_numpy(dense),
                               torch.from_numpy(lung), eps=eps)
    assert got.shape == (2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("lung_shape", [(2, 4, 6, 8, 1), (2, 8, 12, 16, 1)])
def test_lung_masked_fraction_gradient_matches_jax(lung_shape):
    """The gradient with respect to ``dense`` of a weighted sum of the
    fractions against ``jax.grad`` of the JAX function."""
    dense, lung = _inputs((2, 4, 6, 8, 2), seed=2, lung_shape=lung_shape)
    cot = np.random.RandomState(3).randn(2, 2).astype(np.float32)

    def loss(d):
        return jnp.sum(jax_fraction(d, jnp.asarray(lung), eps=1e-3)
                       * jnp.asarray(cot))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(loss)(jnp.asarray(dense))
    d = torch.from_numpy(dense).requires_grad_()
    (lung_masked_fraction(d, torch.from_numpy(lung), eps=1e-3)
     * torch.from_numpy(cot)).sum().backward()
    assert d.grad.shape == dense.shape
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want), rtol=1e-6)
