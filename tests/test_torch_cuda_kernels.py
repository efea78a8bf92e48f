"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the
decision is made inside the fixture, never at import).  On a machine with
a card and without JAX, run them without the JAX-only conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Shapes are small and ragged (odd extents, C and O not multiples of the
kernels' tiles, M not a multiple of the voxel tile) so every masked edge
of every kernel runs.  The deployment shapes are checked by
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.layer1_kernel import (
    fused_layer1, fused_pool_layer1)
from bodyct_dram_emph_subtype_tpu_torch.ops.maxpool_kernel import (
    max_pool_k3s2p1, max_pool_k3s2p1_plain)
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    conv3x3x3_dgrad_plain, conv3x3x3_wgrad, conv3x3x3_wgrad_plain,
    roll_conv_affine_relu, roll_conv_affine_relu_plain,
    roll_conv_heads_sigmoid, roll_conv_heads_sigmoid_plain,
    identity_conv3d, roll_conv_packed, wgrad_splits)
from bodyct_dram_emph_subtype_tpu_torch.ops.stem_kernel import (
    fused_stem_pool, fused_stem_pool_plain)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dev, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dev, dtype)


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significand bits) at each reference value, taken no
    lower than at 2^-10 of the tensor's peak: near zero the two float32
    accumulations (different summation orders) differ by more than a bf16
    ulp of the cancelled result."""
    mag = ref.float().abs()
    mag = mag.clamp_min(max(mag.max().item() * 2.0 ** -10, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _assert_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        bound = 2e-5 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= bound
    else:
        assert torch.all((got - ref).abs() <= 2 * _bf16_ulp(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,residual,relu", [
    ((2, 5, 7, 9, 20), 13, False, True),      # ragged C, O, scalar loads
    ((1, 3, 6, 11, 72), 70, True, False),     # two N tiles, residual
    ((1, 4, 5, 6, 64), 64, True, True),       # 128-bit gathers
])
def test_conv_affine_kernel_matches_plain(dev, dtype, shape, o, residual,
                                          relu):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = _t(rng, shape, dev, 0.5, dtype)
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1)
    sc = _t(rng, (o,), dev).abs() + 0.5
    sh = _t(rng, (o,), dev, 0.1)
    res = _t(rng, shape[:4] + (o,), dev, 0.5, dtype) if residual else None
    before = cuda_build.launches()["conv3x3x3_affine"]
    got = roll_conv_affine_relu(x, k, sc, sh, residual=res, relu=relu)
    torch.cuda.synchronize()
    assert cuda_build.launches()["conv3x3x3_affine"] == before + 1
    ref = roll_conv_affine_relu_plain(x, k, sc, sh, res, relu)
    assert got.dtype == dtype and got.shape == ref.shape
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,hn", [((2, 5, 7, 9, 20), 13, 2),
                                        ((1, 4, 6, 10, 64), 32, 3)])
def test_heads_kernel_matches_plain(dev, dtype, shape, o, hn):
    rng = np.random.RandomState(1)
    c = shape[-1]
    x = _t(rng, shape, dev, 0.5, dtype)
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1)
    sc = _t(rng, (o,), dev).abs() + 0.5
    sh = _t(rng, (o,), dev, 0.1)
    hw = _t(rng, (o, hn), dev, 0.3)
    hb = _t(rng, (hn,), dev, 0.1)
    got = roll_conv_heads_sigmoid(x, k, sc, sh, hw, hb)
    torch.cuda.synchronize()
    ref = roll_conv_heads_sigmoid_plain(x, k, sc, sh, hw, hb)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    delta = (got - ref).abs()
    if dtype == torch.float32:
        assert delta.max().item() <= 1e-5
    else:
        assert delta.max().item() <= 5e-3 and delta.mean().item() <= 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 7, 9, 3), (1, 8, 6, 12, 64)])
def test_maxpool_kernel_matches_plain_bitwise(dev, dtype, shape):
    rng = np.random.RandomState(2)
    x = _t(rng, shape, dev, 1.0, dtype)
    got = max_pool_k3s2p1(x)
    torch.cuda.synchronize()
    assert torch.equal(got, max_pool_k3s2p1_plain(x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_pool_layer1_matches_plain(dev, dtype):
    rng = np.random.RandomState(3)
    c, nb = 16, 2
    x = _t(rng, (1, 8, 10, 14, c), dev, 0.3, dtype).abs()
    ks = [_t(rng, (3, 3, 3, c, c), dev, 0.05) for _ in range(2 * nb)]
    ms = [_t(rng, (c,), dev).abs() + 0.5 for _ in range(2 * nb)]
    ads = [_t(rng, (c,), dev, 0.1) for _ in range(2 * nb)]
    got = fused_pool_layer1(x, ks, ms, ads)
    torch.cuda.synchronize()
    ref = fused_layer1(max_pool_k3s2p1(x).cpu(), [k.cpu() for k in ks],
                       [m.cpu() for m in ms], [a.cpu() for a in ads])
    got, ref = got.float().cpu(), ref.float()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (got - ref).abs().max().item() <= tol * max(1.0, ref.abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [
    ((2, 5, 7, 9, 20), 13),     # ragged C (scalar gathers), O, many splits
    ((1, 4, 6, 10, 64), 32),    # us3's O = 32 < the 64-column tile
    ((1, 6, 8, 12, 72), 70),    # two column tiles, 128-bit gathers
])
def test_wgrad_kernel_matches_plain(dev, dtype, shape, o):
    """Kernel D against its plain version (both accumulate the exactly
    widened operands in float32: 5e-5 of the peak covers the order), with
    more than one voxel range, and bit-equal on a second run."""
    rng = np.random.RandomState(4)
    c = shape[-1]
    assert wgrad_splits(int(np.prod(shape[:4])), c, o) > 1
    x = _t(rng, shape, dev, 0.5, dtype)
    g = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    before = cuda_build.launches()["conv3x3x3_wgrad"]
    got = conv3x3x3_wgrad(x, g)
    again = conv3x3x3_wgrad(x, g)
    torch.cuda.synchronize()
    assert cuda_build.launches()["conv3x3x3_wgrad"] == before + 2
    ref = conv3x3x3_wgrad_plain(x, g)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, c, o)
    assert (got - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o", [((2, 4, 6, 10, 16), 24),
                                     ((1, 4, 5, 8, 64), 32)])
def test_roll_conv_packed_backward_matches_plain_autograd(dev, dtype, shape,
                                                          o):
    """The autograd Function on the card (A forward, A dgrad, D wgrad
    rounded to the weights' dtype) against the plain versions on the same
    inputs and output gradient."""
    rng = np.random.RandomState(5)
    c = shape[-1]
    x = _t(rng, shape, dev, 0.5, dtype).requires_grad_()
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1, dtype).requires_grad_()
    gy = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    y = roll_conv_packed(x, k)
    y.backward(gy)
    torch.cuda.synchronize()
    ref_y = roll_conv_affine_relu_plain(
        x.detach(), k.detach(), torch.ones(o, device=dev),
        torch.zeros(o, device=dev), relu=False)
    ref_dx = conv3x3x3_dgrad_plain(gy, k.detach())
    ref_dk = conv3x3x3_wgrad_plain(x.detach(), gy).to(dtype)
    assert x.grad.dtype == dtype and k.grad.dtype == dtype
    for got, ref in ((y, ref_y), (x.grad, ref_dx), (k.grad, ref_dk)):
        _assert_close(got.detach(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,dilation", [
    ((2, 5, 7, 9, 20), 13, 2),       # ragged C, O
    ((1, 3, 6, 11, 72), 70, 4),      # taps beyond the volume on every axis
    ((1, 8, 10, 12, 64), 64, 3),     # 128-bit gathers
])
def test_conv_affine_kernel_dilated_matches_plain(dev, dtype, shape, o,
                                                  dilation):
    """Kernel A at dilation d: taps at d*(k-1), zero padding d."""
    rng = np.random.RandomState(6)
    c = shape[-1]
    x = _t(rng, shape, dev, 0.5, dtype)
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1)
    sc = _t(rng, (o,), dev).abs() + 0.5
    sh = _t(rng, (o,), dev, 0.1)
    res = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    got = roll_conv_affine_relu(x, k, sc, sh, residual=res, dilation=dilation)
    torch.cuda.synchronize()
    ref = roll_conv_affine_relu_plain(x, k, sc, sh, res, True, dilation)
    assert got.dtype == dtype and got.shape == ref.shape
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dilation", [((2, 4, 6, 10, 16), 2),
                                            ((1, 6, 5, 8, 64), 4)])
def test_identity_conv3d_matches_plain_autograd(dev, dtype, shape, dilation):
    """The conv-mode op on the card (kernel A forward, cuDNN backward)
    against the float32 plain conv and its gradients: the forward within
    kernel A's bounds; the cuDNN gradients, rounded to the dtype, within
    1e-5 (float32) or 1e-2 (bfloat16) of each gradient's peak."""
    rng = np.random.RandomState(7)
    c, o = shape[-1], 24
    x = _t(rng, shape, dev, 0.5, dtype).requires_grad_()
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1, dtype).requires_grad_()
    gy = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    before = cuda_build.op_launches()["flat_conv3d"]
    y = identity_conv3d(x, k, dilation, "flat_conv3d")
    y.backward(gy)
    torch.cuda.synchronize()
    assert cuda_build.op_launches()["flat_conv3d"] == before + 1
    xf = x.detach().float().requires_grad_()
    kf = k.detach().float().requires_grad_()
    ref = torch.nn.functional.conv3d(
        xf.permute(0, 4, 1, 2, 3), kf.permute(4, 3, 0, 1, 2),
        padding=dilation, dilation=dilation).permute(0, 2, 3, 4, 1)
    ref.backward(gy.float())
    _assert_close(y.detach(), ref.detach(), dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in ((x.grad, xf.grad), (k.grad, kf.grad)):
        assert got.dtype == dtype
        assert (got.float() - want).abs().max().item() \
            <= tol * want.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 16, 24, 32, 1),     # whole pooled tiles
    (1, 20, 36, 44, 1),     # ragged pooled tiles on every axis
])
def test_stem_pool_kernel_matches_plain(dev, dtype, shape):
    """Kernel E: the stem (one rounding after BN and ReLU) and its pool
    against the plain version, within kernel A's bounds; the pooled
    values are maxima of stem values, so they hold the same bounds."""
    rng = np.random.RandomState(8)
    x = _t(rng, shape, dev, 1.0, dtype)
    k = _t(rng, (7, 7, 7, 1, 64), dev, 0.05)
    mul = _t(rng, (64,), dev).abs() + 0.5
    add = _t(rng, (64,), dev, 0.1)
    before = cuda_build.launches()["stem_pool"]
    stem, pooled = fused_stem_pool(x, k, mul, add)
    torch.cuda.synchronize()
    assert cuda_build.launches()["stem_pool"] == before + 1
    ref_stem, ref_pooled = fused_stem_pool_plain(x, k, mul, add)
    for got, ref in ((stem, ref_stem), (pooled, ref_pooled)):
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_close(got, ref, dtype)
