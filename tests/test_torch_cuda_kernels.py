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
from bodyct_dram_emph_subtype_tpu_torch.ops.masked_pool import \
    lung_masked_fraction
from bodyct_dram_emph_subtype_tpu_torch.ops.maxpool_kernel import (
    max_pool_k3s2p1, max_pool_k3s2p1_plain)
from bodyct_dram_emph_subtype_tpu_torch.ops.pallas_kernels import (
    masked_sums, masked_sums_plain, masked_sums_splits)
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    conv3x3x3_dgrad_plain, conv3x3x3_wgrad, conv3x3x3_wgrad_plain,
    roll_conv_affine_relu, roll_conv_affine_relu_plain,
    roll_conv_heads_sigmoid, roll_conv_heads_sigmoid_plain,
    identity_conv3d, roll_conv_packed, wgrad_chunk, wgrad_splits, MMA_BK,
    MMA_STAGES, WGRAD_K)
from bodyct_dram_emph_subtype_tpu_torch.ops.stem_kernel import (
    fused_stem_pool, fused_stem_pool_plain, stem_weights_s2d)

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
@pytest.mark.parametrize("shape", [
    (2, 5, 7, 9, 3),          # C = 3: the scalar path
    (1, 8, 6, 12, 64),
    (2, 7, 9, 11, 8),         # C = 8: one bf16 vector, odd D/H/W
    (1, 37, 5, 7, 64),        # 19 output planes: several D walks of a thread
    (3, 35, 13, 15, 64),      # odd extents, a short last walk
    (1, 6, 4, 6, 12),         # C = 12: float32 vectors, bf16 scalar path
])
def test_maxpool_kernel_matches_plain_bitwise(dev, dtype, shape):
    """Kernel C bit-equal to ``F.max_pool3d``: the vector path (C a multiple
    of 8 bf16 or 4 float32 values) with walks along D that span several
    output planes and end short, odd extents (clamped windows), and the
    scalar path."""
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


def _stem_inputs(rng, shape, dev, dtype):
    x = _t(rng, shape, dev, 1.0, dtype)
    k = _t(rng, (7, 7, 7, 1, 64), dev, 0.05)
    mul = _t(rng, (64,), dev).abs() + 0.5
    add = _t(rng, (64,), dev, 0.1)
    return x, k, mul, add


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 16, 24, 32, 1),     # whole pooled tiles
    (1, 20, 36, 44, 1),     # ragged pooled tiles on every axis
    (3, 28, 36, 76, 1),     # B = 3; 14 stem planes wrap the 5-slot ring
    (1, 48, 64, 64, 1),     # whole 8 x 8 bf16 tiles, 24 stem planes
])
def test_stem_pool_kernel_matches_plain(dev, dtype, shape):
    """Kernel E: the stem (one rounding after BN and ReLU) and its pool
    against the plain version, within kernel A's bounds; the pooled
    values are maxima of stem values, so they hold the same bounds."""
    rng = np.random.RandomState(8)
    x, k, mul, add = _stem_inputs(rng, shape, dev, dtype)
    before = cuda_build.launches()["stem_pool"]
    stem, pooled = fused_stem_pool(x, k, mul, add)
    torch.cuda.synchronize()
    assert cuda_build.launches()["stem_pool"] == before + 1
    ref_stem, ref_pooled = fused_stem_pool_plain(x, k, mul, add)
    for got, ref in ((stem, ref_stem), (pooled, ref_pooled)):
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_close(got, ref, dtype)


@pytest.mark.parametrize("shape,chunks", [
    ((1, 28, 36, 44, 1), 3),     # 7 pooled planes in ranges of 3, 3, 1
    ((2, 20, 20, 28, 1), 2),     # ranges of 3 and 2
    ((1, 20, 20, 20, 1), 4),     # ranges of 2, 2, 1 and one empty
])
def test_stem_pool_bf16_d_ranges(dev, shape, chunks):
    """The bf16 kernel with pooled D-ranges that do not divide D/4 (the
    first stem plane of a range recomputed below it, an empty range),
    through its C entry point; kernel A's bf16 bound."""
    rng = np.random.RandomState(14)
    x, k, mul, add = _stem_inputs(rng, shape, dev, torch.bfloat16)
    b, d, h, w, _ = shape
    stem = torch.empty((b, d // 2, h // 2, w // 2, 64), dtype=x.dtype,
                       device=dev)
    pooled = torch.empty((b, d // 4, h // 4, w // 4, 64), dtype=x.dtype,
                         device=dev)
    ws = stem_weights_s2d(k.to(torch.bfloat16))
    err = cuda_build.library().stem_pool(
        1, x.data_ptr(), ws.data_ptr(), mul.data_ptr(), add.data_ptr(),
        stem.data_ptr(), pooled.data_ptr(), b, d, h, w, chunks,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "stem_pool")
    torch.cuda.synchronize()
    ref_stem, ref_pooled = fused_stem_pool_plain(x, k, mul, add)
    for got, ref in ((stem, ref_stem), (pooled, ref_pooled)):
        _assert_close(got, ref, torch.bfloat16)


def _sums_inputs(shape, dtype, dev, seed=9):
    rng = np.random.RandomState(seed)
    dense = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
        dev, dtype)
    lung = torch.from_numpy(
        (rng.rand(*shape[:4], 1) > 0.4).astype(np.float32)).to(dev)
    return dense, lung


def _assert_sums_held(dense, lung, num, den):
    """Kernel F's bounds: the masked sums within 1e-5 relative of a float64
    sum (float32 sums in another order), the lung sums equal to the count
    of lung voxels."""
    ref = (dense.double() * lung.double()).sum((1, 2, 3))
    assert num.dtype == den.dtype == torch.float32 and num.shape == ref.shape
    err = (num.double() - ref).abs()
    assert torch.all(err <= 1e-5 * ref.abs())
    assert torch.equal(den.double(), lung.double().sum((1, 2, 3, 4)))


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 7, 9, 3), torch.float32),       # ragged, C = 3: the generic loop
    ((2, 5, 7, 9, 2), torch.float32),       # odd voxel count: generic loop
    ((1, 4, 6, 8, 1), torch.float32),       # C = 1, 16-byte loads
    ((2, 4, 6, 8, 4), torch.bfloat16),      # C = 4, bf16 read in the kernel
    ((2, 32, 56, 72, 2), torch.float32),    # C = 2, many voxel ranges
    ((1, 16, 28, 36, 5), torch.float32),    # many ranges, generic loop
])
def test_masked_sums_kernel_matches_plain(dev, shape, dtype):
    """Kernel F against its plain version: the masked sums within 1e-5
    relative of a float64 sum (both are float32 sums, in other orders), the
    lung sums equal to the count of lung voxels, and the same bits on a
    second run."""
    dense, lung = _sums_inputs(shape, dtype, dev)
    before = cuda_build.launches()["masked_sums"]
    num, den = masked_sums(dense, lung)
    num2, den2 = masked_sums(dense, lung)
    torch.cuda.synchronize()
    assert cuda_build.launches()["masked_sums"] == before + 2
    assert torch.equal(num, num2) and torch.equal(den, den2)
    ref = (dense.double() * lung.double()).sum((1, 2, 3))
    for got in (num, masked_sums_plain(dense, lung)[0]):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert ((got.double() - ref).abs() / ref.abs()).max().item() <= 1e-5
    assert torch.equal(den.double(), lung.double().sum((1, 2, 3, 4)))
    if shape[1] >= 16:
        assert masked_sums_splits(shape[0], int(np.prod(shape[1:4]))) > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [
    (2, 32, 56, 70, 2),     # ranges of 4048 voxels: a step holds 4096
    (2, 23, 40, 61, 1),     # C = 1: 8 bf16 voxels per load, 4 in flight
    (1, 20, 30, 44, 4),     # C = 4: one float32 voxel per load
])
def test_masked_sums_kernel_ragged_last_step(dev, dtype, shape):
    """The 16-byte loop where every range ends inside a thread's unrolled
    step (its loads past the end add nothing) and the last range is short,
    in float32 and bf16 maps."""
    n = int(np.prod(shape[1:4]))
    splits = masked_sums_splits(shape[0], n)
    chunk = -(-(-(-n // splits)) // 8) * 8          # the kernel's range
    vpl = (4 if dtype == torch.float32 else 8) // shape[-1]
    step = 256 * vpl * (4 if vpl > 4 else 8)         # MT * VPL * unroll
    assert splits > 1 and chunk % step and n % chunk
    dense, lung = _sums_inputs(shape, dtype, dev)
    _assert_sums_held(dense, lung, *masked_sums(dense, lung))


@pytest.mark.parametrize("case", ["offset view", "C=127", "empty lung"])
def test_masked_sums_kernel_edges(dev, case):
    """A dense view one float past a 16-byte boundary (the generic loop),
    C = 127 (the most the kernel takes), and a sample whose lung is empty
    (den = 0, num = 0)."""
    shape = (2, 6, 10, 12, 127) if case == "C=127" else (3, 16, 28, 36, 2)
    dense, lung = _sums_inputs(shape, torch.float32, dev)
    if case == "offset view":
        flat = torch.zeros(dense.numel() + 1, device=dev)
        flat[1:] = dense.reshape(-1)
        dense = flat[1:].view(shape)
        assert dense.data_ptr() % 16 == 4
    if case == "empty lung":
        lung[1] = 0.0
    num, den = masked_sums(dense, lung)
    _assert_sums_held(dense, lung, num, den)
    if case == "empty lung":
        assert den[1].item() == 0.0 and torch.all(num[1] == 0.0)
        assert torch.all(den[[0, 2]] > 0)


def test_masked_sums_kernel_back_to_back_bit_equal(dev):
    """Twenty calls in a row on one stream give the same bits: the final
    sum's order does not depend on which block finishes last, and every
    call leaves the tickets at zero for the next."""
    dense, lung = _sums_inputs((2, 32, 56, 72, 2), torch.float32, dev)
    outs = [masked_sums(dense, lung) for _ in range(20)]
    torch.cuda.synchronize()
    for num, den in outs[1:]:
        assert torch.equal(num, outs[0][0]) and torch.equal(den, outs[0][1])
    _assert_sums_held(dense, lung, *outs[0])


def test_masked_sums_kernel_in_a_cuda_graph(dev):
    """One call captured in a CUDA graph (its stream's tickets made before
    the capture, so the graph holds the kernel alone) and replayed three
    times: each replay bit-equal to an eager call, which shows that the
    kernel returns its tickets to zero."""
    dense, lung = _sums_inputs((2, 32, 56, 72, 2), torch.float32, dev)
    want = masked_sums(dense, lung)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        masked_sums(dense, lung)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        num, den = masked_sums(dense, lung)
    for _ in range(3):
        num.zero_()
        den.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(num, want[0]) and torch.equal(den, want[1])


def test_masked_sums_kernel_on_two_streams_at_once(dev):
    """Two calls in flight at once on two streams, each with its own
    tickets, give what each gives alone."""
    inputs = [_sums_inputs((2, 32, 56, 72, 2), torch.float32, dev, seed)
              for seed in (1, 2)]
    want = [masked_sums(d, l) for d, l in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for s, (d, l) in zip(streams, inputs):
        with torch.cuda.stream(s):
            got.append([masked_sums(d, l) for _ in range(5)])
    torch.cuda.synchronize()
    for calls, (wn, wd) in zip(got, want):
        for num, den in calls:
            assert torch.equal(num, wn) and torch.equal(den, wd)


@pytest.mark.parametrize("lung_shape", [(2, 8, 12, 16, 1), (2, 16, 24, 32, 1)])
def test_lung_masked_fraction_backward_on_the_card(dev, lung_shape):
    """The fraction and its gradient with respect to ``dense`` on the card
    (kernel F forward, PyTorch backward) against the CPU, at the dense
    resolution and through the nearest resize."""
    rng = np.random.RandomState(10)
    dense = rng.rand(2, 8, 12, 16, 2).astype(np.float32)
    lung = (rng.rand(*lung_shape) > 0.3).astype(np.float32)
    cot = rng.randn(2, 2).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        x = torch.from_numpy(dense).to(d).requires_grad_()
        y = lung_masked_fraction(x, torch.from_numpy(lung).to(d), eps=1e-3)
        (y * torch.from_numpy(cot).to(d)).sum().backward()
        out[str(d)] = (y.detach().cpu(), x.grad.cpu())
    (y_cpu, g_cpu), (y_gpu, g_gpu) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(y_gpu, y_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-6, atol=0)


# The bf16 tensor-core loop (csrc/mma_bf16.cuh) and the float32 FMA loop
# at the edges of their tiles: a K step of MMA_BK channels, 128 output
# voxels by 64 or 128 channels per block, a ring of MMA_STAGES steps.
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,residual,relu,dilation", [
    ((1, 5, 6, 7, 24), 40, False, True, 1),    # C = 24, 40: multiples of 8,
    ((1, 4, 7, 9, 40), 24, True, True, 1),     # not of the K step
    ((1, 3, 5, 9, 16), 136, True, False, 1),   # O = 136: 3 column tiles
    ((2, 3, 5, 7, 32), 13, False, False, 1),   # O = 13, M = 210
    ((1, 5, 7, 9, 24), 70, True, True, 2),     # ragged, dilated, 128 columns
    ((1, 6, 5, 11, 20), 16, False, True, 4),   # scalar gathers, dilation 4
    ((1, 4, 6, 8, 64), 128, True, True, 1),    # the 128-column tile
    ((1, 2, 9, 13, 576), 64, True, True, 1),   # 18 K steps per tap: 486 in
])                                             # all wrap the ring 121 times
def test_conv_affine_kernel_tile_edges(dev, dtype, shape, o, residual, relu,
                                       dilation):
    """Kernel A against its plain version at every masked edge of its
    tiles, in kernel A's bounds: f32 2e-5 of the peak, bf16 2 ulps."""
    rng = np.random.RandomState(11)
    c = shape[-1]
    x = _t(rng, shape, dev, 0.5, dtype)
    k = _t(rng, (3, 3, 3, c, o), dev, 0.1)
    sc = _t(rng, (o,), dev).abs() + 0.5
    sh = _t(rng, (o,), dev, 0.1)
    res = _t(rng, shape[:4] + (o,), dev, 0.5, dtype) if residual else None
    assert 27 * -(-c // MMA_BK) > MMA_STAGES
    before = cuda_build.launches()["conv3x3x3_affine"]
    got = roll_conv_affine_relu(x, k, sc, sh, residual=res, relu=relu,
                                dilation=dilation)
    torch.cuda.synchronize()
    assert cuda_build.launches()["conv3x3x3_affine"] == before + 1
    ref = roll_conv_affine_relu_plain(x, k, sc, sh, res, relu, dilation)
    assert got.dtype == dtype and got.shape == ref.shape
    _assert_close(got, ref, dtype)


def _wgrad_splits_of(x, g, splits):
    """Kernel D through its C entry point with ``splits`` voxel ranges of
    ``wgrad_chunk`` voxels each (the wrapper picks its own)."""
    b, d, h, w, c = x.shape
    o = g.shape[-1]
    out = torch.empty((3, 3, 3, c, o), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, 27 * c, o), dtype=torch.float32,
                     device=x.device)
    code = 0 if x.dtype == torch.float32 else 1
    err = cuda_build.library().conv3x3x3_wgrad(
        code, x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, d, h, w, c, o, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "conv3x3x3_wgrad")
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,o,splits", [
    ((2, 5, 7, 9, 20), 13, 30),    # 20 ranges of one step (the last 22
                                   # voxels), 10 empty; ragged C and O
    ((1, 4, 6, 10, 64), 32, 7),    # ranges of 2 steps, shorter than the
                                   # ring; the last 3 empty
    ((1, 3, 5, 7, 40), 24, 200),   # more ranges than voxels
])
def test_wgrad_kernel_short_and_empty_ranges(dev, dtype, shape, o, splits):
    """Kernel D with voxel ranges shorter than its ring, some of them empty
    (the first and last cases: more ranges than K steps): short ranges stop
    at their end, empty ones write zero partials; within 5e-5 of the peak
    of its plain version and bit-equal on a second run."""
    rng = np.random.RandomState(12)
    m = int(np.prod(shape[:4]))
    chunk = wgrad_chunk(m, splits)
    assert chunk < MMA_STAGES * WGRAD_K and chunk * (splits - 1) >= m
    x = _t(rng, shape, dev, 0.5, dtype)
    g = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    got = _wgrad_splits_of(x, g, splits)
    again = _wgrad_splits_of(x, g, splits)
    torch.cuda.synchronize()
    ref = conv3x3x3_wgrad_plain(x, g)
    assert (got - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wgrad_kernel_one_split_at_c2304(dev, dtype):
    """Kernel D at med3ddram50's us1.conv0 width (C = 2048 + 256): 486 row
    tiles exceed the block target, so the whole voxel range is one split;
    bound and bit-equal rerun as above."""
    rng = np.random.RandomState(15)
    shape, o = (1, 4, 6, 8, 2304), 64
    assert wgrad_splits(int(np.prod(shape[:4])), shape[-1], o) == 1
    x = _t(rng, shape, dev, 0.5, dtype)
    g = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    got = conv3x3x3_wgrad(x, g)
    again = conv3x3x3_wgrad(x, g)
    torch.cuda.synchronize()
    ref = conv3x3x3_wgrad_plain(x, g)
    assert (got - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
def test_wgrad_kernel_wraps_the_ring(dev, dtype):
    """Kernel D through its wrapper with voxel ranges of 9 K steps, which
    wrap the 4-stage ring twice; bound and bit-equal rerun as above."""
    rng = np.random.RandomState(13)
    shape, o = (2, 8, 16, 20, 64), 64
    m = int(np.prod(shape[:4]))
    splits = wgrad_splits(m, shape[-1], o)
    assert wgrad_chunk(m, splits) > 2 * MMA_STAGES * WGRAD_K
    x = _t(rng, shape, dev, 0.5, dtype)
    g = _t(rng, shape[:4] + (o,), dev, 0.5, dtype)
    got = conv3x3x3_wgrad(x, g)
    again = conv3x3x3_wgrad(x, g)
    torch.cuda.synchronize()
    ref = conv3x3x3_wgrad_plain(x, g)
    assert (got - ref).abs().max().item() <= 5e-5 * ref.abs().max().item()
    assert torch.equal(got, again)
