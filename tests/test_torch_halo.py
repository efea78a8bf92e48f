"""The spatial axis's halo math on the CPU, in one process (no ranks).

``parallel/spatial.py`` builds each H slab's halo from the edge strips that
every rank of the spatial group contributes (``assemble_halo``) and sends
the halo rows' gradients back to their owners (``halo_adjoint``).  Here
the strips are cut from a whole tensor by hand, for S = 2, 3 and 4 slabs:

- each extended slab equals the whole tensor's rows around the slab, the
  volume's edges clipped;
- an op of stride 1 or 2 and dilation 1, 2 or 4 (a 3^3 conv, the stem's
  k7 s2 p3 conv, the k3 s2 p1 max-pool) on each extended slab, cropped as
  ``halo_apply`` crops it, equals that slab of the op on the whole tensor
  (float64, within 1e-13: the library orders a conv's sums per shape);
- ``halo_adjoint`` is the adjoint of the assembly: for random ``x`` and
  ``g``, the sum over slabs of ``<assemble(x_s), g_s>`` equals that of
  ``<x_s, adjoint(g)_s>`` (float64);
- the x2 align_corners upsample of a slab with one halo row each side
  and the whole axis's interpolation rows (``windows``), and the nearest
  resize of a slab with its global rows, equal the slabs of the resize of
  the whole tensor; a window that reads outside its slab raises.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bodyct_dram_emph_subtype_tpu_torch.ops.resize import (
    resize_linear_matmul, resize_nearest)
from bodyct_dram_emph_subtype_tpu_torch.parallel.spatial import (
    assemble_halo, halo_adjoint, halo_bounds)

H = 48                 # 48 rows: slabs of 24, 16 and 12 at S = 2, 3, 4


def _strips(slabs, lo, hi):
    """Each slab's edge strip as ``_HaloExtend`` sends it: its first
    ``min(hi, h)`` rows, then its last ``min(lo, h)``."""
    h = slabs[0].shape[2]
    return [torch.cat([x[:, :, :min(hi, h)], x[:, :, h - min(lo, h):]], 2)
            for x in slabs]


def _x(seed, c=3, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, 4, H, 5, c), generator=g, dtype=dtype)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 0), (4, 2), (4, 4), (13, 9)])
def test_assembled_slab_is_the_whole_tensors_rows(n, lo, hi):
    x = _x(0)
    h = H // n
    slabs = list(x.split(h, dim=2))
    strips = _strips(slabs, lo, hi)
    for s in range(n):
        got, lo_eff, hi_eff = assemble_halo(slabs[s], strips, s, lo, hi)
        a = s * h
        assert lo_eff == min(lo, a) and hi_eff == min(hi, H - a - h)
        assert torch.equal(got, x[:, :, a - lo_eff:a + h + hi_eff])


def _conv(w, stride, dilation, pad):
    def op(x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, stride, pad,
                     dilation)
        return y.permute(0, 2, 3, 4, 1)
    return op


def _pool(x):
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 3, 2, 1)
    return y.permute(0, 2, 3, 4, 1)


OPS = {  # name: (kernel, stride, dilation, pad)
    "conv3_d1": (3, 1, 1, 1), "conv3_d2": (3, 1, 2, 2),
    "conv3_d4": (3, 1, 4, 4), "conv3_s2": (3, 2, 1, 1),
    "stem_k7_s2": (7, 2, 1, 3), "pool_k3_s2": (3, 2, 1, 1),
}


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_on_extended_slab_equals_whole(n, name):
    k, stride, dilation, pad = OPS[name]
    x = _x(1)
    if name.startswith("pool"):
        op = _pool
    else:
        g = torch.Generator().manual_seed(2)
        w = torch.randn((2, 3, k, k, k), generator=g, dtype=torch.float64)
        op = _conv(w, stride, dilation, pad)
    whole = op(x)
    h = H // n
    slabs = list(x.split(h, dim=2))
    lo, hi = halo_bounds(k, stride, dilation, pad)
    strips = _strips(slabs, lo, hi)
    for s in range(n):
        xe, lo_eff, _ = assemble_halo(slabs[s], strips, s, lo, hi)
        assert lo_eff % stride == 0
        got = op(xe).narrow(2, lo_eff // stride, h // stride)
        a = s * h // stride
        # float64: equal up to the order of the conv's sums, which the
        # library picks per shape; the pool's max is exact
        torch.testing.assert_close(got, whole[:, :, a:a + h // stride],
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 0), (4, 2), (4, 4), (13, 9)])
def test_adjoint_of_the_assembly(n, lo, hi):
    x = _x(3)
    h = H // n
    slabs = list(x.split(h, dim=2))
    strips = _strips(slabs, lo, hi)
    ext = [assemble_halo(slabs[s], strips, s, lo, hi) for s in range(n)]
    gen = torch.Generator().manual_seed(5)
    gys = [torch.randn(e[0].shape, generator=gen, dtype=torch.float64)
           for e in ext]
    # each slab's halo-row gradients as _HaloExtend gathers them: lo rows
    # above, hi below, rows beyond the volume zero
    grads = []
    for s, (_, lo_eff, hi_eff) in enumerate(ext):
        shape = list(gys[s].shape)
        shape[2] = lo + hi
        mine = torch.zeros(shape, dtype=torch.float64)
        mine[:, :, lo - lo_eff:lo] = gys[s][:, :, :lo_eff]
        mine[:, :, lo:lo + hi_eff] = gys[s][:, :, lo_eff + h:]
        grads.append(mine)
    lhs = sum((e[0] * gy).sum() for e, gy in zip(ext, gys))
    rhs = sum((slabs[s] * halo_adjoint(gys[s], grads, s, h, lo, hi)).sum()
              for s in range(n))
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_upsample_of_slabs_with_global_rows(n):
    x = _x(6, dtype=torch.float32)
    whole = resize_linear_matmul(x, (8, 2 * H, 10), (1, 2, 3),
                                 align_corners=True)
    h = H // n
    slabs = list(x.split(h, dim=2))
    strips = _strips(slabs, 1, 1)
    for s in range(n):
        xe, lo_eff, _ = assemble_halo(slabs[s], strips, s, 1, 1)
        got = resize_linear_matmul(
            xe, (8, 2 * h, 10), (1, 2, 3), align_corners=True,
            windows=[None, (s * h - lo_eff, 2 * s * h, H, 2 * H), None])
        assert torch.equal(got, whole[:, :, 2 * s * h:2 * (s + 1) * h]), s
    if n > 1:
        # without the halo the last output rows read the next slab
        with pytest.raises(ValueError, match="outside"):
            resize_linear_matmul(slabs[0], (8, 2 * h, 10), (1, 2, 3), True,
                                 windows=[None, (0, 0, H, 2 * H), None])


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("out", [H // 2, 2 * H])
def test_nearest_resize_of_slabs_with_global_rows(n, out):
    x = _x(7, c=1, dtype=torch.float32)
    whole = resize_nearest(x, (2, out, 3), (1, 2, 3))
    h, oh = H // n, out // n
    for s, slab in enumerate(x.split(h, dim=2)):
        got = resize_nearest(slab, (2, oh, 3), (1, 2, 3),
                             windows=[None, (s * h, s * oh, H, out), None])
        assert torch.equal(got, whole[:, :, s * oh:(s + 1) * oh]), s
    with pytest.raises(ValueError, match="outside"):
        resize_nearest(x[:, :, :h], (2, oh, 3), (1, 2, 3),
                       windows=[None, (0, oh, H, out), None])


def test_halo_bounds():
    # the stem k7 s2 p3: 3 rows above rounded up to 4, 2 below; the pool
    # k3 s2 p1: 1 above rounded up to 2, none below; layer4's d = 4: 4, 4
    assert halo_bounds(7, 2, 1, 3) == (4, 2)
    assert halo_bounds(3, 2, 1, 1) == (2, 0)
    assert halo_bounds(3, 1, 4, 4) == (4, 4)
    assert halo_bounds(1, 2, 1, 0) == (0, 0)
    assert np.all([halo_bounds(3, 1, d, d) == (d, d) for d in (1, 2, 4)])
