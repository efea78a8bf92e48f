"""The port's conv-mode ops (kernel A's plain version on the CPU) against
the JAX package's Pallas kernels 10-12 in interpret mode, and the port's
copies of the JAX gates against the originals.

- ``pallas_conv3d``, ``tap_conv3d``, ``flat_conv3d``: value and both
  gradients (the port's backward runs the conv's own gradients, the JAX
  custom VJPs differentiate the XLA conv) at the shapes of
  ``tests/test_pallas_kernels.py`` (weights He-scaled, so the outputs are
  O(1)); float32 rtol 1e-4 / atol 1e-4, the gradients rtol 1e-3 / atol
  1e-2, the tolerances of those tests.
- The dilated conv of layer3/4: the port's ``flat_conv3d`` at dilation 2
  and 4 on the logical tensor against JAX's ``DilatedConv3d`` under conv
  mode ``flat``, which runs the Pallas kernel on the space-to-batch
  subgrids; rtol 1e-4 / atol 1e-4.
- The gates (``supports_pallas_conv3d``, ``supports_tap_conv3d``,
  ``supports_flat_conv``, ``supports_fused_stem``,
  ``supports_maxpool_quads``, ``stem_quad_supported``) equal the JAX ones
  on a grid of shapes that holds every conv site of med3ddram at the
  deployment shape (as the JAX package convolves it) and at B = 1, 2, 4,
  in both itemsizes.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import packed as jpacked
from bodyct_dram_emph_subtype_tpu.ops import flat_conv as jfc
from bodyct_dram_emph_subtype_tpu.ops import maxpool_kernel as jmp
from bodyct_dram_emph_subtype_tpu.ops import pallas_conv as jpc
from bodyct_dram_emph_subtype_tpu.ops import stem_kernel as jsk
from bodyct_dram_emph_subtype_tpu.ops import tap_conv as jtc
from bodyct_dram_emph_subtype_tpu_torch.models import blocks as tblocks
from bodyct_dram_emph_subtype_tpu_torch.models import experimental as texp
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import \
    conv3d_apply_sites
from bodyct_dram_emph_subtype_tpu_torch.ops import flat_conv as tfc
from bodyct_dram_emph_subtype_tpu_torch.ops import maxpool_kernel as tmp
from bodyct_dram_emph_subtype_tpu_torch.ops import pallas_conv as tpc
from bodyct_dram_emph_subtype_tpu_torch.ops import stem_kernel as tsk
from bodyct_dram_emph_subtype_tpu_torch.ops import tap_conv as ttc

OPS = {
    "pallas": (jpc.pallas_conv3d, tpc.pallas_conv3d,
               (2, 4, 14, 12, 6), (3, 3, 3, 6, 16)),
    "tapmm": (jtc.tap_conv3d, ttc.tap_conv3d,
              (2, 4, 8, 24, 6), (3, 3, 3, 6, 16)),
    "flat": (jfc.flat_conv3d, tfc.flat_conv3d,
             (2, 4, 7, 9, 128), (3, 3, 3, 128, 128)),
}


@pytest.mark.parametrize("mode", sorted(OPS))
def test_conv_mode_op_matches_pallas(mode):
    jop, top, xshape, kshape = OPS[mode]
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    # He-scaled weights keep the outputs O(1), where atol 1e-4 bites
    k = (rng.randn(*kshape) / np.sqrt(27 * kshape[3])).astype(np.float32)
    g = rng.randn(*xshape[:4], kshape[-1]).astype(np.float32)

    def loss(a, b):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jop(a, b) * g)

    with pltpu.force_tpu_interpret_mode():
        want = jop(jnp.asarray(x), jnp.asarray(k))
    with jax.default_matmul_precision("highest"):
        jdx, jdk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    got = top(tx, tk)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for mine, ref in ((tx.grad, jdx), (tk.grad, jdk)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("dilation", [2, 4])
def test_dilated_flat_conv_matches_space_to_batch_pallas(monkeypatch,
                                                         dilation):
    """layer3/4's conv: JAX pads to multiples of d, folds the d^3 subgrids
    into the batch and runs the plane-flat kernel there; the port runs
    kernel A's dilated conv on the logical (1, 8, 12, 16, 128) tensor."""
    rng = np.random.RandomState(dilation)
    x = rng.randn(1, 8, 12, 16, 128).astype(np.float32)
    mod = jblocks.DilatedConv3d(128, dilation=dilation)
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "direct")
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "flat")
    calls = []
    impl = jfc._flat_conv_impl

    def rec(x, kernel, *args, **kw):
        calls.append(tuple(x.shape))
        return impl(x, kernel, *args, **kw)

    monkeypatch.setattr(jfc, "_flat_conv_impl", rec)
    with pltpu.force_tpu_interpret_mode():
        want = mod.apply(variables, jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    assert calls == [tblocks.jax_conv_shape(x.shape, dilation)]
    assert tblocks.mode_conv_op("flat", x.shape, kernel.shape, (1, 1, 1),
                                dilation, 4) is tfc.flat_conv3d
    got = tfc.flat_conv3d(torch.from_numpy(x), torch.from_numpy(kernel),
                          dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _grid_shapes():
    """(shape, kernel shape) of every med3ddram conv at 128x224x288 as the
    JAX package convolves it, at B = 1, 2, 4, plus a few odd shapes."""
    model = get_model_by_name("med3ddram")
    out = set()
    for b in (1, 2, 4):
        for _, shape, conv in conv3d_apply_sites(model, b, (128, 224, 288)):
            k = tuple(conv.kernel_size) + (conv.in_channels,
                                           conv.out_channels)
            out.add((tblocks.jax_conv_shape(shape, conv.dilation[0]), k))
    out |= {((2, 4, 14, 12, 6), (3, 3, 3, 6, 16)),
            ((2, 4, 8, 24, 6), (3, 3, 3, 6, 16)),
            ((1, 3, 8, 26, 8), (3, 3, 3, 8, 32)),
            ((2, 4, 7, 9, 128), (3, 3, 3, 128, 256)),
            ((2, 16, 28, 36, 128), (3, 3, 3, 128, 128)),
            ((1, 4, 8, 9, 8), (3, 3, 3, 8, 16)),
            ((2, 4, 7, 9, 64), (3, 3, 3, 64, 128))}
    return sorted(out)


GATES = {
    "pallas": (lambda s, k, i: jpc.supports_pallas_conv3d(s, k, (1, 1, 1), i),
               lambda s, k, i: tpc.supports_pallas_conv3d(s, k, (1, 1, 1), i)),
    "tapmm": (lambda s, k, i: jtc.supports_tap_conv3d(s, k, (1, 1, 1), i),
              lambda s, k, i: ttc.supports_tap_conv3d(s, k, (1, 1, 1), i)),
    "flat": (jfc.supports_flat_conv, tfc.supports_flat_conv),
}


@pytest.mark.parametrize("mode", sorted(GATES))
def test_conv_mode_gates_equal_jax(mode):
    jgate, tgate = GATES[mode]
    shapes = _grid_shapes()
    assert len(shapes) > 20
    seen = set()
    for (shape, kshape), itemsize in itertools.product(shapes, (2, 4)):
        want = jgate(shape, kshape, itemsize)
        assert tgate(shape, kshape, itemsize) == want, (shape, kshape,
                                                        itemsize)
        seen.add(want)
    assert seen == {True, False}


def test_stem_gates_equal_jax(monkeypatch):
    inputs = [(b, d, h, w, 1) for b in (1, 2, 4)
              for d, h, w in ((128, 224, 288), (16, 24, 32), (16, 32, 56),
                              (8, 32, 32), (16, 32, 32), (16, 32, 30),
                              (18, 32, 32), (32, 48, 64), (64, 96, 128))]
    for floor in (jpacked._ROLL_MIN_ELEMS, 0):
        monkeypatch.setattr(jpacked, "_ROLL_MIN_ELEMS", floor)
        monkeypatch.setattr(texp, "_ROLL_MIN_ELEMS", floor)
        for shape, itemsize in itertools.product(inputs, (2, 4)):
            assert tsk.supports_fused_stem(shape, 64, itemsize) \
                == jsk.supports_fused_stem(shape, 64, itemsize), shape
            assert texp.stem_quad_supported(shape, 64, itemsize) \
                == jpacked.stem_quad_supported(shape, 64, itemsize), shape
            b, d, h, w, _ = shape
            quads = (b, d // 2, h // 2, w // 8, 256)
            assert tmp.supports_maxpool_quads(quads, itemsize) \
                == jmp.supports_maxpool_quads(quads, itemsize), quads


def test_set_conv3d_mode_takes_every_mode():
    """The JAX setter asserts ``flat`` away though ``conv3d_apply`` and
    ``$BODYCT_CONV3D_MODE`` reach it; the port's setter takes it."""
    before = tblocks.get_conv3d_mode()
    try:
        for mode in tblocks.CONV3D_MODES:
            tblocks.set_conv3d_mode(mode)
            assert tblocks.get_conv3d_mode() == mode
        with pytest.raises(ValueError, match="unknown conv3d mode"):
            tblocks.set_conv3d_mode("fast")
    finally:
        tblocks.set_conv3d_mode(before)
    before = jblocks.get_conv3d_mode()
    with pytest.raises(AssertionError):
        jblocks.set_conv3d_mode("flat")
    assert jblocks.get_conv3d_mode() == before
