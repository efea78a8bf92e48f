"""Which convs the JAX package's train step routes through its kernels 6
(``roll_conv_packed``: ``_roll_conv_impl`` forward and dgrad) and 7
(``roll_conv_wgrad``) at the deployment shape, against the port's
``TRAIN_ROLL_SITES``.

The JAX ``med3ddram`` is built as the production train config runs it
(B=2, 128x224x288, bf16, ``packed_decoder=True``, conv mode ``roll``), its
variables come from ``jax.eval_shape(model.init)``, and ``jax.eval_shape``
of ``jax.grad`` of the train forward is traced with recorders around the
two kernel entry points: abstract, so no FLOP runs.  ``make_reg_train_step``
is not used: its ``_dense_map_size`` traces the eval forward, which would
record the eval kernels too.  Expected: 11 forward calls, 11 dgrad calls
(us3's through the lane-padded roll path) and 10 wgrad calls (us3's
2*32 packed gradient lanes go to XLA); the port sends all 11 wgrads through
kernel D.
"""
import collections

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype_tpu.models import blocks as jblocks
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.ops import roll_conv as jrc
from bodyct_dram_emph_subtype_tpu.parallel import mesh as jmesh
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    TRAIN_ROLL_SITES, train_roll_site_shapes)

B, SIZE = 2, (128, 224, 288)


def _logical(packed_shape):
    b, d, h, wh, c2 = packed_shape
    return (b, d, h, 2 * wh, c2 // 2)


def test_train_roll_sites_equal_the_jax_kernel_sites(monkeypatch):
    monkeypatch.setattr(jblocks, "_CONV3D_MODE", "roll")
    monkeypatch.setattr(jmesh, "_ACTIVE_MESH", None)
    model = jax_model("med3ddram", dtype=jnp.bfloat16, packed_decoder=True,
                      remat="none")
    x = jax.ShapeDtypeStruct((B, *SIZE, 1), jnp.float32)
    variables = jax.eval_shape(
        lambda a: model.init(jax.random.PRNGKey(0), a, a, train=False), x)

    calls = []
    impl, wgrad = jrc._roll_conv_impl, jrc.roll_conv_wgrad

    def rec_impl(xp, kernel, *args, **kw):
        calls.append(("impl", tuple(xp.shape), tuple(kernel.shape)))
        return impl(xp, kernel, *args, **kw)

    def rec_wgrad(xp, g, kernel_shape, *args, **kw):
        calls.append(("wgrad", tuple(xp.shape), tuple(kernel_shape)))
        return wgrad(xp, g, kernel_shape, *args, **kw)

    monkeypatch.setattr(jrc, "_roll_conv_impl", rec_impl)
    monkeypatch.setattr(jrc, "roll_conv_wgrad", rec_wgrad)

    def loss(params, stats, x, lungs):
        (dense, regs), _ = model.apply(
            {"params": params, "batch_stats": stats},
            x, lungs, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(d) for d in dense) + sum(jnp.sum(r) for r in regs)

    jax.eval_shape(jax.grad(loss), variables["params"],
                   variables["batch_stats"], x, x)

    impls = [c for c in calls if c[0] == "impl"]
    wgrads = [c for c in calls if c[0] == "wgrad"]
    assert len(impls) == 22 and len(wgrads) == 10
    # the custom VJP's forwards are all traced before any backward
    fwd, dgrad = impls[:11], impls[11:]

    sites = train_roll_site_shapes(B, SIZE)
    assert len(sites) == len(TRAIN_ROLL_SITES) == 11
    want_fwd = collections.Counter((shape, (3, 3, 3, shape[-1], o))
                                   for _, shape, o in sites)
    got_fwd = collections.Counter((_logical(s), k) for _, s, k in fwd)
    assert got_fwd == want_fwd

    # dgrad: the same conv on the output gradient, I/O-transposed weights;
    # us3's 2*32-lane gradient goes through the lane-padded roll path
    # (each parity block zero-extended to 64 channels, kernel rows zeroed)
    want_dgrad = collections.Counter()
    for name, shape, o in sites:
        out = shape[:4] + (o,)
        if name == "us3.0":
            want_dgrad[(shape[:4] + (2 * o,), (3, 3, 3, 2 * o, shape[-1]))] \
                += 1
        else:
            want_dgrad[(out, (3, 3, 3, o, shape[-1]))] += 1
    got_dgrad = collections.Counter((_logical(s), k) for _, s, k in dgrad)
    assert got_dgrad == want_dgrad

    want_wgrad = collections.Counter(
        (shape, (3, 3, 3, shape[-1], o)) for name, shape, o in sites
        if name != "us3.0")
    got_wgrad = collections.Counter((_logical(s), k) for _, s, k in wgrads)
    assert got_wgrad == want_wgrad
    # us3's wgrad really is the one that stays on XLA
    us3 = [s for s in sites if s[0] == "us3.0"][0]
    assert not jrc.supports_roll_wgrad(
        (B, *us3[1][1:3], us3[1][3] // 2, 2 * us3[1][4]),
        (3, 3, 3, us3[1][4], us3[2]))
