"""The per-sample transform framework of the port against the JAX
package's, on the CPU.

- The protocol: ``tests/test_transform_framework.py``'s eight cases on the
  port's classes (key dispatch, the probability gate, ``always_apply``,
  ``freeze_param``, ``Compose``'s seeds, ``ToDevice``/``ToHost``,
  ``repr``, the validators), ``Compose`` dealing each member a seed of its
  RandomState, and ``ToDevice``'s default device.
- Each transform through ``__call__``: the port given the seed that JAX's
  ``key_to_rng`` derives from a key draws the parameters JAX draws, and
  its outputs equal JAX's within the bounds of ``tests/test_ops_*.py``:
  windowing and noise 1e-6, ``Standardize`` and ``GaussianSmooth`` rtol
  1e-4 / atol 1e-5, contrast 1e-5 / 1e-6, crop-resize 1e-5, resize rtol
  1e-4 / atol 1e-4 of the volume's peak; flips, cut-outs and every mask
  bit-equal.  ``GaussianAdditive`` is held with the port given JAX's
  N(0, 1) field as ``eps`` (torch and ``jax.random`` draw other fields).
- The ops beneath them against JAX: ``axis_aligned_grid_sample`` by
  gather and by matmul, ``crop_and_resize``, ``grid_sample_3d``,
  ``interpolate_volume`` (both modes, true extents), ``upsample_trilinear``,
  ``gaussian_kernel_1d``, an n-D ``box_cutout``; ``binary_dilate``,
  ``mask_bbox`` and ``pad_bbox_mm`` against JAX and scipy.
- Both ``build_pipeline`` chains against JAX's: the eval chain as it is,
  the train chain on a key where all four random transforms apply, with
  the port's transforms frozen on JAX's drawn parameters (and its noise
  field).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from bodyct_dram_emph_subtype_tpu import transforms as jt
from bodyct_dram_emph_subtype_tpu.ops import grid_sample as jgs
from bodyct_dram_emph_subtype_tpu.ops import intensity as jint
from bodyct_dram_emph_subtype_tpu.ops import morphology as jmorph
from bodyct_dram_emph_subtype_tpu.ops import resize as jres
from bodyct_dram_emph_subtype_tpu_torch import transforms as tt
from bodyct_dram_emph_subtype_tpu_torch.ops import grid_sample as tgs
from bodyct_dram_emph_subtype_tpu_torch.ops import intensity as tint
from bodyct_dram_emph_subtype_tpu_torch.ops import morphology as tmorph
from bodyct_dram_emph_subtype_tpu_torch.ops import resize as tres


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- 1. the protocol (tests/test_transform_framework.py on the port) ----

class _MarkImage(tt.ImageOnlyTransform):
    def __init__(self, p=0.5, always_apply=False):
        super().__init__(p, always_apply)

    def apply_to_image(self, data):
        return data + 1


def _data():
    return {"image": np.zeros((4, 4), np.float32),
            "lung_mask": np.zeros((4, 4), np.float32),
            "uid": "x", "cls_label": 3}


def test_key_semantic_dispatch():
    out = _MarkImage(always_apply=True)(_data())
    assert (out["image"] == 1).all()
    assert (out["lung_mask"] == 0).all()
    assert out["uid"] == "x" and out["cls_label"] == 3


def test_probability_gate_statistics():
    t = _MarkImage(p=0.5)
    applied = sum(int(t(_data(), rng=i)["image"].max() > 0)
                  for i in range(200))
    assert 60 < applied < 140


def test_always_apply_overrides_p():
    out = _MarkImage(p=0.0, always_apply=True)(_data(), rng=0)
    assert (np.asarray(out["image"]) == 1).all()


def test_freeze_param_reuses_cached_params(rng):
    t = tt.Flip(1.0, True, dim=(1, 3))
    data = {"image": rng.randn(4, 6, 8).astype(np.float32)}
    out1 = t(dict(data), rng=0)
    combs = list(t.params["combs"])
    t.freeze_param = True
    out2 = t(dict(data), rng=99)         # the seed must be ignored
    assert list(t.params["combs"]) == combs
    assert torch.equal(out1["image"], out2["image"])


def test_compose_deals_seeds_deterministically(rng):
    data = {"image": rng.randn(6, 8, 10).astype(np.float32)}
    chain = tt.Compose([tt.GaussianAdditive(p=1.0),
                        tt.BoxMaskOut(1.0, True, n_masks=(1, 4))])
    a = chain(dict(data), rng=5)
    b = chain(dict(data), rng=np.random.RandomState(5))
    assert torch.equal(a["image"], b["image"])
    c = chain(dict(data), rng=6)
    assert not torch.allclose(a["image"], c["image"])


def test_compose_deals_each_member_a_seed_of_its_randomstate(rng):
    data = {"image": rng.randn(6, 8, 10).astype(np.float32)}
    members = [tt.Flip(0.5, False, dim=(1, 3)),
               tt.CropAndResize(0.5, False, (0.45, 0.55), (0.95, 1.0))]
    tt.Compose(members)(dict(data), rng=11)
    got = [dict(m.params) for m in members]
    for m, seed in zip(members, np.random.RandomState(11).randint(
            0, 2 ** 31 - 1, size=2)):
        m.params = {}
        m(dict(data), rng=int(seed))
    assert got == [m.params for m in members]


def test_to_device_to_host_roundtrip(rng):
    data = {"image": rng.randn(3, 3).astype(np.float32), "uid": "u"}
    dev = tt.ToDevice("cpu")(data)
    assert isinstance(dev["image"], torch.Tensor)
    host = tt.ToHost()(dev)
    assert isinstance(host["image"], np.ndarray)
    np.testing.assert_array_equal(host["image"], data["image"])
    assert host["uid"] == "u"


def test_to_device_default_is_the_card():
    if torch.cuda.is_available():
        assert tt.ToDevice().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.ToDevice()
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.build_pipeline((8, 8, 8), train=False)


def test_repr_serialization():
    s = repr(tt.IntensityWindow(from_span=(-1150, -300), to_span=(0, 1)))
    assert "IntensityWindow" in s and "from_span" in s


def test_validator_errors():
    with pytest.raises(ValueError):
        tt.BaseTransform.check_range((5, 1), "bad")
    with pytest.raises(ValueError):
        tt.BaseTransform.check_positive_range((-1, 2), "bad")


# ---- 2. each transform against JAX's ----

def _seed(key):
    """The seed of the RandomState that JAX's ``key_to_rng`` makes of
    ``key``."""
    return int(np.asarray(jax.random.key_data(key)).astype(np.uint32)
               .ravel()[-1]) & 0x7FFFFFFF


def _ct(rng, shape=(13, 17, 19)):
    ct = rng.randint(-1300, -200, shape).astype(np.int16)
    return {"image": ct, "lung_mask": rng.rand(*shape) > 0.4,
            "em_mask": rng.rand(*shape) > 0.8, "uid": "u"}


def _float(rng, shape=(12, 14, 16)):
    return {"image": (rng.randn(*shape) * 7 + 3).astype(np.float32),
            "lung_mask": rng.rand(*shape) > 0.4}


def _unit(rng, shape=(6, 7, 8)):
    return {"image": rng.rand(*shape).astype(np.float32)}


# name -> (make(module), data, (rtol, atol, scaled by the peak?))
CASES = {
    "IntensityWindow": (lambda m: m.IntensityWindow((-1150, -300), (0, 1)),
                        _ct, (1e-6, 1e-6, False)),
    "Standardize": (lambda m: m.Standardize(), _float, (1e-4, 1e-5, False)),
    "ContrastStretching": (lambda m: m.ContrastStretching(1.0, True),
                           _unit, (1e-5, 1e-6, False)),
    "ContrastStretching_slices": (
        lambda m: m.ContrastStretching(1.0, True, rescale=True,
                                      spatial_dimension_index=1),
        _unit, (1e-5, 1e-6, False)),
    "GaussianSmooth": (lambda m: m.GaussianSmooth(1.0, True), _float,
                       (1e-4, 1e-5, False)),
    "GaussianAdditive": (lambda m: m.GaussianAdditive(1.0, True), _float,
                         (1e-6, 1e-6, True)),
    "BoxMaskOut": (lambda m: m.BoxMaskOut(1.0, True, n_masks=(1, 10)),
                   _float, (0, 0, False)),
    "Interpolate": (lambda m: m.Interpolate((8, 16, 24),
                                            align_corners=True),
                    _float, (1e-4, 1e-4, True)),
    "Interpolate_3d": (lambda m: m.Interpolate((8, 10, 24),
                                               only_in_plane=False),
                       _float, (1e-4, 1e-4, True)),
    "Interpolate_int16": (lambda m: m.Interpolate((8, 16, 24),
                                                  align_corners=True),
                          _ct, (0, 1, False)),
    "Flip": (lambda m: m.Flip(1.0, True, dim=(1, 3)), _float, (0, 0, False)),
    "CropAndResize": (lambda m: m.CropAndResize(
        1.0, True, (0.3, 0.7), (0.5, 0.9), align_corners=True),
        _float, (1e-5, 1e-5, False)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_jax(name, key=7):
    make, data_fn, (rtol, atol, peak) = CASES[name]
    data = data_fn(np.random.RandomState(key))
    jtr, ttr = make(jt), make(tt)
    k = jax.random.PRNGKey(key)
    want = jtr(dict(data), key=k)
    got = ttr(dict(data), rng=_seed(k))
    assert set(got) == set(want)
    params = {n: v for n, v in ttr.params.items()}
    assert params.keys() == jtr.params.keys()
    for n, v in jtr.params.items():
        np.testing.assert_array_equal(np.asarray(params[n]), np.asarray(v),
                                      err_msg=n)
    if name == "GaussianAdditive":
        ttr.params["eps"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(ttr.params["noise_seed"]),
            data["image"].shape, jnp.float32))
        got = ttr.apply_with_params({}, dict(data))
    for n, w in want.items():
        if not isinstance(w, (np.ndarray, jax.Array)):
            assert got[n] == w
            continue
        g, w = _np(got[n]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        if "mask" in n or atol == 0:
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            scale = np.abs(w).max() if peak else 1.0
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale,
                                       err_msg=n)


def test_gaussian_additive_op_matches_jax_on_one_field(rng):
    img = (rng.randn(9, 10, 11) * 50 - 700).astype(np.float32)
    eps = rng.randn(*img.shape).astype(np.float32)
    want = jint.gaussian_additive_noise(jnp.asarray(img), None, 0.045,
                                        eps=jnp.asarray(eps))
    got = tint.gaussian_additive_noise(torch.from_numpy(img), 0.045,
                                       torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(img).max())


# ---- 3. the ops beneath them ----

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("via", ["gather", "matmul"])
def test_axis_aligned_grid_sample_matches_jax(rng, mode, via):
    vol = rng.randn(9, 13, 11).astype(np.float32)
    if mode == "nearest":
        vol = (vol > 0).astype(np.float32)
    box = np.asarray([[0.1, 0.9], [0.05, 1.0], [0.2, 0.7]], np.float32)
    out = (7, 15, 11)
    for ac in (True, False):
        want = jgs.axis_aligned_grid_sample(jnp.asarray(vol),
                                            jnp.asarray(box), out, mode, ac,
                                            via=via)
        got = tgs.axis_aligned_grid_sample(torch.from_numpy(vol),
                                           torch.from_numpy(box), out, mode,
                                           ac, via=via)
        if mode == "nearest":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("via", ["gather", "matmul"])
def test_crop_and_resize_matches_jax(rng, via):
    vol = rng.randn(17, 23, 19).astype(np.float32)
    mask = rng.rand(17, 23, 19) > 0.5
    for center, size in (((0.45, 0.55, 0.5), (0.95, 0.97, 1.0)),
                         ((0.3, 0.7, 0.5), (0.5, 0.6, 0.8))):
        c, s = np.float32(center), np.float32(size)
        want = jgs.crop_and_resize(jnp.asarray(vol), jnp.asarray(c),
                                   jnp.asarray(s), False, via=via)
        got = tgs.crop_and_resize(torch.from_numpy(vol), c, s, False,
                                  via=via)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        want = jgs.crop_and_resize(jnp.asarray(mask), jnp.asarray(c),
                                   jnp.asarray(s), True, via=via)
        got = tgs.crop_and_resize(torch.from_numpy(mask), c, s, True,
                                  via=via)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [0, 2])
def test_grid_sample_3d_matches_jax(rng, mode, channels):
    vol = rng.randn(9, 11, 13, *([channels] if channels else [])
                    ).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (5, 6, 7, 3)).astype(np.float32)
    for ac in (False, True):
        want = jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid), mode,
                                  ac)
        got = tgs.grid_sample_3d(torch.from_numpy(vol),
                                 torch.from_numpy(grid), mode, ac)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_interpolate_volume_and_upsample_match_jax(rng):
    vol = rng.randn(2, 11, 14, 17).astype(np.float32)
    mask = (rng.rand(11, 14, 17) > 0.5).astype(np.float32)
    for only_in_plane in (True, False):
        for ac in (True, False):
            want = jres.interpolate_volume(jnp.asarray(vol), (6, 20, 9),
                                           False, only_in_plane, ac)
            got = tres.interpolate_volume(torch.from_numpy(vol), (6, 20, 9),
                                          False, only_in_plane, ac)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4,
                                       atol=1e-4 * np.abs(vol).max())
        want = jres.interpolate_volume(jnp.asarray(mask), (6, 20, 9), True,
                                       only_in_plane, in_sizes=(9, 12, 15))
        got = tres.interpolate_volume(torch.from_numpy(mask), (6, 20, 9),
                                      True, only_in_plane,
                                      in_sizes=(9, 12, 15))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)
    want = jres.upsample_trilinear(jnp.asarray(x), (6, 8, 9))
    got = tres.upsample_trilinear(torch.from_numpy(x), (6, 8, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_intensity_ops_match_jax(rng):
    x = rng.randint(-2048, 1000, (13, 17, 19)).astype(np.int16)
    for span in ((-1150, -300), None):
        np.testing.assert_allclose(
            tint.intensity_window(torch.from_numpy(x), span, (0, 1)).numpy(),
            np.asarray(jint.intensity_window(jnp.asarray(x), span, (0, 1))),
            rtol=1e-6, atol=1e-6)
    for sigma in (0.5, 0.8, 2.0):
        np.testing.assert_allclose(
            tint.gaussian_kernel_1d(sigma).numpy(),
            np.asarray(jint.gaussian_kernel_1d(sigma)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(16, 20), (6, 8, 10, 4)])
def test_box_cutout_nd_matches_jax(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    centers = rng.uniform(0.2, 0.8, (3, len(shape))).astype(np.float32)
    sizes = rng.uniform(0.1, 0.5, (3, len(shape))).astype(np.float32)
    valid = np.asarray([True, True, False])
    want = jint.box_cutout(jnp.asarray(x), jnp.asarray(centers),
                           jnp.asarray(sizes), jnp.asarray(valid))
    got = tint.box_cutout(torch.from_numpy(x), torch.from_numpy(centers),
                          torch.from_numpy(sizes), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(12, 14, 16), (20, 22)])
def test_binary_dilate_matches_jax_and_scipy(rng, shape):
    m = rng.rand(*shape) > 0.95
    for it in (0, 1, 2):
        got = _np(tmorph.binary_dilate(torch.from_numpy(m), it))
        np.testing.assert_array_equal(got, np.asarray(
            jmorph.binary_dilate(jnp.asarray(m), it)))
        if it:
            np.testing.assert_array_equal(got, ndimage.binary_dilation(
                m, ndimage.generate_binary_structure(len(shape),
                                                     len(shape)),
                iterations=it))


def test_mask_bbox_and_padding_match_jax_and_the_host_crops():
    m = np.zeros((20, 30, 40), bool)
    m[3:9, 10:22, 5:31] = True
    spacing = (2.0, 0.7, 0.7)
    bbox = tmorph.mask_bbox(torch.from_numpy(m))
    np.testing.assert_array_equal(bbox.numpy(),
                                  np.asarray(jmorph.mask_bbox(
                                      jnp.asarray(m))))
    padded = tmorph.pad_bbox_mm(bbox, m.shape, spacing, 5)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(
        jmorph.pad_bbox_mm(jnp.asarray(bbox.numpy()), m.shape, spacing, 5)))
    for sl, (start, stop) in zip(tmorph.find_crops_np(m, spacing, 5),
                                 padded.tolist()):
        assert (sl.start, sl.stop) == (start, stop)
    empty = np.zeros((4, 5, 6), bool)
    np.testing.assert_array_equal(
        tmorph.mask_bbox(torch.from_numpy(empty)).numpy(),
        np.asarray(jmorph.mask_bbox(jnp.asarray(empty))))


# ---- 4. the pipelines ----

def _sample(rng):
    shape = (20, 30, 36)
    ct = rng.randint(-1250, -250, shape).astype(np.int16)
    lung = rng.rand(*shape) > 0.3
    return {"image": ct, "lung_mask": lung, "em_mask": (ct < -950) & lung,
            "uid": "u"}


def _assert_sample_close(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        if not isinstance(w, jax.Array):
            assert got[n] == w
            continue
        g, w = _np(got[n]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, n
        if "mask" in n:
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=n)


def test_eval_pipeline_matches_jax():
    data = _sample(np.random.RandomState(3))
    want = jt.build_pipeline((8, 16, 24), train=False)(
        dict(data), key=jax.random.PRNGKey(0))
    got = tt.build_pipeline((8, 16, 24), train=False, device="cpu")(
        dict(data), rng=0)
    _assert_sample_close(got, want)


def test_train_pipeline_matches_jax_on_frozen_params():
    """JAX's chain on the first key where all four random members apply;
    the port's members frozen on the parameters they drew."""
    data = _sample(np.random.RandomState(4))
    for k in range(64):
        chain = jt.build_pipeline((8, 16, 24), train=True)
        want = chain(dict(data), key=jax.random.PRNGKey(k))
        if all(t.params for t in chain.transforms[4:]):
            break
    port = tt.build_pipeline((8, 16, 24), train=True, device="cpu")
    for jtr, ttr in zip(chain.transforms, port.transforms):
        ttr.params = dict(jtr.params)
        ttr.freeze_param = True
    noise = port.transforms[4]
    noise.params["eps"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(noise.params["noise_seed"]), (8, 16, 24),
        jnp.float32))
    _assert_sample_close(port(dict(data), rng=0), want)
