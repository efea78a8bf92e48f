"""The port's device preprocess, resize/pool ops and numpy host layer
against the JAX package's functions on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data import datasets as jds
from bodyct_dram_emph_subtype_tpu.data import host_preprocess as jhp
from bodyct_dram_emph_subtype_tpu.data import mha as jmha
from bodyct_dram_emph_subtype_tpu.ops import masked_pool as jmp
from bodyct_dram_emph_subtype_tpu.ops import morphology as jmo
from bodyct_dram_emph_subtype_tpu.ops import preprocess as jpre
from bodyct_dram_emph_subtype_tpu.ops import resize as jrs
from bodyct_dram_emph_subtype_tpu_torch.data import datasets as tds
from bodyct_dram_emph_subtype_tpu_torch.data import host_preprocess as thp
from bodyct_dram_emph_subtype_tpu_torch.data import mha as tmha
from bodyct_dram_emph_subtype_tpu_torch.ops import masked_pool as tmp
from bodyct_dram_emph_subtype_tpu_torch.ops import morphology as tmo
from bodyct_dram_emph_subtype_tpu_torch.ops import preprocess as tpre
from bodyct_dram_emph_subtype_tpu_torch.ops import resize as trs
from bodyct_dram_emph_subtype_tpu_torch.utils.viz import windowing


def test_fused_preprocess_preselected_matches_jax():
    """Image within 1e-5 absolute, lung and em masks bit-equal, for two
    scans of different true in-plane extents in one padded buffer."""
    rng = np.random.RandomState(0)
    target = (6, 20, 28)
    raw = rng.randint(-1300, -200, (2, 6, 40, 48)).astype(np.int16)
    in_sizes = np.asarray([[6, 33, 47], [6, 40, 29]], np.int32)
    for i, (_, h, w) in enumerate(in_sizes):
        raw[i, :, h:, :] = -2048
        raw[i, :, :, w:] = -2048
    lungs = (rng.rand(2, *target) > 0.4).astype(np.uint8)
    moments = np.stack([thp.window_moments_np(raw[i, :, :h, :w])
                        for i, (_, h, w) in enumerate(in_sizes)])
    want = jpre.fused_preprocess_preselected(
        jnp.asarray(raw), jnp.asarray(lungs), jnp.asarray(in_sizes),
        jnp.asarray(moments), target_size=target, em_threshold=-910.0)
    got = tpre.fused_preprocess_preselected(
        torch.from_numpy(raw), torch.from_numpy(lungs), in_sizes.tolist(),
        torch.from_numpy(moments), target_size=target, em_threshold=-910.0)
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), rtol=0, atol=1e-5)
    for key in ("lung_mask", "em_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["em_mask"].sum() > 0


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_ops_match_jax(align_corners):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 9, 3).astype(np.float32)
    out = (10, 13, 18)
    got = trs.resize_linear_matmul(torch.from_numpy(x), out, (1, 2, 3),
                                   align_corners)
    want = jrs.resize_linear_matmul(jnp.asarray(x), out, (1, 2, 3),
                                    align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    y = rng.randn(2, 10, 13, 18, 3).astype(np.float32)
    got = trs.resize_linear_matmul_transpose(torch.from_numpy(y), (5, 7, 9),
                                             (1, 2, 3), align_corners)
    want = jrs.resize_linear_matmul_transpose(jnp.asarray(y), (5, 7, 9),
                                              (1, 2, 3), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_nearest_and_depth_indices_match_jax():
    x = np.arange(2 * 37 * 5).reshape(2, 37, 5).astype(np.float32)
    for out, n in ((16, 37), (24, 37), (37, 37), (50, 30)):
        got = trs.nearest_gather_1d(torch.from_numpy(x), out, 1, in_size=n)
        want = jrs.nearest_gather_1d(jnp.asarray(x), out, 1, in_size=n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for d, nd in ((37, 16), (200, 128), (128, 128), (5, 1)):
        np.testing.assert_array_equal(
            trs.depth_linspace_indices(d, nd).numpy(),
            np.asarray(jrs.depth_linspace_indices(d, nd)))


def test_lung_masked_fraction_matches_jax():
    rng = np.random.RandomState(2)
    dense = rng.rand(2, 4, 6, 8, 2).astype(np.float32)
    lung = (rng.rand(2, 8, 12, 16, 1) > 0.5).astype(np.float32)
    got = tmp.lung_masked_fraction(torch.from_numpy(dense),
                                   torch.from_numpy(lung))
    want = jmp.lung_masked_fraction(jnp.asarray(dense), jnp.asarray(lung))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_host_preprocess_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.randint(-2048, 400, (9, 13, 17)).astype(np.int16)
    np.testing.assert_array_equal(thp.window_moments_np(img),
                                  jhp.window_moments_np(img))
    for d_in, d_out in ((180, 128), (97, 32), (3, 1)):
        np.testing.assert_array_equal(thp.depth_indices_np(d_in, d_out),
                                      jhp.depth_indices_np(d_in, d_out))
    m = (rng.rand(5, 37, 41) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        thp.resize_nearest_np(m, (16, 24), (1, 2)),
        jhp.resize_nearest_np(m, (16, 24), (1, 2)))
    f = rng.rand(4, 6, 8).astype(np.float32)
    np.testing.assert_array_equal(
        thp.resize_linear_matmul_np(f, (7, 11, 15), (0, 1, 2), True),
        jhp.resize_linear_matmul_np(f, (7, 11, 15), (0, 1, 2), True))
    from bodyct_dram_emph_subtype_tpu.utils.viz import windowing as jwin
    np.testing.assert_array_equal(windowing(f, from_span=(0, 1)),
                                  jwin(f, from_span=(0, 1)))


def test_morphology_np_matches_jax():
    rng = np.random.RandomState(4)
    mask = rng.rand(12, 14, 16) > 0.97
    for it in (0, 1, 2):
        np.testing.assert_array_equal(tmo.binary_dilate_np(mask, it),
                                      jmo.binary_dilate_np(mask, it))
    assert tmo.find_crops_np(mask, (2.0, 0.7, 0.7), 5) == \
        jmo.find_crops_np(mask, (2.0, 0.7, 0.7), 5)
    with pytest.raises(ValueError):
        tmo.find_crops_np(np.zeros((3, 3, 3), bool), (1, 1, 1), 0)


def _case(scan_dir, lobe_dir, uid, shape=(20, 28, 32), seed=0):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    lobe = ((((zz - 10) / 7.0) ** 2 + ((yy - 14) / 8.0) ** 2
             + ((xx - 16) / 10.0) ** 2) < 1)
    ct = np.full(shape, -600, np.int16)
    ct[lobe] = (-900 + 50 * rng.randn(lobe.sum())).astype(np.int16)
    tmha.write_mha(scan_dir / f"{uid}.mha", ct, (0.7, 0.8, 2.0),
                   (-1.0, 2.0, 3.5))
    tmha.write_mha(lobe_dir / f"{uid}.mha", lobe.astype(np.uint8),
                   (0.7, 0.8, 2.0), (-1.0, 2.0, 3.5))
    return ct


def test_mha_codec_and_inference_dataset_match_jax(tmp_path):
    scans, lobes = tmp_path / "ct", tmp_path / "lobe"
    scans.mkdir()
    lobes.mkdir()
    ct = _case(scans, lobes, "a")
    _case(scans, lobes, "b", seed=1)
    # the port's writer reads back through both codecs, and vice versa
    jimg = jmha.read_mha(scans / "a.mha")
    timg = tmha.read_mha(scans / "a.mha")
    np.testing.assert_array_equal(timg.array, ct)
    np.testing.assert_array_equal(jimg.array, ct)
    assert (timg.spacing, timg.origin, timg.direction) == \
        (jimg.spacing, jimg.origin, jimg.direction)
    jmha.write_mha(tmp_path / "j.mha", ct, (1.5, 1.5, 3.0))
    np.testing.assert_array_equal(tmha.read_mha(tmp_path / "j.mha").array,
                                  ct)

    jset = jds.SubtypingInference(str(scans), str(lobes))
    tset = tds.SubtypingInference(str(scans), str(lobes))
    assert len(tset) == len(jset) == 2
    for i in range(2):
        a, b = tset[i], jset[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
    assert tset.scan_meta_cache == jset.scan_meta_cache
    for pct in (0.0, 0.004, 0.05, 0.25, 0.9):
        for tmap, jmap in ((tds.CLE_RATIO_MAP, jds.CLE_RATIO_MAP),
                           (tds.PSE_RATIO_MAP, jds.PSE_RATIO_MAP)):
            assert tds.ratio_to_label(pct, tmap) == \
                jds.ratio_to_label(pct, jmap)
