"""The processor's prepare, one pass over z-slabs of each crop
(``data/datasets.py::SubtypingInference``, ``inference/processor.py::
_RawPredictView``), against a plain formulation kept here: the whole
volume's ``lobe > 0``, the JAX package's bounding box and whole-volume
dilation, the whole crop's int64 moments, and the view's selection, pad,
gate and lung selection over whole arrays.  Items must be equal byte for
byte, in turn on the caller and on pools of 2 and 3 threads."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.ops.morphology import (binary_dilate_np,
                                                          find_crops_np)
from bodyct_dram_emph_subtype_tpu_torch.data import datasets
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    SubtypingInference
from bodyct_dram_emph_subtype_tpu_torch.data.mha import write_mha
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import \
    _RawPredictView

SPACING = (0.8, 0.9, 2.5)            # ITK (x, y, z): borders 7, 6, 2 voxels
# a plane of 2300 voxels: gate blocks of 64 straddle the planes and the
# view's chunks of planes
UP_SHAPE = (16, 46, 50)
BLOCK = 64
TARGET = (16, 12, 14)
ALL = 10 ** 12


def _faces(rng, shape):
    """Sparse lobes, and a lobe voxel on each of the volume's six faces."""
    lobe = (rng.random(shape) < 0.02) * rng.integers(1, 6, shape)
    for axis, n in enumerate(shape):
        for at in (0, n - 1):
            voxel = [3, 3, 3]
            voxel[axis] = at
            lobe[tuple(voxel)] = 2
    return lobe


def _ball(shape, centre, radii):
    grid = np.mgrid[tuple(slice(0, n) for n in shape)]
    return sum(((g - c) / r) ** 2 for g, c, r in zip(grid, centre, radii)) < 1


def _box(shape, start):
    lobe = np.zeros(shape, np.uint8)
    lobe[start[0]:-start[0], start[1]:, start[2]:] = 5
    return lobe


def _planes(shape, z0, z1):
    lobe = np.zeros(shape, np.uint8)
    lobe[z0:z1, 3:-4, 5:-2] = 3
    lobe[z0, 0, 0] = 0
    return lobe


# name: (volume shape, lobe map from (rng, shape), CT from (rng, shape),
#        crop border in mm, keep_original, compute_ess, budget)
CASES = {
    # the lung touches every face: the halos and the in-plane widening
    # are clipped to the volume on every side
    "faces": ((19, 23, 29), _faces,
              lambda r, s: r.integers(-1300, 200, s).astype(np.int16),
              5, False, False, ALL),
    # odd sizes, several slabs and a last short one, halos inside
    "odd": ((37, 41, 43),
            lambda r, s: _ball(s, (18, 20, 22), (14, 15, 16)).astype(
                np.uint8) * 4,
            lambda r, s: r.integers(-1300, 200, s).astype(np.int16),
            5, False, False, ALL),
    "one_plane": ((9, 20, 22), lambda r, s: _planes(s, 4, 5),
                  lambda r, s: r.integers(-1300, 200, s).astype(np.int16),
                  0, False, False, ALL),
    # fewer planes than a slab holds, so fewer slabs than threads
    "few_planes": ((15, 20, 22), lambda r, s: _planes(s, 3, 8),
                   lambda r, s: r.integers(-1300, 200, s).astype(np.int16),
                   0, False, False, ALL),
    # every voxel clipped to the window's floor: variance 0, 1/std 0
    "all_clipped": ((21, 24, 26),
                    lambda r, s: _ball(s, (10, 12, 13), (8, 9, 9)).astype(
                        np.uint8),
                    lambda r, s: np.full(s, -1500, np.int16),
                    5, False, False, ALL),
    # float CT: the cast is astype's and the -910 HU ess mask is taken on
    # the native values (-910.4 counts, -909.6 does not)
    "float_ess": ((23, 26, 28),
                  lambda r, s: _ball(s, (11, 13, 14), (9, 10, 11)).astype(
                      np.uint8) * 2,
                  lambda r, s: (r.integers(-1100, -700, s)
                                + r.choice([-0.4, 0.4, 0.0], s)).astype(
                      np.float32),
                  5, True, True, ALL),
    "keep_original": ((20, 30, 27),
                      lambda r, s: _ball(s, (9, 15, 13), (7, 11, 10)).astype(
                          np.uint8),
                      lambda r, s: r.integers(-1300, 200, s).astype(
                          np.int16),
                      5, True, True, ALL),
    # the crop fills the pad in-plane, its first rows masked out and its
    # last rows live: a gate block shared by two chunks of the view's
    # planes is live through the first chunk's part alone
    "fills_pad": ((20, 46, 50), lambda r, s: _box(s, (3, 6, 7)),
                  lambda r, s: r.integers(-1100, 200, s).astype(np.int16),
                  5, False, False, ALL),
    # both dummy triggers hold; the in-plane one comes first
    "over_pad": ((12, 60, 30), lambda r, s: _planes(s, 2, 9),
                 lambda r, s: r.integers(-1100, 200, s).astype(np.int16),
                 5, False, False, BLOCK),
    "over_budget": ((14, 30, 31), lambda r, s: _planes(s, 2, 12),
                    lambda r, s: r.integers(-1100, 200, s).astype(np.int16),
                    5, False, False, BLOCK),
}


def _plain_item(ct, lobe, border, keep_original, compute_ess):
    """``SubtypingInference``'s item as the reference makes it: dilate the
    whole volume, then crop."""
    spacing_zyx = SPACING[::-1]
    lung = lobe > 0
    crop = find_crops_np(lung, spacing_zyx, border)
    image = ct[crop].astype(np.int16)
    out = {"image": image, "lung_mask": lung[crop],
           "crop_slice": np.asarray([(s.start, s.stop) for s in crop]),
           "original_size": np.asarray(ct.shape)}
    if keep_original:
        out["original_image"] = image.copy()
    image[~binary_dilate_np(lung, 2)[crop]] = -2048
    if compute_ess:
        out["ess_mask"] = (ct[crop] < -910) & lung[crop]
    return out


def _plain_moments(image):
    c = np.clip(image.astype(np.int64), -1150, -300)
    n, s1, s2 = c.size, int(c.sum()), int((c * c).sum())
    mean = (s1 + 1150 * n) / (n * 850)
    var = (s2 * n - s1 * s1) / (n * max(n - 1, 1) * 850 * 850)
    return np.asarray([mean, 1.0 / np.sqrt(var) if var > 0 else 0.0],
                      np.float32)


def _plain_view_item(d, budget):
    """``_RawPredictView``'s item over whole arrays, or the reason of its
    dummy."""
    img = d["image"]
    dz, h, w = img.shape
    if h > UP_SHAPE[1] or w > UP_SHAPE[2]:
        return "exceeds in-plane pad"
    idx = (np.arange(UP_SHAPE[0]) * (dz - 1)) // (UP_SHAPE[0] - 1)
    img_p = np.full(UP_SHAPE, -2048, np.int16)
    img_p[:, :h, :w] = img[idx]
    gate = (img_p.reshape(-1, BLOCK) > -1150).any(-1)
    if gate.sum() * BLOCK > budget:
        return "exceeds budget"
    rows = (np.arange(TARGET[1]) * h) // TARGET[1]
    cols = (np.arange(TARGET[2]) * w) // TARGET[2]
    return {"image_raw": img_p, "gate_blocks": gate,
            "lung_raw": d["lung_mask"][idx][:, rows][:, :, cols].astype(
                np.uint8),
            "in_sizes": np.asarray((UP_SHAPE[0], h, w), np.int32),
            "moments": _plain_moments(img),
            "crop_slice": d["crop_slice"],
            "original_size": d["original_size"], "oversized": False}


def _assert_same(got, want):
    assert set(got) == set(want) | {"uid"}
    for key, value in want.items():
        g = np.asarray(got[key])
        assert g.dtype == np.asarray(value).dtype, key
        assert g.shape == np.shape(value), key
        assert g.tobytes() == np.asarray(value).tobytes(), key


@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_pass_is_the_whole_volume_prepare(tmp_path, caplog, case,
                                               width):
    shape, make_lobe, make_ct, border, keep, ess, budget = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    lobe = np.asarray(make_lobe(rng, shape), np.uint8)
    ct = make_ct(rng, shape)
    scans, lobes = tmp_path / "ct", tmp_path / "lobes"
    scans.mkdir()
    lobes.mkdir()
    write_mha(scans / "s.mha", ct, SPACING)
    write_mha(lobes / "s.mha", lobe, SPACING)
    want = _plain_item(ct, lobe, border, keep, ess)
    if case == "faces":
        assert want["image"].shape == shape
    if case == "one_plane":
        assert want["image"].shape[0] == 1
    if case == "few_planes":
        assert 1 < want["image"].shape[0] < datasets.SLAB_PLANES
    if case == "odd":
        assert want["image"].shape[0] > 2 * datasets.SLAB_PLANES
    if case == "fills_pad":
        assert want["image"].shape[1:] == UP_SHAPE[1:]
    if case == "all_clipped":
        assert _plain_moments(want["image"])[1] == 0

    pool = ThreadPoolExecutor(width) if width > 1 else None
    try:
        ds = SubtypingInference(str(scans), str(lobes), crop_border=border,
                                keep_original=keep, compute_ess=ess,
                                slab_map=pool.map if pool else None)
        _assert_same(ds[0], want)
        view = _RawPredictView(ds, UP_SHAPE, TARGET, budget, BLOCK)
        caplog.clear()
        got = view[0]
    finally:
        if pool:
            pool.shutdown()
    want_view = _plain_view_item(want, budget)
    if isinstance(want_view, str):
        assert got["oversized"] and view.oversized == {0}
        assert want_view in caplog.text
        assert not got["gate_blocks"].any() and not got["lung_raw"].any()
    else:
        assert not view.oversized
        _assert_same(got, want_view)
