"""Kernel G's plain version (``ops/heatmap.py``) against the numpy
postprocess it replaces, byte for byte: ``resize_linear_matmul_np`` of the
f16 half maps to the model size, zeroed where the ess mask is 0 (stage 1),
then ``resize_linear_matmul_np`` to the crop and ``windowing(x, (0,
1)).astype(np.uint8)`` (stage 2).  The cases are shared with the card's
tests of the kernel (``test_torch_cuda_kernels.py``).  No JAX here."""
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import \
    resize_linear_matmul_np
from bodyct_dram_emph_subtype_tpu_torch.ops.heatmap import (
    MAPS, PERMS, ROW_ALIGN, axis_order, quantised_crops, resample_table,
    row_length, upsample_masked)
from bodyct_dram_emph_subtype_tpu_torch.utils.viz import windowing

# name: (maps' shape (B, D, H, W); stage 1's target size or None for
# stage 2 alone; each scan's crop; the maps' values)
CASES = {
    # the cohort's model size to its crop (stage 2 of a device-path scan)
    "cohort crop": ((1, 128, 224, 288), None, [(330, 260, 360)], "spread"),
    # H shrinks, so it sorts first; a second scan with another crop
    "one axis shrinks": ((2, 16, 28, 36), None, [(40, 20, 50), (17, 29, 37)],
                         "spread"),
    "crop equals the map": ((1, 16, 28, 36), None, [(16, 28, 36)],
                            "boundaries"),
    "axis of length 1": ((2, 1, 28, 36), None, [(6, 1, 40), (1, 30, 36)],
                         "spread"),
    # stage 1 then 2: half maps to the model size, two scans, two crops
    "half maps, two scans": ((2, 8, 14, 18), (16, 28, 36),
                             [(33, 26, 37), (12, 30, 36)], "spread"),
    "half maps, ragged": ((1, 5, 7, 9), (12, 1, 20), [(20, 3, 21)],
                          "spread"),
    "half maps at the model size": ((1, 16, 28, 36), (16, 28, 36),
                                    [(16, 28, 36)], "boundaries"),
    # an oversized dummy's or another rank's scan: no crop made
    "a scan not written": ((2, 6, 7, 8), (12, 14, 16), [(0, 0, 0),
                                                        (15, 14, 19)],
                           "spread"),
}


def case_maps(shape, values, seed=0):
    """(B, D, H, W, 2) float32 maps: ``spread`` draws from [-0.3, 1.3]
    (clipped below 0 and above 1 in places), ``boundaries`` cycles through
    k / 255 for every count k, the float32 neighbours of each, and values
    outside [0, 1]."""
    rng = np.random.RandomState(seed)
    if values == "spread":
        return (rng.rand(*shape, MAPS) * 1.6 - 0.3).astype(np.float32)
    k = np.float32(np.arange(256)) / np.float32(255)
    pool = np.concatenate([k, np.nextafter(k, np.float32(2)),
                           np.nextafter(k, np.float32(-1)),
                           np.float32([-1.0, -0.0, 1.5, 2.0, 255.0])])
    idx = rng.permutation(np.resize(np.arange(pool.size),
                                    int(np.prod(shape)) * MAPS))
    return pool[idx].reshape(*shape, MAPS)


def case_inputs(case, seed=0):
    """The stage inputs of ``case`` (a value of :data:`CASES`) as numpy:
    float16 half maps and a uint8 ess mask for a stage-1 case (else None),
    and the stage-2 float32 maps (for a stage-1 case None: they are stage
    1's output)."""
    shape, target, _, values = case
    maps = case_maps(shape, values, seed)
    if target is None:
        return None, None, maps
    rng = np.random.RandomState(seed + 1)
    ess = (rng.rand(shape[0], *target) > 0.3).astype(np.uint8)
    return maps.astype(np.float16), ess, None


def oracle(case, seed=0):
    """The numpy postprocess of ``case``: stage 1's float32 maps (or None)
    and each scan's two uint8 crops (B lists of (CLE, PSE))."""
    shape, target, crops, _ = case
    half, ess, maps = case_inputs(case, seed)
    up = None
    if target is not None:
        up = np.empty((shape[0], *target, MAPS), np.float32)
        for b in range(shape[0]):
            for c in range(MAPS):
                m = resize_linear_matmul_np(half[b, ..., c].astype(
                    np.float32), target, (0, 1, 2), align_corners=True)
                m[ess[b] == 0] = 0.0
                up[b, ..., c] = m
        maps = up
    heat = [[windowing(resize_linear_matmul_np(
        maps[b, ..., c], crop, (0, 1, 2), align_corners=True),
        from_span=(0, 1)).astype(np.uint8) for c in range(MAPS)]
        for b, crop in enumerate(crops)]
    return up, heat


def run_g(case, device, seed=0):
    """Kernel G's wrappers on ``device`` over ``case``: stage 1's maps (or
    None) and the (B, 2, N) crop rows, on the host."""
    _, target, crops, _ = case
    half, ess, maps = case_inputs(case, seed)
    up = None
    if target is not None:
        up = upsample_masked(torch.from_numpy(half).to(device),
                             torch.from_numpy(ess).to(device), target)
        maps = up
    else:
        maps = torch.from_numpy(maps).to(device)
    heat = quantised_crops(maps, crops)
    return (None if up is None else up.cpu().numpy()), heat.cpu().numpy()


def assert_bytes_equal(case, got_up, got_heat, want_up, want_heat):
    crops = case[2]
    if want_up is not None:
        assert got_up.dtype == np.float32
        assert np.array_equal(got_up.view(np.int32), want_up.view(np.int32))
    assert got_heat.dtype == np.uint8
    assert got_heat.shape == (len(crops), MAPS, row_length(crops))
    for b, crop in enumerate(crops):
        n = int(np.prod(crop))
        for c in range(MAPS):
            assert np.array_equal(got_heat[b, c, :n].reshape(crop),
                                  want_heat[b][c]), (b, c)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_the_numpy_postprocess(name):
    case = CASES[name]
    assert_bytes_equal(case, *run_g(case, "cpu"), *oracle(case))


def test_boundary_values_hit_both_sides_of_a_count():
    """The boundary maps give every count, and some values just below a
    count's boundary fall to the count beneath it."""
    _, heat = oracle(CASES["crop equals the map"])
    counts = np.unique(np.concatenate([h.ravel() for h in heat[0]]))
    assert counts.tolist() == list(range(256))
    maps = case_maps((1, 16, 28, 36), "boundaries")
    below = np.float32(np.nextafter(np.float32(np.arange(1, 256)) /
                                    np.float32(255), np.float32(-1)))
    assert np.isin(below, maps).all()
    assert (np.trunc(below * np.float32(255)) <
            np.arange(1, 256)).any()


def test_table_follows_the_numpy_axis_order():
    """``resample_table`` holds numpy's order (ascending out / in, stable)
    and each axis's taps."""
    in_shape = (128, 224, 288)
    crops = [(330, 260, 360), (300, 300, 430), (100, 224, 290), (0, 0, 0)]
    table = resample_table(in_shape, crops)
    for e, crop in enumerate(crops):
        head = table[8 * e: 8 * e + 8]
        want = sorted(range(3), key=lambda a: crop[a] / in_shape[a])
        assert tuple(head[:3]) == crop
        assert PERMS[head[3]] == tuple(want) == axis_order(in_shape, crop)
        for a in range(3):
            n = crop[a]
            taps = table[8 * e + head[4 + a]:][:3 * n]
            assert taps[:n].max(initial=0) < in_shape[a]
            assert (taps[n:2 * n] - taps[:n]).max(initial=0) <= 1
            w = taps[2 * n:].view(np.float32)
            assert ((w >= 0) & (w <= 1)).all()
    assert row_length(crops) % ROW_ALIGN == 0
    assert row_length(crops) >= 300 * 300 * 430


def test_quantised_crops_skips_a_zero_crop():
    maps = torch.from_numpy(case_maps((2, 4, 5, 6), "spread"))
    heat = quantised_crops(maps, [(0, 0, 0), (3, 4, 5)])
    assert heat.shape == (2, MAPS, ROW_ALIGN * 4)
    assert not heat[0].any()
    with pytest.raises(ValueError, match="crops for 2 scans"):
        quantised_crops(maps, [(3, 4, 5)])


def test_heatmap_ms_reader():
    """``proc.heatmap_ms``: kernel G's stage milliseconds per batch; None
    where a program has no such stage or ran no batch."""
    from perfbench import harness
    read = harness.load_module(harness.BENCH / "layer_metrics" /
                               "proc.heatmap_ms.py").read
    proc = {"stage_ms": {"heatmap": 3.0, "forward": 80.0}, "batches": 4}
    assert read({"proc": proc}) == pytest.approx(0.75)
    assert read({"proc": dict(proc, batches=0)}) is None
    assert read({"proc": dict(proc, stage_ms={"forward": 80.0})}) is None
    assert read({}) is None
