"""The port's MHA writer (``data/mha.py``): the compressed payload is one
zlib stream of slabs deflated on a thread pool.  It decodes with plain
``zlib.decompress`` (and the JAX package's and the benchmark's readers) to
the volume's bytes, wherever the crop sits; its header, Adler-32 trailer
and ``CompressedDataSize`` are zlib's; its bytes do not depend on the
pool's width; it is within 0.5% of one ``zlib.compress`` at level 1; and
a stream cut short does not decode."""
import os
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.data.mha import read_mha as jax_read_mha
from bodyct_dram_emph_subtype_tpu_torch.data import mha
from bodyct_dram_emph_subtype_tpu_torch.data.mha import (
    pool_width, read_mha, slab_bounds, write_mha, write_pasted_mha)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.synth import read_mha as bench_read_mha  # noqa: E402

SHAPE = (30, 96, 128)       # 12 KiB planes: 5 a slab, 3 of dictionary
SLAB = 64 << 10


def _split(path):
    """The header (``Key = Value`` lines as a dict) and payload of a
    written file."""
    raw = Path(path).read_bytes()
    end = raw.index(b"ElementDataFile = LOCAL\n") + len(
        b"ElementDataFile = LOCAL\n")
    header = dict(line.split(" = ", 1) for line in
                  raw[:end].decode("ascii").splitlines())
    return header, raw[end:]


def _heatmap(shape, seed=0):
    """Smooth uint8 values inside an ellipsoid, zeros elsewhere: a
    heatmap crop."""
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    r = sum(((g + 0.5) / n - 0.5) ** 2 for g, n in zip((zz, yy, xx), shape))
    smooth = 90 + 80 * np.sin(zz / 5.0) * np.cos(yy / 7.0) * np.sin(xx / 9.0)
    noise = np.random.default_rng(seed).normal(0, 3, shape)
    return np.clip(np.where(r < 0.25, smooth + noise, 0), 0,
                   255).astype(np.uint8)


def _canvas(crop, paste, shape):
    full = np.zeros(shape, crop.dtype)
    full[paste] = crop
    return full


def _drop_pool():
    """Shut down the slab pool a test made, so the next write makes one
    anew, as a process's first write does."""
    if mha._POOL is not None and mha._POOL[1] is not None:
        mha._POOL[1].shutdown()
    mha._POOL = None


@pytest.fixture(autouse=True)
def _own_pool(monkeypatch):
    """Each test starts without a slab pool; the process's pool, if any,
    is put back after it."""
    monkeypatch.setattr(mha, "_POOL", None)
    yield
    _drop_pool()


def _width(monkeypatch, width):
    """Make :func:`pool_width` pick ``width`` (one rank on the host) and
    the next write make its pool."""
    _drop_pool()
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(width + 1)))
    assert pool_width() == width


def _paste(shape, box):
    return tuple(slice(a, b) for a, b in box)


# (z, y, x) boxes in SHAPE: one touching each face, the whole volume and
# an empty crop (an all-zero volume)
BOXES = {
    "z_low": ((0, 11), (20, 70), (30, 100)),
    "z_high": ((19, 30), (20, 70), (30, 100)),
    "y_low": ((6, 24), (0, 40), (30, 100)),
    "y_high": ((6, 24), (50, 96), (30, 100)),
    "x_low": ((6, 24), (20, 70), (0, 61)),
    "x_high": ((6, 24), (20, 70), (61, 128)),
    "whole": ((0, 30), (0, 96), (0, 128)),
    "empty": ((12, 12), (20, 70), (30, 100)),
}


@pytest.mark.parametrize("box", list(BOXES), ids=list(BOXES))
def test_pasted_crop_decodes_to_the_canvas(tmp_path, monkeypatch, box):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    _width(monkeypatch, 3)
    paste = _paste(SHAPE, BOXES[box])
    crop = _heatmap(tuple(s.stop - s.start for s in paste))
    want = _canvas(crop, paste, SHAPE)
    stats = {}
    write_pasted_mha(tmp_path / "m.mha", crop, paste, SHAPE,
                     spacing=(0.7, 0.7, 2.0), zlib_stats=stats)
    header, payload = _split(tmp_path / "m.mha")
    assert zlib.decompress(payload) == want.tobytes()
    assert payload[:2] == b"\x78\x01"
    assert int.from_bytes(payload[-4:], "big") == zlib.adler32(want)
    assert int(header["CompressedDataSize"]) == len(payload)
    assert header["DimSize"] == "128 96 30"
    assert stats == {"threads": 3, "slabs": 6, "work_ms": stats["work_ms"]}
    for read in (lambda p: read_mha(p).array,
                 lambda p: jax_read_mha(p).array, bench_read_mha):
        got = read(tmp_path / "m.mha")
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(7, 96, 128), (1, 96, 128), (1, 1, 1)],
                         ids=["under_one_slab", "one_plane", "one_voxel"])
def test_small_volumes_are_one_slab(tmp_path, monkeypatch, shape):
    monkeypatch.setattr(mha, "_SLAB_BYTES", 1 << 20)
    _width(monkeypatch, 4)
    paste = (slice(0, shape[0]), slice(0, shape[1]),
             slice(shape[2] // 2, shape[2]))
    crop = _heatmap(tuple(s.stop - s.start for s in paste))
    stats = {}
    write_pasted_mha(tmp_path / "m.mha", crop, paste, shape,
                     zlib_stats=stats)
    _, payload = _split(tmp_path / "m.mha")
    want = _canvas(crop, paste, shape)
    assert zlib.decompress(payload) == want.tobytes()
    assert payload == zlib.compress(want.tobytes(), 1)
    assert stats["slabs"] == 1


@pytest.mark.parametrize("shape", [(30, 96, 128), (3, 40, 50), (5, 1, 3)],
                         ids=["slabs", "small_planes", "tiny_planes"])
def test_int16_array_round_trips(tmp_path, monkeypatch, shape):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    _width(monkeypatch, 2)
    ct = np.random.default_rng(1).integers(-1100, 400, shape,
                                           dtype=np.int16)
    ct[:, : shape[1] // 3] = -1024
    write_mha(tmp_path / "ct.mha", ct, (0.7, 0.7, 2.0), (1.0, 2.0, 3.0))
    header, payload = _split(tmp_path / "ct.mha")
    assert zlib.decompress(payload) == ct.tobytes()
    assert int.from_bytes(payload[-4:], "big") == zlib.adler32(ct)
    assert int(header["CompressedDataSize"]) == len(payload)
    img = read_mha(tmp_path / "ct.mha")
    assert img.array.dtype == np.int16 and np.array_equal(img.array, ct)
    assert img.origin == (1.0, 2.0, 3.0)


def test_uncompressed_write_is_the_raw_bytes(tmp_path):
    ct = np.arange(2 * 3 * 4, dtype=np.int16).reshape(2, 3, 4)
    write_mha(tmp_path / "raw.mha", ct[:, ::-1], compressed=False)
    header, payload = _split(tmp_path / "raw.mha")
    assert header["CompressedData"] == "False"
    assert payload == np.ascontiguousarray(ct[:, ::-1]).tobytes()
    crop = np.full((1, 2, 2), 7, np.uint8)
    paste = (slice(1, 2), slice(0, 2), slice(2, 4))
    write_pasted_mha(tmp_path / "rawp.mha", crop, paste, (2, 3, 4),
                     compressed=False)
    assert _split(tmp_path / "rawp.mha")[1] == _canvas(
        crop, paste, (2, 3, 4)).tobytes()


def test_bytes_do_not_depend_on_the_pool_width(tmp_path, monkeypatch):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    paste = _paste(SHAPE, BOXES["y_high"])
    crop = _heatmap(tuple(s.stop - s.start for s in paste), seed=3)
    ct = np.random.default_rng(2).integers(-1100, 400, SHAPE,
                                           dtype=np.int16)
    files = []
    for width in (1, 2, 8):
        _width(monkeypatch, width)
        stats = {}
        heat, vol = tmp_path / f"h{width}.mha", tmp_path / f"c{width}.mha"
        write_pasted_mha(heat, crop, paste, SHAPE, zlib_stats=stats)
        write_mha(vol, ct, zlib_stats=stats)
        assert stats["threads"] == width
        assert stats["slabs"] == 6 + len(slab_bounds(SHAPE, np.int16)) - 1
        files.append((heat.read_bytes(), vol.read_bytes()))
    assert files[0] == files[1] == files[2]


def test_default_slabs_and_size_against_one_stream(tmp_path, monkeypatch):
    """At the real slab size: a cohort-like heatmap (crop in a 512 x 512
    canvas) compresses within 0.5% of one ``zlib.compress`` at level 1."""
    assert slab_bounds((400, 512, 512), np.uint8) == [*range(0, 400, 16),
                                                      400]
    assert slab_bounds((400, 512, 512), np.int16)[:3] == [0, 8, 16]
    assert slab_bounds((0, 512, 512), np.uint8) == [0, 0]
    _width(monkeypatch, 4)
    shape, paste = (40, 512, 512), (slice(4, 36), slice(140, 384),
                                    slice(84, 428))
    crop = _heatmap((32, 244, 344), seed=5)
    stats = {}
    write_pasted_mha(tmp_path / "m.mha", crop, paste, shape,
                     zlib_stats=stats)
    _, payload = _split(tmp_path / "m.mha")
    want = _canvas(crop, paste, shape).tobytes()
    assert zlib.decompress(payload) == want
    assert stats["slabs"] == 3
    one = len(zlib.compress(want, 1))
    assert abs(len(payload) - one) <= 0.005 * one


def test_stream_cut_short_does_not_decode(tmp_path, monkeypatch):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    _width(monkeypatch, 2)
    paste = _paste(SHAPE, BOXES["whole"])
    write_pasted_mha(tmp_path / "m.mha", _heatmap(SHAPE), paste, SHAPE)
    _, payload = _split(tmp_path / "m.mha")
    for cut in (payload[:-1], payload[:-4], payload[:len(payload) // 2]):
        with pytest.raises(zlib.error):
            zlib.decompress(cut)
    bad = payload[:-1] + bytes([payload[-1] ^ 1])
    with pytest.raises(zlib.error):
        zlib.decompress(bad)
    raw = (tmp_path / "m.mha").read_bytes()
    (tmp_path / "cut.mha").write_bytes(raw[:-4])
    with pytest.raises(zlib.error):
        read_mha(tmp_path / "cut.mha")


def test_adler32_combine_matches_zlib():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    for cut in (0, 1, 65521, 100_000, len(data)):
        a, b = data[:cut], data[cut:]
        assert mha._adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                    len(b)) == zlib.adler32(data)


def test_pool_width_rule(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert pool_width() == 7
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pool_width() == 3
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert pool_width() == 1
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    for cpus in (1, 2):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid, n=cpus: set(range(n)))
        assert pool_width() == 1


def test_pool_is_made_once_and_only_when_used(tmp_path, monkeypatch):
    """No executor at width 1; otherwise one, made at the first write and
    kept, even if the CPUs the process sees change later."""
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    _width(monkeypatch, 1)
    assert mha._POOL is None
    write_pasted_mha(tmp_path / "a.mha", _heatmap(SHAPE),
                     _paste(SHAPE, BOXES["whole"]), SHAPE)
    assert mha._POOL == (1, None)
    _width(monkeypatch, 3)
    stats = {}
    for name in ("b", "c", "d"):
        if name == "d":
            monkeypatch.setattr(os, "sched_getaffinity",
                                lambda pid: set(range(6)))
        write_pasted_mha(tmp_path / f"{name}.mha", _heatmap(SHAPE),
                         _paste(SHAPE, BOXES["whole"]), SHAPE,
                         zlib_stats=stats)
        if name == "b":
            pool = mha._POOL
        assert mha._POOL is pool and pool[0] == 3 == stats["threads"]
    assert (tmp_path / "b.mha").read_bytes() == (
        tmp_path / "d.mha").read_bytes()


def test_crop_must_fill_its_paste(tmp_path):
    with pytest.raises(ValueError, match="does not fill"):
        write_pasted_mha(tmp_path / "m.mha", np.zeros((2, 3, 4), np.uint8),
                         (slice(0, 2), slice(0, 3), slice(0, 5)), (4, 4, 8))


def test_concurrent_writers_share_the_pool(tmp_path, monkeypatch):
    """More writer threads than cores, each writing its own volumes through
    the one pool, with a short switch interval: every file decodes to its
    own canvas."""
    monkeypatch.setattr(mha, "_SLAB_BYTES", 16 << 10)
    _width(monkeypatch, 3)
    errors, done = [], []

    def writer(i):
        try:
            paste = _paste(SHAPE, list(BOXES.values())[i % len(BOXES)])
            crop = _heatmap(tuple(s.stop - s.start for s in paste), seed=i)
            for j in range(3):
                path = tmp_path / f"w{i}_{j}.mha"
                write_pasted_mha(path, crop, paste, SHAPE)
                want = _canvas(crop, paste, SHAPE)
                assert np.array_equal(read_mha(path).array, want)
            done.append(i)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(done) == list(range(len(threads)))
