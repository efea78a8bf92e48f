"""The port's MHA writer (``data/mha.py``): the compressed payload is one
zlib stream of slabs, deflated on the threads of the map a caller passes
or in turn without one.  It decodes with plain ``zlib.decompress`` (and the
JAX package's and the benchmark's readers) to the volume's bytes, wherever
the crop sits; its header, Adler-32 trailer and ``CompressedDataSize`` are
zlib's; its bytes do not depend on the map or the pool's width; it is
within 0.5% of one ``zlib.compress`` at level 1; and a stream cut short
does not decode.  The pool's owner, ``run_inference``, sizes it with
``inference/processor.py::pool_width``, makes it once per run and only
above width 1, and leaves no slab thread behind."""
import os
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.data.mha import read_mha as jax_read_mha
from bodyct_dram_emph_subtype_tpu_torch.data import mha
from bodyct_dram_emph_subtype_tpu_torch.data.mha import (
    read_mha, slab_bounds, write_mha, write_pasted_mha)
from bodyct_dram_emph_subtype_tpu_torch.inference import processor
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import pool_width
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.synth import read_mha as bench_read_mha  # noqa: E402
from test_processor import _write_case  # noqa: E402

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


class _Pool:
    """A slab map over an executor of ``width`` threads, or in turn on
    the caller at width 1 (as ``run_inference`` makes no pool there); it
    counts the slabs and records the threads they ran on."""

    def __init__(self, width):
        self.pool = ThreadPoolExecutor(width, thread_name_prefix="slab") \
            if width > 1 else None
        self.slabs, self.threads = [], set()

    def __call__(self, fn, ks):
        def run(k):
            self.slabs.append(k)
            self.threads.add(threading.current_thread().name)
            return fn(k)
        return self.pool.map(run, ks) if self.pool else map(run, ks)

    def close(self):
        if self.pool is not None:
            self.pool.shutdown()


@pytest.fixture
def pools():
    """``make(width)``: a :class:`_Pool`, shut down after the test."""
    made = []

    def make(width):
        made.append(_Pool(width))
        return made[-1]
    yield make
    for p in made:
        p.close()


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
def test_pasted_crop_decodes_to_the_canvas(tmp_path, monkeypatch, pools,
                                           box):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    pool = pools(3)
    paste = _paste(SHAPE, BOXES[box])
    crop = _heatmap(tuple(s.stop - s.start for s in paste))
    want = _canvas(crop, paste, SHAPE)
    write_pasted_mha(tmp_path / "m.mha", crop, paste, SHAPE,
                     spacing=(0.7, 0.7, 2.0), slab_map=pool)
    header, payload = _split(tmp_path / "m.mha")
    assert zlib.decompress(payload) == want.tobytes()
    assert payload[:2] == b"\x78\x01"
    assert int.from_bytes(payload[-4:], "big") == zlib.adler32(want)
    assert int(header["CompressedDataSize"]) == len(payload)
    assert header["DimSize"] == "128 96 30"
    assert sorted(pool.slabs) == list(range(6))
    assert pool.threads and all(t.startswith("slab") for t in pool.threads)
    for read in (lambda p: read_mha(p).array,
                 lambda p: jax_read_mha(p).array, bench_read_mha):
        got = read(tmp_path / "m.mha")
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(7, 96, 128), (1, 96, 128), (1, 1, 1)],
                         ids=["under_one_slab", "one_plane", "one_voxel"])
def test_small_volumes_are_one_slab(tmp_path, monkeypatch, pools, shape):
    monkeypatch.setattr(mha, "_SLAB_BYTES", 1 << 20)
    pool = pools(4)
    paste = (slice(0, shape[0]), slice(0, shape[1]),
             slice(shape[2] // 2, shape[2]))
    crop = _heatmap(tuple(s.stop - s.start for s in paste))
    write_pasted_mha(tmp_path / "m.mha", crop, paste, shape, slab_map=pool)
    _, payload = _split(tmp_path / "m.mha")
    want = _canvas(crop, paste, shape)
    assert zlib.decompress(payload) == want.tobytes()
    assert payload == zlib.compress(want.tobytes(), 1)
    assert pool.slabs == [0]


@pytest.mark.parametrize("shape", [(30, 96, 128), (3, 40, 50), (5, 1, 3)],
                         ids=["slabs", "small_planes", "tiny_planes"])
def test_int16_array_round_trips(tmp_path, monkeypatch, pools, shape):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    ct = np.random.default_rng(1).integers(-1100, 400, shape,
                                           dtype=np.int16)
    ct[:, : shape[1] // 3] = -1024
    write_mha(tmp_path / "ct.mha", ct, (0.7, 0.7, 2.0), (1.0, 2.0, 3.0),
              slab_map=pools(2))
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


def test_bytes_do_not_depend_on_the_pool_width(tmp_path, monkeypatch,
                                               pools):
    """The same files without a map and through maps of 1 (in turn), 2,
    3, 7 and 8 threads."""
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    paste = _paste(SHAPE, BOXES["y_high"])
    crop = _heatmap(tuple(s.stop - s.start for s in paste), seed=3)
    ct = np.random.default_rng(2).integers(-1100, 400, SHAPE,
                                           dtype=np.int16)
    files = []
    for width in (None, 1, 2, 3, 7, 8):
        kw = {} if width is None else {"slab_map": pools(width)}
        heat, vol = tmp_path / f"h{width}.mha", tmp_path / f"c{width}.mha"
        write_pasted_mha(heat, crop, paste, SHAPE, **kw)
        write_mha(vol, ct, **kw)
        if kw:
            assert len(kw["slab_map"].slabs) == 6 + len(
                slab_bounds(SHAPE, np.int16)) - 1
        files.append((heat.read_bytes(), vol.read_bytes()))
    assert all(f == files[0] for f in files)


def test_default_slabs_and_size_against_one_stream(tmp_path, pools):
    """At the real slab size: a cohort-like heatmap (crop in a 512 x 512
    canvas) compresses within 0.5% of one ``zlib.compress`` at level 1."""
    assert slab_bounds((400, 512, 512), np.uint8) == [*range(0, 400, 16),
                                                      400]
    assert slab_bounds((400, 512, 512), np.int16)[:3] == [0, 8, 16]
    assert slab_bounds((0, 512, 512), np.uint8) == [0, 0]
    pool = pools(4)
    shape, paste = (40, 512, 512), (slice(4, 36), slice(140, 384),
                                    slice(84, 428))
    crop = _heatmap((32, 244, 344), seed=5)
    write_pasted_mha(tmp_path / "m.mha", crop, paste, shape, slab_map=pool)
    _, payload = _split(tmp_path / "m.mha")
    want = _canvas(crop, paste, shape).tobytes()
    assert zlib.decompress(payload) == want
    assert len(pool.slabs) == 3
    one = len(zlib.compress(want, 1))
    assert abs(len(payload) - one) <= 0.005 * one


def test_stream_cut_short_does_not_decode(tmp_path, monkeypatch, pools):
    monkeypatch.setattr(mha, "_SLAB_BYTES", SLAB)
    paste = _paste(SHAPE, BOXES["whole"])
    write_pasted_mha(tmp_path / "m.mha", _heatmap(SHAPE), paste, SHAPE,
                     slab_map=pools(2))
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
    """``run_inference`` makes two slab pools a run, the deflate pool and
    the prepare pool, of ``pool_width()`` threads each, and none at width
    1; the run's slabs deflate on its deflate pool's threads, which have
    ended when it returns, as have the prepare pool's."""
    made = []

    class Recording(ThreadPoolExecutor):
        def __init__(self, width, **kw):
            super().__init__(width, **kw)
            made.append((width, self))

    monkeypatch.setattr(processor, "ThreadPoolExecutor", Recording)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    scans, lobes = tmp_path / "ct", tmp_path / "lobes"
    scans.mkdir()
    lobes.mkdir()
    _write_case(scans, lobes, "case1", shape=(40, 56, 72))
    model = get_model_by_name("med3ddramtiny")
    for run, (width, pools) in enumerate(((1, 0), (3, 2), (3, 4))):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid, n=width + 1: set(range(n)))
        stats = {}
        processor.run_inference(
            str(scans), str(lobes), str(tmp_path / f"out{run}"),
            target_size=(32, 48, 64), batch_size=1, workers=1, model=model,
            device="cpu", stats=stats)
        assert len(made) == pools
        assert stats["zlib"]["threads"] == stats["prepare"]["threads"] \
            == width
        assert stats["zlib"]["slabs"] == 2 and stats["zlib"]["work_ms"] > 0
        if pools:
            for (made_width, pool), kind in zip(made[-2:],
                                                ("deflate", "prepare")):
                assert made_width == width
                threads = pool._threads
                assert threads and not any(t.is_alive() for t in threads)
                assert all(t.name.startswith(f"proc-{kind}")
                           for t in threads)
    files = [sorted(p.read_bytes() for p in
                    (tmp_path / f"out{r}" / "images").rglob("*.mha"))
             for r in range(3)]
    assert len(files[0]) == 2 and files[0] == files[1] == files[2]


def test_crop_must_fill_its_paste(tmp_path):
    with pytest.raises(ValueError, match="does not fill"):
        write_pasted_mha(tmp_path / "m.mha", np.zeros((2, 3, 4), np.uint8),
                         (slice(0, 2), slice(0, 3), slice(0, 5)), (4, 4, 8))


def test_concurrent_writers_share_the_pool(tmp_path, monkeypatch, pools):
    """More writer threads than cores, each writing its own volumes through
    one pool's map, with a short switch interval: every file decodes to
    its own canvas."""
    monkeypatch.setattr(mha, "_SLAB_BYTES", 16 << 10)
    pool = pools(3)
    errors, done = [], []

    def writer(i):
        try:
            paste = _paste(SHAPE, list(BOXES.values())[i % len(BOXES)])
            crop = _heatmap(tuple(s.stop - s.start for s in paste), seed=i)
            for j in range(3):
                path = tmp_path / f"w{i}_{j}.mha"
                write_pasted_mha(path, crop, paste, SHAPE, slab_map=pool)
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
