"""The readers of the processor's span counters (``stats["stage_ms"]``
keys spelled like their spans): ``None`` on a record without the key (a
program without the span) or without the scans or batches to divide by,
and the counter over them on one with it."""
import pytest

from perfbench import harness

READERS = {
    "proc.read_ms": ("io.read", "scans"),
    "proc.prepare_ms": ("io.prepare", "scans"),
    "proc.loader_wait_ms": ("wait.loader", "batches"),
    "proc.post_wait_ms": ("wait.post", "scans"),
    "proc.upsample_ms": ("post.upsample", "device_scans"),
    "proc.uncrop_ms": ("post.uncrop", "scans"),
    "proc.quantise_ms": ("post.quantise", "scans"),
    "proc.zlib_ms": ("post.zlib", "scans"),
    "proc.write_ms": ("post.write", "scans"),
}


def _record(stage_ms, scans=8, batches=4, device_scans=6):
    return {"proc": {"stage_ms": {"postprocess": 9000.0, **stage_ms},
                     "scans": scans, "batches": batches,
                     "device_scans": device_scans, "device_batches": 4,
                     "pack_ms": 0.0, "upload_bytes": 0, "host_scans": 0}}


def _reader(name):
    return harness.load_module(harness.BENCH / "layer_metrics" /
                               f"{name}.py").read


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_key_reads_none(name):
    read = _reader(name)
    assert read(_record({})) is None
    assert read({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_divides_its_counter(name):
    key, per = READERS[name]
    read = _reader(name)
    rec = _record({key: 1200.0})
    assert read(rec) == pytest.approx(1200.0 / rec["proc"][per])
    rec["proc"][per] = 0
    assert read(rec) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_in_the_manifest(name):
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in manifest["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "scans_per_s" and entry["better"] == "lower"
    want = ["proc.med3ddram.cohort"] + (
        [] if name == "proc.upsample_ms" else ["proc.med3ddram.wide"])
    assert entry["workloads"] == want
