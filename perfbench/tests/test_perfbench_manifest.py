"""BENCHMARK.json against the benchmark's contract, and the harness's
lookups by name (a new cell is new files)."""
import json
import re

import pytest

from perfbench import harness
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.ROOT / c["file"]).exists()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(manifest)) < 64 * 1024


def test_one_four_chip_cell_at_most(manifest):
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)


def test_every_layer_metric_moves_what_its_cells_report(manifest):
    for m in manifest["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in manifest["workloads"]])
        for cell in cells:
            reported = {e["name"] for e in harness.cell_metrics(
                manifest, cell, trace=False)}
            assert m["moves"] in reported, (m["name"], cell)
    for w in manifest["workloads"]:
        reported = harness.cell_metrics(manifest, w["name"], trace=False)
        assert "setup_s" in {e["name"] for e in reported}
        assert len(reported) >= 2
        assert harness.cell_metrics(manifest, w["name"], trace=True)


def test_every_cell_finds_its_files(manifest):
    for w in manifest["workloads"]:
        spec = harness.cell_spec(w["name"], manifest)
        assert spec["driver"].exists()
        assert spec["config"]["name"] == w["config"]
    for m in manifest["per_layer"]:
        assert (harness.BENCH / "layer_metrics" / f"{m['name']}.py").exists()
    assert harness.kernel_patterns("conv") and harness.kernel_patterns("nccl")


def test_trainer_metrics_have_their_readers():
    for m in tiny.TRAIN_LAYER:
        assert (harness.BENCH / "layer_metrics" / f"{m['name']}.py").exists()


def test_a_layer_metric_without_cells_follows_what_it_moves(manifest):
    """The contract lets a later per-layer metric leave out ``workloads``:
    it is then read in every cell that reports the metric it moves."""
    man = json.loads(json.dumps(manifest))
    man["per_layer"].append({"name": "later", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "kernels", "moves": "scans_per_s"})
    for w in man["workloads"]:
        names = {m["name"] for m in harness.cell_metrics(man, w["name"],
                                                         True)}
        assert "later" in names
    man["per_layer"][-1]["moves"] = "volumes_per_s"
    assert not any(m["name"] == "later" for w in man["workloads"]
                   for m in harness.cell_metrics(man, w["name"], True))


def test_budget_of_a_full_check(manifest):
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_extra_cell_from_a_temporary_directory(tmp_path, manifest):
    bench, man = tiny.make_bench(tmp_path)
    spec = harness.cell_spec("proc.tiny", man, bench)
    assert spec["traffic"]["driver"] == "processor"
    assert spec["config"]["arch"] == "med3ddramtiny"
    e2e = {m["name"] for m in harness.cell_metrics(man, "proc.tiny", False)}
    assert e2e == {"scans_per_s", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(man, "train.tiny", True)}
    assert "mfu.train" in layer and "proc.pack_ms" not in layer
    # the benchmark's own files are untouched
    assert harness.cell_metrics(manifest, "proc.med3ddram.cohort", False)
