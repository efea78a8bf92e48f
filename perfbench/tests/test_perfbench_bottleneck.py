"""The cell ``proc.med3ddram50.cohort``: the Bottleneck arch
``resnet50segreg`` at its published widths against the plain reference,
its tiny processor cell, the readers of the forward's trunk/decoder split,
and (marked ``cuda``) the control at the cell's own size."""
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import model as ref_model
from perfbench.tests import tiny50
from perfbench.tests.test_perfbench_span_metrics import _reader, _record

from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name

CELL = "proc.med3ddram50.cohort"
# the forward's split (``stage_ms`` keys of CUDA-event intervals, per batch)
SPLIT = {"proc.trunk_ms": "trunk", "proc.decoder_ms": "decoder"}


def test_bottleneck_model_matches_the_program():
    """``resnet50segreg`` at its published widths (2048-wide layer4, us1
    at C = 2304) on a tiny input, BatchNorm calibrated by the reference so
    the maps are neither saturated nor flat.  Tolerances: both sides are
    float32 and differ only in the order of their sums (one output of us1
    sums 2304 x 27 products; read 5.5e-5 on the maps and 8e-7 on the
    fractions); bfloat16 anywhere on the path would be off by about 1e-2."""
    sd = ref_model.make_weights("med3ddram50", 5, "cpu", 0.5, -2.0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 32, 32, generator=g)
    lung = (torch.rand(2, 16, 32, 32, generator=g) > 0.3).float()
    ref_model.calibrate_bn(sd, "med3ddram50", x[:, None], lung[:, None])
    model = get_model_by_name("med3ddram50")
    model.load_state_dict(sd)
    with torch.no_grad():
        dense, fracs = model(x[..., None], lung[..., None])
        rd, rf = ref_model.forward({k: v.clone() for k, v in sd.items()},
                                   "med3ddram50", x[:, None], lung[:, None])
    for a, b in zip(dense, rd):
        assert 0.1 < float(b.std()) and 0.05 < float(b.mean()) < 0.95
        torch.testing.assert_close(a[..., 0], b[:, 0], rtol=0, atol=2e-4)
    for a, b in zip(fracs, rf):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6)


def test_bottleneck_processor_matches_the_program(tmp_path):
    """The tiny Bottleneck cell on the device path: judged correct, and
    its forward split into trunk and decoder per batch."""
    res = tiny50.run(tmp_path, trace=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["frac_gap"]["value"] < 1e-4
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["proc.trunk_ms"] > 0 and m["proc.decoder_ms"] > 0
    assert m["proc.trunk_ms"] + m["proc.decoder_ms"] == pytest.approx(
        m["proc.forward_ms"], rel=0.02)


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_reader_reads_its_interval_per_batch(name):
    read = _reader(name)
    rec = _record({"forward": 300.0})
    assert read(rec) is None and read({}) is None
    rec = _record({"forward": 300.0, "trunk": 200.0, "decoder": 100.0})
    assert read(rec) == pytest.approx(rec["proc"]["stage_ms"][SPLIT[name]]
                                      / rec["proc"]["batches"])
    rec["proc"]["batches"] = 0
    assert read(rec) is None


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_reader_is_in_the_manifest(name):
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in manifest["per_layer"] if m["name"] == name)
    assert (entry["source"], entry["moves"], entry["unit"]) == (
        "program_span", "scans_per_s", "ms/batch")
    assert entry["layer"] == next(
        m["layer"] for m in manifest["per_layer"]
        if m["name"] == "proc.forward_ms")
    assert entry["workloads"] == ["proc.med3ddram.cohort", CELL]


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(CELL, man, harness.BENCH)
    ctx = harness.Context(CELL, spec, 0, 0, False, "cuda", 1,
                          tmp_path / "work", harness.BENCH)
    driver = harness.load_module(spec["driver"])
    r = control.processor_readings(ctx, driver, 2 ** 31 + 11)
    lim = ctx.limits
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    assert any(r["control"][k] > lim[k] for k in lim)
    assert r["program_correct"] and not r["control_correct"]
