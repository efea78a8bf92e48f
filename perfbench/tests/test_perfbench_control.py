"""The control (the reference in float8, in the program's place) fails
what the sound program passes: on the CPU at a tiny size, and marked
``cuda``, at the cells' own size on the card."""
import pytest
import torch

from perfbench import control, harness
from perfbench.tests import tiny


def _ctx(tmp_path, cell, device):
    bench, man = tiny.make_bench(tmp_path)
    if device == "cuda":
        bench, man = harness.BENCH, harness.load_json(
            harness.ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(cell, man, bench)
    ctx = harness.Context(cell, spec, 0, 0, False, device, 1,
                          tmp_path / "work", bench)
    return ctx, harness.load_module(spec["driver"])


def test_processor_control_fails_on_the_cpu(tmp_path):
    ctx, driver = _ctx(tmp_path, "proc.tiny", "cpu")
    r = control.processor_readings(ctx, driver, 2 ** 31 + 5)
    lim = ctx.limits
    assert all(r["program"][k] <= lim[k] for k in lim)
    assert any(r["control"][k] > lim[k] for k in lim)
    assert r["program_correct"] and not r["control_correct"]


def test_trainer_control_and_half_batch_fail_on_the_cpu(tmp_path):
    ctx, driver = _ctx(tmp_path, "train.tiny", "cpu")
    r = control.trainer_readings(ctx, driver, 2 ** 31 + 9)
    lim = ctx.limits
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    for side in ("control", "half_batch"):
        assert any(r[side][k] > lim[k] for k in lim if k in r[side]), side


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["proc.med3ddram.cohort",
                                  "proc.med3ddram.wide"])
def test_control_fails_at_the_cells_size(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    ctx, driver = _ctx(tmp_path, cell, "cuda")
    readings = getattr(control, f"{ctx.traffic['driver']}_readings")
    r = readings(ctx, driver, 2 ** 31 + 11)
    lim = ctx.limits
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    assert any(r["control"][k] > lim[k] for k in lim if k in r["control"])
    if "control_correct" in r:
        assert r["program_correct"] and not r["control_correct"]
