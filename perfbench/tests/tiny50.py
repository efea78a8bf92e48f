"""The tiny benchmark of :mod:`perfbench.tests.tiny` with one more cell,
``proc.tiny50``: the Bottleneck configuration ``med3ddram50.deploy`` at its
published widths, at the tiny input 16x24x32 in float32, on the tiny
cohort's device path.  Added as files and manifest entries only, the way
a later cell is added; it reports the metrics that list
``proc.med3ddram50.cohort``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

from perfbench import harness
from perfbench.tests import tiny

CELL = "proc.tiny50"


def make_bench(tmp: Path) -> Tuple[Path, Dict]:
    bench, man = tiny.make_bench(tmp)
    conf = harness.load_json(harness.BENCH / "configs" /
                             "med3ddram50.deploy.json")
    conf.update(name="tiny50", input_size=[16, 24, 32],
                compute_dtype="float32")
    tiny._dump(conf, bench / "configs" / "tiny50.json")
    tiny._dump(tiny.PROC_LIMITS, bench / "limits" / f"{CELL}.json")
    man["configs"].append({"name": "tiny50", "source": "tests",
                           "file": "perfbench/configs/tiny50.json",
                           "reduced": [], "why": "tests"})
    man["workloads"].append({"name": CELL, "config": "tiny50",
                             "traffic": "proc_tiny", "chips": 1,
                             "why": "tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "proc.med3ddram50.cohort" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    return bench, man


def run(tmp: Path, trace: bool = False, seconds: float = 1.0,
        seed: int = 2 ** 31 + 77):
    """One CPU run of ``proc.tiny50``; the result line's object."""
    bench, man = make_bench(tmp)
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            manifest=man, bench=bench, work=tmp / "work")
