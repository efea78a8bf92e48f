"""The benchmark's harness: one run of one cell, and its result line.

Everything that belongs to one cell is found by name:

- ``BENCHMARK.json`` (the repository root): the cell (its configuration,
  traffic and chips) and the metrics it reports;
- ``configs/<config>.json``: the model configuration, as run;
- ``traffic/<traffic>.json``: the traffic mix's parameters and the
  ``driver`` that runs it;
- ``drivers/<driver>.py``: ``run(ctx) -> record``, the set-up, the
  measured window and the check against the reference;
- ``layer_metrics/<metric>.py``: ``read(record) -> float or None``, one
  per per-layer metric;
- ``kernel_classes/<class>.txt``: kernel-name patterns (``fnmatch``), one
  per line;
- ``limits/<cell>.json``: each compared number's limit.

So a new cell, configuration, traffic mix, metric, driver or kernel class
is a new file.  Run one cell with::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bodyct_dram_emph_subtype_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def bytes_written() -> Dict[str, int]:
    """``wchar`` (bytes handed to ``write``) and ``write_bytes`` (bytes
    sent to storage so far) of this process, from ``/proc/self/io``."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots."""
    name = "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_patterns(cls: str, bench: Path = BENCH) -> List[str]:
    lines = (bench / "kernel_classes" / f"{cls}.txt").read_text()
    return [s.strip() for s in lines.splitlines()
            if s.strip() and not s.lstrip().startswith("#")]


def cell_metrics(manifest: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics that ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (``workloads`` lists the cells; without
    it, every cell that reports the metric it ``moves``)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def cell_spec(cell: str, manifest: Dict, bench: Path = BENCH) -> Dict:
    work = next((w for w in manifest["workloads"] if w["name"] == cell),
                None)
    if work is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in manifest['workloads']]}")
    conf = next(c for c in manifest["configs"] if c["name"] == work["config"])
    traffic = load_json(bench / "traffic" / f"{work['traffic']}.json")
    return {"workload": work, "config": load_json(bench.parent / conf["file"]),
            "traffic": traffic,
            "limits": load_json(bench / "limits" / f"{cell}.json"),
            "driver": bench / "drivers" / f"{traffic['driver']}.py"}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unknown ({exc})"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Context:
    """What a driver gets: the cell's files, the run's arguments, its work
    directory, and the clocks of set-up."""

    def __init__(self, cell: str, spec: Dict, seed: int, seconds: float,
                 trace: bool, device: str, chips: int, work: Path,
                 bench: Path = BENCH):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.chips = trace, device, chips
        self.workload, self.config = spec["workload"], spec["config"]
        self.traffic, self.limits = spec["traffic"], spec["limits"]
        self.work, self.bench = work, bench
        self.setup_parts: Dict[str, float] = {}
        self.setup_s: Optional[float] = None
        self.log = log

    @contextlib.contextmanager
    def part(self, name: str):
        """Times one part of set-up (printed, and summed by name)."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + dt
        log(f"setup part {name}: {dt:.3f} s")

    def window_starts(self) -> None:
        """Called by the driver as the first measured unit begins."""
        self.setup_s = process_age_s()
        log(f"setup_s {self.setup_s:.3f} (parts: "
            + ", ".join(f"{k} {v:.3f}" for k, v in self.setup_parts.items())
            + ")")

    def kernel_patterns(self, cls: str) -> List[str]:
        return kernel_patterns(cls, self.bench)

    def peaks(self) -> Dict[str, float]:
        return load_json(self.bench / "peaks.json")


def judge(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", manifest: Optional[Dict] = None,
             bench: Path = BENCH, work: Optional[Path] = None,
             driver_hook: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object.  ``device``
    ``cpu`` and ``bench``/``manifest``/``work`` elsewhere serve the tests;
    ``driver_hook(module)`` may patch the driver's module before the
    run."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    spec = cell_spec(cell, manifest, bench)
    chips = int(spec["workload"]["chips"])
    work = work or ROOT / "bench_work" / cell
    ctx = Context(cell, spec, seed, seconds, trace, device, chips, work,
                  bench)
    driver = load_module(spec["driver"])
    if driver_hook is not None:
        driver_hook(driver)
    written0 = bytes_written()
    rec = driver.run(ctx)
    rec.setdefault("setup_s", ctx.setup_s)
    metrics = {}
    for m in cell_metrics(manifest, cell, trace):
        if trace:
            value = load_module(bench / "layer_metrics" /
                                f"{m['name']}.py").read(rec)
        else:
            value = rec["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = rec["checks"]
    result = {"correct": bool(rec["failed"] == 0 and judge(checks)),
              "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": rec["device"]}
    if trace and rec.get("breakdown"):
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    written1 = bytes_written()
    log("bytes written by this run: " + ", ".join(
        f"{k} {written1[k] - written0.get(k, 0)}" for k in written1))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell_spec(args.workload, manifest)["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count = "
            f"{torch.cuda.device_count()}: no measurement without the card")
        return 2
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi name, power.limit: "
        f"{power_limit()}; peaks (H100 SXM data sheet): "
        f"{load_json(BENCH / 'peaks.json')}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), manifest=manifest)
    found = forbidden_modules()
    if found:
        log(f"refused: modules of JAX or the JAX package were loaded: "
            f"{found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
