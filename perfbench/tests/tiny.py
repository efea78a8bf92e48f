"""A benchmark directory with tiny cells, for the CPU tests.

:func:`make_bench` copies the benchmark's drivers, readers and kernel
classes into a temporary ``perfbench`` directory and adds, as new files
only, a tiny configuration (``med3ddramtiny`` at 16x24x32), tiny traffic
mixes and their limits, and the cells ``proc.tiny`` (device path),
``proc.tiny.wide`` (every crop wider than the pad) and ``train.tiny``;
the returned manifest is ``BENCHMARK.json`` with those cells added, and
the trainer's metrics (:data:`TRAIN_E2E`, :data:`TRAIN_LAYER`).  This is
how a later cell is added: files, and entries in the manifest.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Tuple

from perfbench import harness

# limits of the tiny cells (float32 on the CPU), not the chip's
PROC_LIMITS = {"frac_gap": 1e-4, "heat_gap": 0.05, "heat_over4": 1e-3}
TRAIN_LIMITS = {"start_gap": 1e-4, "start_masks": 0, "aug_gap": 1e-4,
                "aug_masks": 0, "map_over": 1e-3, "loss_gap_step1": 1e-4,
                "update_gap": 0.5}


# The trainer's end-to-end and per-layer metrics, for the tiny trainer
# cell (BENCHMARK.json has no trainer cell yet: PERF.md section 7).
TRAIN_E2E = [
    {"name": n, "unit": u, "better": b, "bound": bound, "source": src}
    for n, u, b, bound, src in (
        ("volumes_per_s", "volumes/s", "higher", 0.05, "host_clock"),
        ("step_ms_p90", "ms", "lower", 0.05, "host_clock"),
        ("peak_mem_gib", "GiB", "lower", 0.01, "device_trace"))]
TRAIN_LAYER = [
    {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
     "moves": "volumes_per_s"}
    for n, u, b, src, layer in (
        ("train.loader_wait_ms", "ms/step", "lower", "host_clock",
         "train loader"),
        ("train.augment_ms", "ms/step", "lower", "program_span", "augment"),
        ("train.forward_ms", "ms/step", "lower", "program_span",
         "train forward + losses"),
        ("train.backward_ms", "ms/step", "lower", "program_span",
         "backward"),
        ("train.optimizer_ms", "ms/step", "lower", "program_span",
         "optimizer"),
        ("conv_roofline.train", "%", "higher", "device_trace", "kernels"),
        ("mfu.train", "%", "higher", "host_clock",
         "the whole step on the device"),
        ("idle_share.train", "%", "lower", "device_trace", "device"))]


def _dump(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_bench(tmp: Path) -> Tuple[Path, Dict]:
    src = harness.BENCH
    bench = tmp / "perfbench"
    shutil.rmtree(bench, ignore_errors=True)
    for d in ("drivers", "layer_metrics", "kernel_classes"):
        shutil.copytree(src / d, bench / d)
    shutil.copy(src / "peaks.json", bench / "peaks.json")
    conf = harness.load_json(src / "configs" / "med3ddram.json")
    conf.update(name="tiny", arch="med3ddramtiny", input_size=[16, 24, 32],
                head_std=0.05, compute_dtype="float32")
    _dump(conf, bench / "configs" / "tiny.json")
    proc = harness.load_json(src / "traffic" / "proc_cohort.json")
    proc.update(shape=[48, 96, 112], spacing_zyx=[1.5, 1.5, 1.5],
                scans=[{"lung_box": [32, 56, 72]}, {"lung_box": [30, 52, 70]},
                       {"lung_box": [28, 50, 66]}],
                pad_shape=[24, 64, 80], heat_sample=2)
    _dump(proc, bench / "traffic" / "proc_tiny.json")
    wide = dict(proc, scans=[{"lung_box": [32, 66, 72]},
                             {"lung_box": [30, 62, 70]}])
    _dump(wide, bench / "traffic" / "proc_tiny_wide.json")
    train = harness.load_json(src / "traffic" / "train_b2.json")
    train.update(volumes=4, crop_shape=[24, 32, 40], crop_border=2,
                 cle_labels=[0, 1, 2, 3], pse_labels=[0, 1, 2, 0],
                 num_samples=64, workers=1, trace_steps=2,
                 pad_shape=[24, 32, 40])
    _dump(train, bench / "traffic" / "train_tiny.json")
    for cell, limits in (("proc.tiny", PROC_LIMITS),
                         ("proc.tiny.wide", PROC_LIMITS),
                         ("train.tiny", TRAIN_LIMITS)):
        _dump(limits, bench / "limits" / f"{cell}.json")
    man = harness.load_json(harness.ROOT / "BENCHMARK.json")
    man["end_to_end"] += [dict(m, workloads=["train.tiny"])
                          for m in TRAIN_E2E]
    man["per_layer"] += [dict(m, workloads=["train.tiny"])
                         for m in TRAIN_LAYER]
    man["configs"].append({"name": "tiny", "source": "tests",
                           "file": "perfbench/configs/tiny.json",
                           "reduced": [], "why": "tests"})
    for cell, traffic, like in (
            ("proc.tiny", "proc_tiny", "proc.med3ddram.cohort"),
            ("proc.tiny.wide", "proc_tiny_wide", "proc.med3ddram.wide"),
            ("train.tiny", "train_tiny", None)):
        man["workloads"].append({"name": cell, "config": "tiny",
                                 "traffic": traffic, "chips": 1,
                                 "why": "tests"})
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    return bench, man


def run(tmp: Path, cell: str, trace: bool = False, seconds: float = 1.0,
        seed: int = 2 ** 31 + 77, driver_hook=None):
    """One CPU run of a tiny cell; the result line's object."""
    bench, man = make_bench(tmp)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            manifest=man, bench=bench, work=tmp / "work",
                            driver_hook=driver_hook)
