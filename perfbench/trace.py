"""The profiler window and its reduction to device numbers.

:func:`profiled` runs a unit of work under ``torch.profiler`` (CPU and
CUDA activities) inside a ``perfbench.window`` annotation and returns a
:class:`Trace` read from the exported Chrome trace: the window is that
annotation's span, in the same clock as the device's operations.

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, fills) inside the window;
- ``class_seconds(patterns)``: the summed time of the kernels whose names
  match a kernel class's ``fnmatch`` patterns;
- ``top_ops``: the device operations that took most time, by name;
- ``idle_gaps``: the longest gaps between device operations, each named
  by the innermost host span (annotation or operator, any thread) open at
  its middle.
"""
from __future__ import annotations

import fnmatch
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "perfbench.window"


class Trace:
    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") in HOST_CATS]
        if not win:
            raise ValueError("the trace holds no perfbench.window span")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.device.append((e["name"], e["cat"], a, b))
        self.host = [(e["name"], float(e["ts"]), float(e["ts"]) + float(
            e.get("dur", 0))) for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
        self.window_s = (self.t1 - self.t0) * 1e-6
        self._busy = self._union()

    def _union(self) -> List[Tuple[float, float]]:
        spans = sorted((a, b) for _, _, a, b in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-6

    def class_seconds(self, patterns: Sequence[str]) -> float:
        return sum(b - a for name, cat, a, b in self.device
                   if cat == "kernel" and any(
                       fnmatch.fnmatchcase(name, p) for p in patterns)) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for name, _, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:200], v] for k, v in sorted(
            tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        edges = [self.t0] + [x for span in self._busy for x in span] + \
            [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for dur, a, b in gaps:
            mid = (a + b) / 2
            open_spans = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(open_spans, key=lambda h: h[2] - h[1])[0]
                    if open_spans else "host, no torch op open")
            out.append([name[:200], dur * 1e-6])
        return out


def profiled(fn: Callable[[], object], out_dir: Path, device_type: str
             ) -> Tuple[object, Trace]:
    """``fn()`` under the profiler; (its result, the :class:`Trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
            if device_type == "cuda":
                torch.cuda.synchronize()
    return result, from_profiler(prof, path)


def from_profiler(prof, path: Path) -> Trace:
    """The :class:`Trace` of a stopped profiler, read through a Chrome
    trace file at ``path`` (removed afterwards)."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return Trace(events)
