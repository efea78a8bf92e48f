"""Named host spans: the port's one span mechanism.

``with span(name, into=counters):`` times the block with
``time.perf_counter()`` and adds its milliseconds to ``counters[name]``
(several threads may add into one dict: the add holds a lock); while a
``torch.profiler`` runs it also opens ``record_function(name)``, so the
block appears under its name in the trace.  The profiler check reads the
flag that a running profiler sets for every thread; ``record_function``
itself costs about 16 us even with no profiler, so it is opened only then.
With no profiler and no ``into`` a span does nothing.

:func:`profiler` is the ``torch.profiler.profile`` of the entry points'
``--profile``: CPU and, on a card, CUDA activities, every thread's spans.
CUDA events stay the device-side spans (``inference/processor.py::
_StageClock``, the trainer's step marks).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

_ADD = threading.Lock()


class span:
    """Context manager: the block's milliseconds added to ``into[name]``
    (when ``into`` is given) and, under a running profiler, a
    ``record_function(name)`` span around it."""

    __slots__ = ("name", "into", "_t0", "_rf")

    def __init__(self, name: str, into: Optional[Dict[str, float]] = None):
        self.name = name
        self.into = into
        self._rf = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.into is not None:
            ms = 1e3 * (time.perf_counter() - self._t0)
            with _ADD:
                self.into[self.name] = self.into.get(self.name, 0.0) + ms
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None


def profiler(device: torch.device):
    """A ``torch.profiler.profile`` of CPU and, on a CUDA ``device``, CUDA
    activities that records every thread's spans
    (``profile_all_threads``); a torch build without that option records
    the profiling thread alone, with one warning."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        from torch.profiler import _ExperimentalConfig
        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        logger.warning("this torch build cannot profile every thread: the "
                       "trace holds the profiling thread's spans only")
        return profile(activities=activities)
    return profile(activities=activities, experimental_config=config)
