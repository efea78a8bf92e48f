"""The end-to-end arithmetic of a measured window, on host-clock times.

Every rate is taken over all the work and all the time of the window, and
every tail over all its units: nothing here is a median of chunks.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def jobs_rate(jobs: Sequence[Tuple[float, float, int]]) -> float:
    """Units per second of jobs ``(start, end, units)`` run back to back:
    all units over the first start to the last end."""
    if not jobs:
        raise ValueError("no jobs")
    return sum(n for _, _, n in jobs) / (max(e for _, e, _ in jobs)
                                         - min(s for s, _, _ in jobs))


def step_times(boundaries: Sequence[float]) -> List[float]:
    """Each step's wall time from its batch fetch to the next one's."""
    b = list(boundaries)
    return [t1 - t0 for t0, t1 in zip(b, b[1:])]


def steps_rate(boundaries: Sequence[float], units_per_step: float) -> float:
    """Units per second over the steps between the first and the last
    boundary (each step's units counted once it has ended)."""
    n = len(boundaries) - 1
    if n < 1:
        raise ValueError("fewer than two step boundaries")
    return n * units_per_step / (boundaries[-1] - boundaries[0])


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between the two nearest ranks."""
    return float(np.percentile(np.asarray(values, np.float64), q))
