"""The measured window's end-to-end numbers, from the iterations' host
clock: each iteration's wall time, ended by the iteration's own
synchronize."""

from __future__ import annotations

import math
from typing import List, Sequence


def rate(env_steps_per_iteration: int, iterations: int, seconds: float) -> float:
    """Env steps per second over the whole window: every iteration's env
    steps over the time from the window's start to the end of its last
    iteration."""
    return env_steps_per_iteration * iterations / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def slowest(per_rank: List[Sequence[float]]) -> List[float]:
    """Each iteration's slowest rank."""
    return [max(ts) for ts in zip(*per_rank)]

