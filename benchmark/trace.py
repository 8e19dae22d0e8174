"""The traced run's reading of ``torch.profiler``: the device's intervals
(kernels, copies, sets) inside the traced iterations, the host's ranges
around them, and what follows from them: busy seconds, the window's
length, kernel time by name and the longest idle gaps by what the host was
doing."""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

ITERATION_RANGE = "benchmark.iteration"


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    return fn() if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device events, host events) of a stopped profiler, each
    ``(name, start ns, end ns)``; host events also carry their thread."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type()).split(".")[-1]
        start = _ns(ev, "start")
        end = start + ev.duration_ns()
        if kind == "CUDA" and not ev.is_user_annotation():   # not a host range's shadow
            dev.append((ev.name(), start, end))
        elif kind == "CPU":
            host.append((ev.name(), start, end, ev.start_thread_id()))
    return dev, host


def window(host: List[tuple]) -> Tuple[int, int, int]:
    """(start ns, end ns, iterations) of the traced iterations' ranges."""
    its = [(s, e) for name, s, e, _ in host if name == ITERATION_RANGE]
    if not its:
        raise RuntimeError(f"the trace holds no {ITERATION_RANGE!r} range")
    return min(s for s, _ in its), max(e for _, e in its), len(its)


def busy_intervals(dev: List[tuple], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The union of the device's intervals, cut to [t0, t1]."""
    spans = sorted((max(s, t0), min(e, t1)) for _, s, e in dev if e > t0 and s < t1)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summary(prof, top: int = 10) -> dict:
    """What the metric readers take from a trace: the window, the device's
    busy seconds in it, each kernel's events (name, seconds) in it, and the
    breakdown (the device ops that took most time, the longest idle gaps
    named by the innermost host range open where each began)."""
    dev, host = events(prof)
    t0, t1, n = window(host)
    inside = [(name, s, e) for name, s, e in dev if e > t0 and s < t1]
    busy = busy_intervals(inside, t0, t1)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for name, s, e in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(t0, busy[0][0]), *gaps, (busy[-1][1], t1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
    main_thread = next(th for name, _, _, th in host if name == ITERATION_RANGE)
    host_main = [(name, s, e) for name, s, e, th in host if th == main_thread]

    def doing(at: int) -> str:
        open_ = [(e - s, name) for name, s, e in host_main if s <= at < e]
        return min(open_)[1] if open_ else "(no host range)"

    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "iterations": n,
        "kernels": [(name, (e - s) / 1e9) for name, s, e in inside],
        "device_ops": sorted(([short(k), v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[short(doing(s)), (e - s) / 1e9] for s, e in gaps],
    }


def short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def matching(kernels: List[tuple], names) -> List[float]:
    """The seconds of each kernel event whose function is one of ``names``
    (whole identifiers, in a demangled or plain kernel name)."""
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")(?![A-Za-z0-9_])")
    return [sec for name, sec in kernels if pat.search(name)]
