"""One rank's run of a cell: set-up, the measured window, and what rank 0
needs afterwards.

Set-up builds the run, hands it the benchmark's starting weights and runs
the checked iterations through the window's own call and feed (the first
is the CUDA graphs' warm-up and capture); the same run then goes into the
window. The window calls the compiled iteration back to back, each call
ended by the iteration's own synchronize, until ``--seconds`` have passed;
across ranks rank 0 decides each next call and tells the others over a
gloo group of the benchmark's. With ``--trace 1`` the profiler records
``TRACED`` more iterations of the same call after the window.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from benchmark import check, draws, program
from benchmark.reference.ppo import shuffle_geometry

CHECKED = 3   # iterations the reference follows
TRACED = 3    # iterations the profiler records


def _geometry_agrees(geo: dict, config: dict):
    alg = config["algorithm"]
    npg = geo["n"] // geo["groups"]
    _, blocks, used, rows = shuffle_geometry(geo["t"], npg, alg["shuffle_block"], alg["num_mini_batches"])
    if (blocks, used, rows * geo["groups"]) != (geo["blocks"], geo["used"], geo["rows"]):
        raise ValueError(f"the program's shuffle {geo} is not the configuration's "
                         f"({blocks} blocks, {used} used, {rows * geo['groups']} rows)")


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))


class Stop:
    """Whether the window goes on: rank 0's clock decides, and across ranks
    its decision is broadcast before every call."""

    def __init__(self, seconds: float, group=None):
        self.seconds, self.group = seconds, group
        self.flag = torch.zeros(1, dtype=torch.int32)

    def __call__(self, rank: int, t0: float) -> bool:
        if rank == 0:
            self.flag[0] = int(time.perf_counter() - t0 >= self.seconds)
        if self.group is not None:
            torch.distributed.broadcast(self.flag, src=0, group=self.group)
        return bool(self.flag[0])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def set_up(rank: int, world: int, cell: dict, seed: int, dev: torch.device, init_method: Optional[str] = None):
    """The rank's run with the benchmark's starting weights, driven through
    the checked iterations. Returns (run, starting weights, the draws'
    feed, the checked iterations' snapshots, the NCCL group, the
    benchmark's gloo group)."""
    config, traffic = cell["config"], cell["traffic"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dp = ctl = None
    if world > 1:
        dp = program.init_group(rank, world, init_method)
        ctl = torch.distributed.new_group(backend="gloo")
    run = program.Run(config, traffic, seed, dev, dp)
    if run.eager_reason is not None:
        raise RuntimeError(f"the cell's iteration is not compiled: {run.eager_reason}")
    geo = run.geometry()
    _geometry_agrees(geo, config)
    p0 = draws.make_params(config, seed, dev)
    run.set_params(p0)
    feed = draws.Draws(seed, rank, geo["t"], geo["n"], geo["a"], geo["k"], geo["blocks"], geo["used"], dev)
    env_ids = draws.env_sample(seed, rank, world, geo["n"])
    snaps = []
    for _ in range(CHECKED):
        before = run.ppo()["params"].clone()
        env_before = run.env_state(env_ids - rank * geo["n"])
        noise, u, perm = feed.next()
        metrics = run.step(noise, u, perm)
        snaps.append(check.snapshot(run, before, env_before, env_ids, noise, u, perm, metrics))
        del before, noise, u, perm
    _sync(dev)
    return run, p0, feed, snaps, dp, ctl


def free(dev: torch.device):
    """Return the memory of what was dropped (a run released and deleted)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_rank(rank: int, world: int, cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             init_method: Optional[str] = None, device: Optional[torch.device] = None) -> dict:
    """Set-up and window of one rank. Returns its results: the iterations'
    wall times and CUDA-event timing, the set-up seconds, the window's
    length, the memory peak, the non-finite losses, the graphs' reports,
    the trace's summary, and the checked iterations' snapshots. ``device``:
    the rank's card (default ``cuda:<rank>``; the CPU only in the
    benchmark's own tests, with the compiled iteration stood in)."""
    dev = device or torch.device("cuda", rank)
    run, p0, feed, snaps, dp, ctl = set_up(rank, world, cell, seed, dev, init_method)
    geo = run.geometry()
    if ctl is not None:
        torch.distributed.barrier(group=ctl)
    setup_s = time.perf_counter() - t_start

    stop = Stop(seconds, ctl)
    walls, timing = [], []
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def iteration():
        t = time.perf_counter()
        with torch.profiler.record_function("benchmark.iteration"):
            noise, u, perm = feed.next()
            metrics = run.step(noise, u, perm)
        walls.append(time.perf_counter() - t)
        timing.append(run.timing())
        bad.add_((~torch.isfinite(metrics["value_loss"] + metrics["surrogate_loss"])).to(torch.int64))

    t0 = time.perf_counter()
    while not stop(rank, t0):
        iteration()
    window_s = time.perf_counter() - t0
    prof = None
    if trace:   # the window's call, TRACED more times, under the profiler
        prof = _profiler(dev)
        prof.start()
        for _ in range(TRACED):
            iteration()
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {
        "rank": rank, "setup_s": setup_s, "window_s": window_s, "walls": walls, "timing": timing,
        "traced": TRACED if trace else 0, "peak": peak, "bad": int(bad), "reports": run.reports(),
        "geometry": geo, "p0": p0.cpu(), "snaps": snaps,
    }
    run.release()
    del run, feed
    free(dev)
    if prof is not None:
        from benchmark import trace as trace_mod

        out["trace"] = trace_mod.summary(prof)
        del prof
    out["dp"], out["ctl"] = dp, ctl
    return out
