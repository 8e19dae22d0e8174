"""The readings the correctness limits are set from (``PERF.md`` gives
them). Not run by the benchmark's runs.

    python3 -m benchmark.control --workload gr1t1.plane --seeds 11 12 13 --faults 3 [--draw-paths 20]

For each seed, set-up exactly as a run makes it (the program driven
through the checked iterations at the cell's own size), then the numbers
``check.compare`` gives for:

- ``program``: the program against the reference (the lower readings);
- ``control``: the reference at the precision below the stated one in the
  program's place (``check.control_precision``: the env step in bfloat16,
  the policy step and GAE in bfloat16, the update's operands in fp8);
- on the first ``--faults`` seeds, faults planted in the reference put in
  the program's place: ``half_batch`` (each grad step's mean over half its
  minibatch), ``altered`` (one action of the rollout changed by 1.0 where
  the policy step produced it), ``friction`` (the env's friction x1.05 in
  the decimation loop), ``substep_less`` (the decimation loop one substep
  short) and, across ranks, ``no_exchange`` (rank 0 updating on its own
  shard alone). A step that returns its state unchanged reads 1 on the
  weights' change by its definition.

Beside each, the diagnostics the limits were looked at with: each
iteration's learning rate over the reference's (``lr1``..), loss gap and
weights' change by the worst leaf, and the 99th percentile of the sampled
envs' gaps. With ``--draw-paths N``, on the first seed, the compiled
iteration's median milliseconds over N calls with the benchmark's injected
draws and over N with the program's own draws (its other collection graph).

One JSON line a seed on standard output; across ranks each seed is a new
process group.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import statistics
import sys
import time
from typing import List

import torch

from benchmark import check, session, spec
from benchmark.reference.precision import exact_matmuls


def diagnostics(got: List[dict], want: List[dict], p0, config) -> dict:
    """Per iteration: the learning rate's ratio, the loss gap and the
    weights' change by the worst leaf; and the envs' 99th-percentile gap."""
    out = {}
    counted = check.counted_leaves(want[0]["first_grad"], config)
    starts = [p0.cpu()] + [g["after"]["params"] for g in got[:-1]]
    for i, (g, w, start) in enumerate(zip(got, want, starts), start=1):
        out[f"lr{i}"] = g["metrics"]["lr"] / w["metrics"]["lr"]
        lg, lw = check.loss_of(g["metrics"], config), check.loss_of(w["metrics"], config)
        out[f"loss{i}"] = abs(lg - lw) / max(abs(lw), 1e-30)
        out[f"dparam{i}"] = check._worst_leaf(check._leaf_norms(g["after"]["params"] - start, config),
                                              check._leaf_norms(w["after"]["params"] - start, config), counted)[0]
    # the second moment (Adam's v) each update added, the norm of each leaf
    vstarts = [torch.zeros_like(p0).cpu()] + [g["after"]["v"] for g in got[:-1]]
    for i, (g, w, v0) in enumerate(zip(got, want, vstarts), start=1):
        gv, wv = check._leaf_norms(g["after"]["v"] - v0, config), check._leaf_norms(w["after"]["v"] - v0, config)
        out[f"v{i}"] = check._worst_leaf(gv, wv, counted)[0]
        out[f"v{i}_median"] = _median_leaf(gv, wv, counted)
        out[f"kl{i}"] = abs(g["metrics"]["kl"] - w["metrics"]["kl"]) / max(abs(w["metrics"]["kl"]), 1e-30)
        out[f"margin{i}"] = w["kl_margin"]
    if "env" in want[0]:
        gaps = torch.cat([check.env_gaps(g.get("env") or check.program_envs(g), w["env"])
                          for g, w in zip(got, want)])
        out["env_p99"] = float(torch.quantile(gaps.clamp(max=1e30), 0.99))
    return out


def _median_leaf(got, want, counted) -> float:
    med = statistics.median(want[k] for k in counted)
    return statistics.median(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in counted)


def readings_from(cell: dict, every: List[List[dict]], p0, groups: int, faults: bool, dev,
                  control: bool = True, env: bool = True) -> dict:
    """The readings of one seed from every rank's checked iterations."""
    config = cell["config"]
    snaps = check.join_ranks(every) if len(every) > 1 else every[0]
    exact_matmuls()
    stated = check.stated_precision(config)
    t0 = time.perf_counter()
    ref = check.follow(snaps, p0, config, groups, stated, dev, env_step=env)
    out = {"reference_s": time.perf_counter() - t0}
    value = lambda nums: {k: v["value"] for k, v in nums.items()}

    def reading(got):
        return dict(value(check.compare(got, ref, p0, config)), **diagnostics(got, ref, p0, config))

    out["program"] = reading(snaps)
    if control:
        out["control"] = reading(check.follow(snaps, p0, config, groups, check.control_precision(config), dev,
                                              env_step=env))
    if faults:
        half = check.follow(snaps, p0, config, groups, stated, dev, half_batch=True, env_step=False)
        out["half_batch"] = reading([dict(r, after=h["after"], metrics=h["metrics"]) for r, h in zip(ref, half)])
        altered = copy.deepcopy(ref)
        altered[0]["actions"][0, 0, 0] += 1.0
        out["altered"] = reading(altered)
        for name, fault in (("friction", {"friction_scale": 1.05}), ("substep_less", {"substeps_less": 1}))[:2 * env]:
            planted = check.follow(snaps, p0, config, groups, stated, dev, env_fault=fault, update=False)
            out[name] = reading([dict(r, env=f["env"]) for r, f in zip(ref, planted)])
        if len(every) > 1:   # rank 0 updating on its own shard alone
            alone = check.follow(every[0], p0, config, groups // len(every), stated, dev, env_step=False)
            out["no_exchange"] = reading([dict(r, after=a["after"], metrics=a["metrics"]) for r, a in zip(ref, alone)])
    return out


def draw_paths(cell: dict, seed: int, dev: torch.device, calls: int) -> dict:
    """Median ms of the compiled iteration over ``calls`` calls with the
    benchmark's injected draws, then over ``calls`` with the program's own
    (after one warm-up call of that graph)."""
    run, _, feed, _, _, _ = session.set_up(0, 1, cell, seed, dev)

    def timed(call):
        walls = []
        for _ in range(calls):
            t = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t)
        return statistics.median(walls) * 1e3

    injected = timed(lambda: run.step(*feed.next()))
    own = lambda: setattr(run, "state", run.runner._train_iter(run.state)[0])
    own()
    internal = timed(own)
    injected_again = timed(lambda: run.step(*feed.next()))
    run.release()
    return {"injected_ms": injected, "own_draws_ms": internal, "injected_again_ms": injected_again}


def readings(cell: dict, seed: int, dev: torch.device, faults: bool, control: bool = True,
             env: bool = True) -> dict:
    """One seed's readings on one card."""
    t0 = time.perf_counter()
    run, p0, feed, snaps, _, _ = session.set_up(0, 1, cell, seed, dev)
    groups = run.geometry()["groups"]
    run.release()
    del run, feed
    session.free(dev)
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    out.update(readings_from(cell, [snaps], p0, groups, faults, dev, control, env))
    return out


def _rank_readings(rank, world, init_method, cell, seed, faults, device_type="cuda"):
    """One seed's readings across ranks: each rank's set-up, then rank 0's
    readings over the joined batch."""
    from benchmark import program, run as run_mod

    dev = torch.device(device_type, rank if device_type == "cuda" else None)
    t0 = time.perf_counter()
    run, p0, feed, snaps, dp, ctl = session.set_up(rank, world, cell, seed, dev, init_method)
    groups = run.geometry()["groups"] * world
    run.release()
    del run, feed
    session.free(dev)
    setup_s = time.perf_counter() - t0
    every = run_mod.gather(snaps, rank, world, ctl)
    program.destroy_group(dp)
    if rank == 0:
        out = {"seed": seed, "setup_s": setup_s}
        out.update(readings_from(cell, every, p0, groups, faults, dev))
        return out
    return None


def _json_safe(x):
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    return None if isinstance(x, float) and not math.isfinite(x) else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3, help="plant the faults on this many of the first seeds")
    ap.add_argument("--controls", type=int, default=3, help="read the control on this many of the first seeds")
    ap.add_argument("--draw-paths", type=int, default=0, help="time this many calls of each draw path")
    ap.add_argument("--no-env", action="store_true", help="leave the env step's readings out")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark.control: {args.workload} needs {chips} card(s)", file=sys.stderr)
        return 2
    from benchmark import run as run_mod

    run_mod.set_caches()
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        if chips == 1:
            out = readings(cell, seed, dev, i < args.faults, i < args.controls, not args.no_env)
        else:
            out = run_mod.across_ranks(chips, _rank_readings, cell, seed, i < args.faults)
        print(json.dumps(_json_safe(out)), flush=True)
    if args.draw_paths and chips == 1:
        print(json.dumps({"draw_paths": draw_paths(cell, args.seeds[0], dev, args.draw_paths)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
