"""The result line of a run, from every rank's results: the metrics, the
device, the breakdown, and the correctness check against the plain
reference (run here, after the window, on rank 0's card)."""

from __future__ import annotations

import statistics
from typing import List, Tuple

import torch

from benchmark import check, spec
from benchmark import window as win
from benchmark.reference.precision import exact_matmuls


def context(cell: dict, results: List[dict]) -> dict:
    """What the metric readers read: rank 0's iterations of the window
    (the traced ones follow it), each window iteration's slowest rank, the
    graphs' reports, the trace."""
    head = results[0]
    geo = head["geometry"]
    n = len(head["walls"]) - head["traced"]
    per_rank = [r["walls"][:n] for r in results]
    ctx = {
        "config": cell["config"], "traffic": cell["traffic"], "workload": cell["workload"], "work": cell["work"],
        "ranks": len(results), "geometry": geo,
        "env_steps_per_iteration": geo["t"] * geo["n"] * len(results),
        "walls": win.slowest(per_rank),
        "iterations": [dict(wall_s=w, **t) for w, t in zip(head["walls"][:n], head["timing"][:n])],
        "setup_s": head["setup_s"], "window_s": head["window_s"],
        "reports": head["reports"], "trace": head.get("trace"),
    }
    if ctx["trace"] is not None:
        ctx["trace"] = dict(ctx["trace"], busy_s=statistics.mean(r["trace"]["busy_s"] for r in results),
                            window_s=statistics.mean(r["trace"]["window_s"] for r in results))
    return ctx


def split(iterations: List[dict]) -> str:
    """Where the slower half of the window's iterations lost its time: the
    median wall, collection and update ms (CUDA events) of the faster and
    the slower half."""
    if len(iterations) < 2:
        return "too few iterations to split"
    ranked = sorted(iterations, key=lambda it: it["wall_s"])
    half = len(ranked) // 2
    med = lambda its, k: statistics.median(it[k] for it in its) * 1e3
    parts = [f"{name} half wall {med(its, 'wall_s'):.3f} collection {med(its, 'collection_s'):.3f} update "
             f"{med(its, 'update_s'):.3f} ms" for name, its in (("faster", ranked[:half]), ("slower", ranked[half:]))]
    return "; ".join(parts)


def end_to_end(ctx: dict) -> dict:
    walls = ctx["walls"]
    return {
        "train_env_steps_per_s": win.rate(ctx["env_steps_per_iteration"], len(walls), ctx["window_s"]),
        "iter_ms_p90": win.percentile(walls, 90) * 1e3,
        "setup_s": ctx["setup_s"],
    }


def correctness(cell: dict, results: List[dict]) -> dict:
    """The numbers compared: the reference follows the checked iterations
    (every rank's batch joined into the global one) on rank 0's card."""
    config = cell["config"]
    exact_matmuls()
    snaps = (check.join_ranks([r["snaps"] for r in results]) if len(results) > 1 else results[0]["snaps"])
    groups = results[0]["geometry"]["groups"] * len(results)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    ref = check.follow(snaps, results[0]["p0"], config, groups, check.stated_precision(config), dev)
    return check.compare(snaps, ref, results[0]["p0"], config)


def result(bench: dict, cell: dict, results: List[dict], trace: bool) -> Tuple[dict, List[str]]:
    """(the result line's object, the check lines for standard error)."""
    name = cell["workload"]["name"]
    ctx = context(cell, results)
    print(f"benchmark: {len(ctx['walls'])} iterations in {ctx['window_s']:.3f} s of window; set-up "
          f"{ctx['setup_s']:.3f} s; iteration ms min {min(ctx['walls']) * 1e3:.3f} median "
          f"{statistics.median(ctx['walls']) * 1e3:.3f} max {max(ctx['walls']) * 1e3:.3f} "
          f"(each iteration's slowest of {len(results)} rank(s))", flush=True)
    print(f"benchmark: {split(ctx['iterations'])}", flush=True)
    metrics = {}
    if trace:
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(ctx)
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(results),
              "memory_peak_bytes": max(r["peak"] for r in results)}
    line = {"correct": False, "attempted": len(ctx["walls"]), "failed": sum(r["bad"] for r in results),
            "metrics": metrics, "device": device}
    if trace:
        tr = ctx["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    numbers = correctness(cell, results)
    limits = cell["limits"]["limits"]
    line["correct"] = bool(check.verdict(numbers, limits) and line["failed"] == 0 and line["attempted"] > 0)
    line["checks"] = {k: {"value": numbers[k]["value"], "limit": limits[k]} for k in check.NUMBERS}
    return line, check.lines(numbers, limits)
