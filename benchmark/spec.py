"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells (``workloads``),
their configurations and the metrics. A cell's configuration file is the
``file`` of its ``configs`` entry, its traffic mix
``benchmark/traffic/<traffic>.json``, its correctness limits
``benchmark/limits/<cell>.json``, the work counts of its K1 program the
configuration's ``k1`` entry of that program, and each per-layer metric's reader
``benchmark/metrics/<metric>.py`` (a module with ``read(ctx)``). A cell, a
configuration, a traffic mix or a metric is added by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BENCHMARK_JSON = CHECKOUT / "BENCHMARK.json"


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or BENCHMARK_JSON) as f:
        return json.load(f)


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Optional[dict] = None, root: Optional[Path] = None) -> dict:
    """The cell ``name`` with its files read: ``workload`` (the entry of
    ``workloads``), ``config``, ``traffic``, ``limits`` and ``work``."""
    root = root or CHECKOUT
    bench = bench if bench is not None else load_benchmark(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _load_json(root / entry["file"], f"configuration {w['config']}")
    traffic = _load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json", f"traffic {w['traffic']}")
    limits = _load_json(root / "benchmark" / "limits" / f"{name}.json", f"limits of {name}")
    if traffic["k1_program"] not in config["k1"]:
        raise KeyError(f"configuration {w['config']} has no work counts of K1's {traffic['k1_program']} program")
    work = config["k1"][traffic["k1_program"]]
    if int(traffic["ranks"]) != int(w["chips"]):
        raise ValueError(f"{name}: traffic {w['traffic']} runs {traffic['ranks']} ranks, the cell asks for "
                         f"{w['chips']} chips")
    return {"workload": w, "config": config, "traffic": traffic, "limits": limits, "work": work}


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports (``--trace 0``)."""
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics the cell reports (``--trace 1``): those that
    list it, or that list no cells and move an end-to-end metric it reports."""
    reported = [m["name"] for m in end_to_end(bench, cell_name)]
    listed = lambda m: cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported
    return [m for m in bench["per_layer"] if listed(m)]


def reader(metric_name: str, root: Optional[Path] = None) -> Callable[[dict], Optional[float]]:
    """The ``read(ctx)`` of ``benchmark/metrics/<metric_name>.py``."""
    path = (root or CHECKOUT) / "benchmark" / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {metric_name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


