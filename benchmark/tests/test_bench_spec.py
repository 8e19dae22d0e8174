"""The benchmark finds its cells, configurations, traffic mixes, limits,
work counts and metric readers by name, and BENCHMARK.json keeps to the
form every run of the benchmark reads."""

import json
import re
import shutil

import pytest

from benchmark import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["ranks"] == w["chips"]
        assert set(cell["limits"]["limits"]) == set(check.NUMBERS)
        assert cell["work"]["k1_ops_per_env_step"] > 0


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_json_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in bench["end_to_end"] + bench["per_layer"]}) == len(
        bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        reported = [m["name"] for m in spec.end_to_end(bench, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(bench, w["name"])


def test_a_cell_added_by_files_alone_is_found_and_run(tmp_path, bench, monkeypatch):
    """A new traffic mix, a new limits file and a new workload entry: the
    cell resolves, its per-layer metrics are listed, and a run goes through
    it (on the CPU, stood in)."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.CHECKOUT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": "gr1t1.plane_small", "config": "gr1t1", "traffic": "plane_small", "chips": 1,
         "why": "a mix added as data files"}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    traffic = json.loads((root / "benchmark/traffic/plane.json").read_text())
    traffic["envs_per_rank"] = 32
    (root / "benchmark/traffic/plane_small.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/gr1t1.plane.json", root / "benchmark/limits/gr1t1.plane_small.json")

    cell = spec.cell("gr1t1.plane_small", root=root)
    assert cell["traffic"]["envs_per_rank"] == 32
    assert {m["name"] for m in spec.per_layer(new, "gr1t1.plane_small")} >= {"k1_roofline", "iter_mfu"}
    assert spec.reader("iter_mfu", root=root)

    from benchmark.tests import standin

    monkeypatch.setattr(spec, "CHECKOUT", root)
    monkeypatch.setattr(spec, "BENCHMARK_JSON", root / "BENCHMARK.json")
    small = standin.tiny_cell("gr1t1.plane_small", envs_per_rank=32)
    standin.stand_in(monkeypatch, small)
    line, checks = standin.run_cell(small, seed=3, seconds=0.1)
    assert line["attempted"] >= 1 and set(line["metrics"]) == {"train_env_steps_per_s", "iter_ms_p90", "setup_s"}
    assert list(line)[-1] == "checks"
