"""The port's bench (``wiki_grx_gym_tpu_torch/scripts/bench.py``) on the CPU:
its FLOP count equals the root ``bench.py``'s on the same env and runner,
one cell runs end to end on the plain versions, its JSON line has the keys
of the JAX bench's line (``BENCH_r05.json``'s ``parsed``, the MFU key named
for the H100), and ``main`` picks the root bench's cells and never falls
back to the CPU without a card.

The root ``bench.py`` is imported inside a fixture, which restores JAX's
compilation-cache settings that importing it changes, so that no other
test of the worker sees them."""

import importlib
import json
import math
from pathlib import Path

import jax
import pytest
import torch

from wiki_grx_gym_tpu_torch.scripts import bench

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def root_bench():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield importlib.import_module("bench")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def short_run(cfg):
    """Two env steps an iteration, 4 minibatches of 2 epochs: a CPU-sized cell."""
    cfg.runner.num_steps_per_env = 2
    cfg.algorithm.num_mini_batches = 4
    cfg.algorithm.num_learning_epochs = 2


def two_substeps(cfg):
    cfg.control.decimation = 2


@pytest.fixture(scope="module")
def cpu_cell():
    return bench.bench_config(8, 1, device="cpu", train_hook=short_run, env_hook=two_substeps)


@pytest.mark.parametrize("task", ["GR1T1", "GR1T1_full", "GR1T1_lstm"])
def test_flops_equal_the_root_bench(root_bench, task):
    env, runner, _ = bench.build_run(4, device="cpu", task=task)
    got = bench.flops_per_iteration(env, runner)
    assert got == root_bench.flops_per_iteration(env, runner)
    assert got > runner.num_steps_per_env * 4 * env.decimation * 10_000   # physics + the nets


def test_subset_is_the_root_bench_config():
    from wiki_grx_gym_tpu_torch.envs import task_registry

    cfg, _ = task_registry.get_cfgs("GR1T1")
    bench.ref_equiv_subset(cfg)
    assert cfg.sim.contact_tangent_stiffness == 0.0 and cfg.asset.self_collisions == -1
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    assert env.contact_params.tangent_stiffness == 0.0 and env.self_pairs == ((), ())


def test_cpu_cell_is_finite_and_not_the_kernel(cpu_cell):
    r = cpu_cell
    assert r["pallas"] is False
    assert r["path"].startswith("eager (device cpu") and r["graphs"] == []
    assert len(r["iter_ms_each"]) == 1 and math.isclose(r["iter_ms"], r["iter_ms_each"][0])
    # the root bench.py's calls: one warm-up iteration, two warm-up rollouts
    # and max(iters // 2, 5) timed ones
    assert r["calls"] == {"iterations": 2, "rollouts": 7}
    for key in ("fps", "iter_ms", "collection_ms", "learn_ms", "flops_per_iter"):
        assert math.isfinite(r[key]) and r[key] >= 0.0, key
    assert r["mfu_vs_bf16_peak"] is None   # a CPU run gives no share of the card's peak
    assert r["fps"] > 0 and r["collection_ms"] > 0
    assert math.isclose(r["fps"], 2 * 8 / (r["iter_ms"] * 1e-3))


def test_json_line_has_the_root_bench_keys(cpu_cell):
    want = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    got = json.loads(json.dumps(bench.result_line({"main": cpu_cell}, 8, 1, "cpu")))
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert got["config"]["platform"] == "cpu"
    rename = lambda k: "mfu_vs_h100_bf16_peak" if k == "mfu_vs_v5e_bf16_peak" else k
    assert set(got["breakdown"]["main"]) == {rename(k) for k in want["breakdown"]["main"]}
    assert got["value"] == got["breakdown"]["main"]["env_steps_per_s"]
    assert got["breakdown"]["main"]["pallas_kernel"] is False
    assert got["breakdown"]["main"]["mfu_vs_h100_bf16_peak"] is None


def test_main_without_a_card_exits_and_runs_nothing(monkeypatch, capsys):
    called = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "bench_config", lambda *a, **k: called.append(k))
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
    assert called == [] and capsys.readouterr().out == ""


def fake_cell(num_envs, iters, device, **kw):
    graphs = [{"name": "collection (draw)", "capture_ms": 1.0, "instantiate_ms": 2.0}] if device == "cuda" else []
    return {"fps": 1.0 * num_envs, "iter_ms": 1.0, "iter_ms_each": [1.0] * iters, "pallas": device == "cuda",
            "collection_ms": 0.5, "learn_ms": 0.5, "flops_per_iter": 7, "mfu_vs_bf16_peak": 0.0,
            "path": "graphed" if device == "cuda" else "eager (device cpu)", "graphs": graphs}


@pytest.mark.parametrize("argv, want", [
    (["--device", "cpu"], {"main": (256, 3, {})}),
    (["--device", "cpu", "--full"], {"main": (256, 3, {})}),
    ([], {"main": (4096, 30, {}), "envs8192": (8192, 15, {})}),
    (["--full"], {"main": (4096, 30, {}), "envs8192": (8192, 15, {}),
                  "ref_equiv_subset": (4096, 15, {"subset": True}),
                  "heightfield": (4096, 15, {"mesh_type": "heightfield"}),
                  "trimesh": (4096, 15, {"mesh_type": "trimesh"}),
                  "full_body": (4096, 15, {"task": "GR1T1_full"}),
                  "lstm": (4096, 15, {"task": "GR1T1_lstm"})}),
])
def test_main_runs_the_root_bench_cells(monkeypatch, capsys, argv, want):
    """The cells, sizes and iteration counts of the root bench.py:147-172,
    with the cells' work replaced by a stand-in (the card is faked)."""
    calls = []

    def record(num_envs, iters, device, **kw):
        calls.append((num_envs, iters, device, kw))
        return fake_cell(num_envs, iters, device)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(bench, "bench_config", record)
    assert bench.main(argv) == 0
    device = "cpu" if "cpu" in argv else "cuda"
    assert calls == [(n, it, device, kw) for n, it, kw in want.values()]
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("bench: device ")
    assert len(lines) == len(want) + 2   # the device, one line a cell, the JSON line
    for line in lines[1:-1]:   # each cell's path and graphs
        path = "graphed; collection (draw) captured in 1.0 ms" if device == "cuda" else "eager (device cpu)"
        assert path in line, line
    line = json.loads(lines[-1])
    assert list(line["breakdown"]) == list(want)
    assert line["config"] == {"num_envs": want["main"][0], "num_steps_per_env": 64, "platform": device,
                              "physics_substeps_per_env_step": 10,
                              "contact_fidelity": "full (self-collision + stick friction)",
                              "iters_timed": want["main"][1]}


def test_time_run_takes_the_compiled_iteration_where_the_rule_graphs(monkeypatch):
    """Where ``eager_reason`` is None, ``time_run`` times ``_train_iter`` and
    ``_rollout_graph`` (the root bench's ``_train_iter`` and ``rollout_jit``),
    never the eager ``iteration`` and ``rollout``; here the compiled calls are
    stood in by recorders around the eager ones (no card)."""
    env, runner, state = bench.build_run(8, device="cpu", train_hook=short_run, env_hook=two_substeps)
    calls, inside = [], [False]
    eager_iteration, eager_rollout = runner.iteration, runner.rollout

    class Compiled:
        @staticmethod
        def reports():
            return [{"name": "collection (draw)", "capture_ms": 1.0, "instantiate_ms": 2.0}]

    def stand_in(name, fn):
        def call(s):
            calls.append(name)
            inside[0] = True
            try:
                return fn(s)
            finally:
                inside[0] = False
        return call

    def only_inside(fn):
        return lambda *a, **k: fn(*a, **k) if inside[0] else pytest.fail("the eager path was timed")

    monkeypatch.setattr(type(runner), "eager_reason", property(lambda self: None))
    runner._train_iter = stand_in("_train_iter", eager_iteration)
    runner._rollout_graph = stand_in("_rollout_graph", eager_rollout)
    runner.compiled = Compiled()
    runner.iteration, runner.rollout = only_inside(eager_iteration), only_inside(eager_rollout)
    r, _ = bench.time_run(env, runner, state, 1, device="cpu")
    assert calls == ["_train_iter"] * 2 + ["_rollout_graph"] * 7
    assert r["path"] == "graphed" and r["graphs"][0]["name"] == "collection (draw)"
