"""The benchmark on the CPU, for its own tests: a cell cut to a tiny size
(the program's configuration cut alike), and the eager iteration standing
in for the compiled one, which needs a card."""

from __future__ import annotations

import copy

import torch

from benchmark import program, report, session, spec

TINY = {"envs_per_rank": 16, "num_steps_per_env": 4, "num_mini_batches": 2, "num_learning_epochs": 2,
        "decimation": 2}


def tiny_cell(name: str, **cut) -> dict:
    """Cell ``name`` with the sizes of ``TINY`` (or ``cut``)."""
    size = dict(TINY, **cut)
    cell = copy.deepcopy(spec.cell(name))
    cell["traffic"]["envs_per_rank"] = size["envs_per_rank"]
    cell["config"]["runner"]["num_steps_per_env"] = size["num_steps_per_env"]
    cell["config"]["algorithm"]["num_mini_batches"] = size["num_mini_batches"]
    cell["config"]["algorithm"]["num_learning_epochs"] = size["num_learning_epochs"]
    cell["config"]["env"]["decimation"] = size["decimation"]
    cell["config"]["env_cfg"]["control"]["decimation"] = size["decimation"]
    return cell


def stand_in(monkeypatch, cell: dict):
    """Cut the program's configuration to ``cell``'s sizes, and run the
    eager iteration (the same collection and update, through
    ``OnPolicyRunner.iteration`` with the same injected draws) where the
    benchmark calls the compiled one."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    config = cell["config"]
    get_cfgs = task_registry.get_cfgs

    def cut_cfgs(name):
        env_cfg, train_cfg = get_cfgs(name)
        train_cfg.runner.num_steps_per_env = config["runner"]["num_steps_per_env"]
        train_cfg.algorithm.num_mini_batches = config["algorithm"]["num_mini_batches"]
        train_cfg.algorithm.num_learning_epochs = config["algorithm"]["num_learning_epochs"]
        env_cfg.control.decimation = config["env"]["decimation"]
        return env_cfg, train_cfg

    def step(self, noise, u, perm):
        out = {}
        self.state, metrics = self.runner.iteration(self.state, noise=noise, u=u, perm=perm, out=out)
        self.last = out
        return metrics

    monkeypatch.setattr(task_registry, "get_cfgs", cut_cfgs)
    monkeypatch.setattr(program.Run, "step", step)
    monkeypatch.setattr(program.Run, "eager_reason", property(lambda self: None))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu (stood in)")


def run_cell(cell: dict, seed: int = 5, seconds: float = 0.5, trace: bool = False):
    """One run on the CPU: (the result line, the check lines)."""
    import time

    out = session.run_rank(0, 1, cell, seed, seconds, trace, time.perf_counter(), device=torch.device("cpu"))
    return report.result(spec.load_benchmark(), cell, [out], trace)


class _Patch:
    """A monkeypatch for a spawned rank (no pytest fixture there)."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def dp_rank(rank: int, world: int, init_method: str, cell: dict, seed: int, fault, out_path: str):
    """One rank of a run across ``world`` gloo ranks on the CPU, stood in
    as :func:`stand_in`; ``fault(patch)`` (or None) plants a fault first.
    Rank 0 writes the result line to ``out_path``."""
    import json
    import time

    from benchmark import run as run_mod
    from wiki_grx_gym_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    patch = _Patch()
    stand_in(patch, cell)
    patch.setattr(program, "init_group", lambda r, w, m: mesh.init_distributed(
        init_method=m, world_size=w, rank=r, device="cpu"))
    if fault is not None:
        fault(patch)
    out = session.run_rank(rank, world, cell, seed, 0.1, False, time.perf_counter(), init_method,
                           device=torch.device("cpu"))
    results = run_mod._gather(out, rank, world)
    if rank == 0:
        line, _ = report.result(spec.load_benchmark(), cell, results, False)
        with open(out_path, "w") as f:
            json.dump(line, f)
