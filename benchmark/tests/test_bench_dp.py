"""The cell across ranks on the CPU: two gloo ranks stand in for the
cards (the compiled iteration stood in by the eager one), rank 0 joins
every rank's batch for the reference; the gradient exchange left out reads
``correct`` false."""

import json

import pytest
import torch.multiprocessing as mp

from benchmark.tests import standin


def _no_exchange(patch):
    from wiki_grx_gym_tpu_torch.learn.ppo import PPO

    patch.setattr(PPO, "reduce", lambda self, loss, g, aux: (loss, g, aux))


def _run(tmp_path, fault):
    cell = standin.tiny_cell("gr1t1.plane")
    world = 2
    cell["traffic"]["ranks"] = world
    cell["workload"] = dict(cell["workload"], chips=world)
    out = tmp_path / "line.json"
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path / 'rdv'}"
    procs = [ctx.Process(target=standin.dp_rank, args=(r, world, init, cell, 7, fault, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert codes == [0] * world, codes
    return json.loads(out.read_text())


@pytest.mark.parametrize("fault", [None, _no_exchange], ids=["sound", "exchange_left_out"])
def test_across_ranks(tmp_path, fault):
    line = _run(tmp_path, fault)
    assert line["device"]["count"] == 2 and line["attempted"] >= 1
    checks = {k: v["value"] for k, v in line["checks"].items()}
    if fault is None:
        assert checks["ac_gap"] < 1e-4 and checks["gae_gap"] < 1e-4, checks
    else:
        assert line["correct"] is False, checks
