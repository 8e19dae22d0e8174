"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a training cell can have; and the control (the
reference one precision below the stated one, in the program's place)
fails the cell's limits. On the CPU at a tiny size, the compiled iteration
stood in by the eager one (``standin``); the harness's look for a card is
skipped, the rest of a run is the benchmark's own."""

import pytest
import torch

from benchmark import check
from benchmark.tests import standin

SEEDS = (3, 2 ** 31 + 17)


@pytest.fixture
def plane(monkeypatch):
    cell = standin.tiny_cell("gr1t1.plane")
    standin.stand_in(monkeypatch, cell)
    return cell


def _unchanged(monkeypatch):
    from benchmark import program

    step = program.Run.step

    def kept(self, noise, u, perm):
        before = {k: v.clone() for k, v in self.ppo().items()}
        metrics = step(self, noise, u, perm)
        for k, v in self.ppo().items():
            v.copy_(before[k])
        return metrics

    monkeypatch.setattr(program.Run, "step", kept)


def _half_batch(monkeypatch):
    from wiki_grx_gym_tpu_torch.learn.ppo import PPO

    prepare = PPO.prepare_update

    def half(self, *a, **k):
        w, f, rows = prepare(self, *a, **k)
        return w[:, :rows // 2].contiguous(), f[:, :rows // 2].contiguous(), rows // 2

    monkeypatch.setattr(PPO, "prepare_update", half)


def _altered_action(monkeypatch):
    from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic

    act = ActorCritic.act

    def altered(self, obs, noise, *a, **k):
        actions, logp, mean, std = act(self, obs, noise, *a, **k)
        actions = actions.clone()
        actions[0, 0] += 1.0
        return actions, logp, mean, std

    monkeypatch.setattr(ActorCritic, "act", altered)


def _friction(monkeypatch):
    """K1's plain program (the env's physics on the CPU) with the friction
    coefficient x1.05."""
    from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarDecimation

    run = ScalarDecimation.run

    def rubbed(self, state, *a, **k):
        return run(self, dict(state, friction=state["friction"] * 1.05), *a, **k)

    monkeypatch.setattr(ScalarDecimation, "run", rubbed)


def _substep_less(monkeypatch):
    """The decimation loop one substep short."""
    from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarDecimation

    run = ScalarDecimation.run

    def short(self, *a, **k):
        self.decimation -= 1
        try:
            return run(self, *a, **k)
        finally:
            self.decimation += 1

    monkeypatch.setattr(ScalarDecimation, "run", short)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_action, _friction, _substep_less],
                         ids=["state_unchanged", "half_batch", "altered_action", "friction", "substep_less"])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_fault_reads_not_correct(plane, monkeypatch, fault, seed):
    fault(monkeypatch)
    line, checks = standin.run_cell(plane, seed=seed, seconds=0.1)
    assert line["correct"] is False, checks
    assert list(line)[-1] == "checks" and checks[-1].startswith("check updates held")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_limits(plane, seed):
    from benchmark import session

    dev = torch.device("cpu")
    config = plane["config"]
    run, p0, _, snaps, _, _ = session.set_up(0, 1, plane, seed, dev)
    groups = run.geometry()["groups"]
    ref = check.follow(snaps, p0, config, groups, check.stated_precision(config), dev)
    low = check.follow(snaps, p0, config, groups, check.control_precision(config), dev)
    numbers = check.compare(low, ref, p0, config)
    assert not check.verdict(numbers, plane["limits"]["limits"]), check.lines(numbers, plane["limits"]["limits"])
