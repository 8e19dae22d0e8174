"""The port's ``learn(profile_dir=)`` and ``tools/eval_tracking.py`` on the CPU.

- ``OnPolicyRunner.learn(5, profile_dir=...)`` at 4 envs (one policy step
  an iteration, one substep a step: the CPU's trace of the plain lane
  program holds every small op) writes one Chrome trace, and it covers
  iterations 2, 3 and 4 (the ranges ``OnPolicyRunner.iteration <it>``)
  and no others, as JAX's ``learn/runner.py:312-346`` traces them.
- ``eval_tracking.evaluate`` at 4 envs with a short transient and window,
  on a saved port checkpoint, returns the six commands' rows. Through an
  env that records each step, the pinned command holds at every step, and
  each row's ``measured`` (mean over the window and the envs, float64) and
  ``survival`` (share of envs that never reset) equal a numpy
  recomputation from the per-step extras (rtol 1e-12: only the order of a
  float64 sum differs; survival exactly).
"""

import json
import os

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.tools import eval_tracking

N, TRANSIENT, WINDOW = 4, 1, 2


def short_train_cfg():
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    train_cfg.runner.num_steps_per_env = 1
    train_cfg.algorithm.num_learning_epochs = 1
    train_cfg.algorithm.num_mini_batches = 1
    return train_cfg


def test_learn_traces_iterations_2_to_4(tmp_path):
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    cfg.control.decimation = 1   # a tenth of the plain lane program's ops: a ~30 MiB trace
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=short_train_cfg(), log_root=None)
    runner.learn(5, profile_dir=str(tmp_path / "trace"))
    assert runner.current_learning_iteration == 5
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    its = sorted(int(e["name"].rsplit(" ", 1)[1]) for e in events
                 if str(e.get("name", "")).startswith("OnPolicyRunner.iteration "))
    assert its == [2, 3, 4]
    assert any("aten::" in str(e.get("name", "")) for e in events)   # the ops inside them


class Recorder:
    """The env, recording each step of each command (a segment opens at
    every ``reset``): the commands the step was given, the velocity extras
    and the resets."""

    def __init__(self, env):
        self._env, self.segments = env, []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, state):
        self.segments.append([])
        return self._env.reset(state)

    def step(self, state, actions):
        new, out = self._env.step(state, actions)
        if self.segments:
            self.segments[-1].append({
                "cmd_in": state.commands.numpy().copy(), "cmd_out": new.commands.numpy().copy(),
                "lin": out.extras["base_lin_vel"].numpy().copy(),
                "ang": out.extras["base_ang_vel"].numpy().copy(), "reset": out.reset.numpy().copy()})
        return new, out

    # eval_tracking steps through step_graph, which on the CPU is the eager step
    step_graph = step


@pytest.fixture(scope="module")
def checkpoint_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("logs"))
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=root)
    os.makedirs(runner.log_dir)
    runner.save(os.path.join(runner.log_dir, "model_0.pt"), runner.init_state())
    return root


def test_eval_tracking_rows_match_a_recomputation(checkpoint_root, monkeypatch):
    made = []
    make_env = task_registry.make_env

    def recording_make_env(*a, **k):
        env, cfg = make_env(*a, **k)
        made.append(Recorder(env))
        return made[-1], cfg

    monkeypatch.setattr(eval_tracking.task_registry, "make_env", recording_make_env)
    rows = eval_tracking.evaluate("GR1T1", num_envs=N, transient=TRANSIENT, window=WINDOW,
                                  log_root=checkpoint_root, device="cpu")
    assert [r[0] for r in rows] == [c[0] for c in eval_tracking.COMMANDS]
    (env,) = made
    assert env.cfg.commands.resampling_command_interval_s == 1.0e6 and not env.cfg.noise.add_noise
    assert len(env.segments) == 6
    for (label, vx, vy, wz, idx), row, seg in zip(eval_tracking.COMMANDS, rows, env.segments):
        assert len(seg) == TRANSIENT + WINDOW, label
        cmd = np.array([vx, vy, wz], np.float32)
        for s in seg:
            assert (s["cmd_in"][:, :3] == cmd).all(), label   # pinned before every step
            live = ~s["reset"]
            assert (s["cmd_out"][live, :3] == cmd).all(), label   # never resampled
        v = np.stack([np.concatenate([s["lin"][:, :2], s["ang"][:, 2:3]], axis=1)[:, idx]
                      for s in seg[TRANSIENT:]]).astype(np.float64)
        survival = float(np.mean(~np.any(np.stack([s["reset"] for s in seg]), axis=0)))
        _, target, measured, tracking, surv = row
        assert target == (vx, vy, wz)[idx]
        np.testing.assert_allclose(measured, v.mean(), rtol=1e-12, atol=1e-15, err_msg=label)
        assert surv == survival and 0.0 <= surv <= 1.0
        if abs(target) > 1e-6:
            assert tracking == pytest.approx(measured / target * 100.0)
        else:
            assert np.isnan(tracking)
        assert np.isfinite([measured, surv]).all()


def test_eval_tracking_resets_a_stateful_policy():
    """``track`` calls ``policy.reset()`` before each command (the recurrent
    policy's memory), and steps ``transient + window`` times a command."""
    cfg, _ = eval_tracking.evaluation_config("GR1T1", N)
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    calls = {"reset": 0, "act": 0}

    def policy(obs):
        calls["act"] += 1
        return torch.zeros((obs.shape[0], env.num_actions))

    policy.reset = lambda: calls.__setitem__("reset", calls["reset"] + 1)
    state = env.init_state(env.make_generator(0))
    rows = eval_tracking.track(env, policy, state, 0, 1)
    assert calls == {"reset": 6, "act": 6} and len(rows) == 6
