"""Command-tracking evaluation (port of ``tools/eval_tracking.py``).

Loads a trained checkpoint, turns off domain randomization, noise and
pushes, pins the commanded velocity for each of six commands, and measures
the mean base-frame velocity and the survival share over a window after a
settling transient. On the card every env step runs through K1, as a
replay of the env's step graph (``LeggedEnv.step_graph``).

    python -m wiki_grx_gym_tpu_torch.tools.eval_tracking --task GR1T1 [--load_run R] [--checkpoint N]
"""

from __future__ import annotations

import argparse
import os

import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
from wiki_grx_gym_tpu_torch.scripts.play import no_randomization
from wiki_grx_gym_tpu_torch.utils.task_registry import ROOT_DIR, get_load_path

COMMANDS = [
    # (label, vx, vy, wyaw, measured index into (vx, vy, wyaw))
    ("vx=+0.8", 0.8, 0.0, 0.0, 0),
    ("vx=+0.4", 0.4, 0.0, 0.0, 0),
    ("stand", 0.0, 0.0, 0.0, 0),
    ("vx=-0.4", -0.4, 0.0, 0.0, 0),
    ("vy=+0.3", 0.0, 0.3, 0.0, 1),
    ("wz=+0.8", 0.0, 0.0, 0.8, 2),
]


def evaluation_config(task: str, num_envs: int):
    """The task's configs with the evaluation's overrides: ``num_envs``
    envs, no randomization, commands never resampled, no heading
    command."""
    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    no_randomization(env_cfg)
    env_cfg.commands.resampling_command_interval_s = 1.0e6   # pin the commands
    env_cfg.commands.heading_command = False
    return env_cfg, train_cfg


@torch.no_grad()
def track(env, policy, env_state, transient: int, window: int):
    """Run the six pinned commands, each from ``env_state`` reset in every
    env (``env.reset``: one zero-action step) with a stateful policy reset,
    for ``transient + window`` steps (``env.step_graph``) with the command
    written into the state before each step. Returns ``[(label, target, measured, tracking
    %, survival)]``: measured is the mean over the window's steps and the
    envs of the commanded velocity's base-frame channel, survival the share
    of envs that did not reset in any step."""
    n = env.num_envs
    results = []
    for label, vx, vy, wz, idx in COMMANDS:
        if hasattr(policy, "reset"):
            policy.reset()
        state, out = env.reset(env_state)
        obs = out.obs
        cmd = torch.tensor([vx, vy, wz], dtype=state.commands.dtype, device=env.device).expand(n, 3)
        total = torch.zeros((), dtype=torch.float64, device=env.device)
        alive = torch.ones(n, dtype=torch.bool, device=env.device)
        for t in range(transient + window):
            state = state.replace(commands=cmd.clone())
            actions = policy(obs)
            state, out = env.step_graph(state, actions)
            obs = out.obs
            alive &= ~out.reset
            if t >= transient:
                v = torch.cat([out.extras["base_lin_vel"][:, :2], out.extras["base_ang_vel"][:, 2:3]], dim=1)
                total += v[:, idx].sum(dtype=torch.float64)
        measured = float(total) / (window * n)
        survival = float(alive.to(torch.float64).mean())
        target = (vx, vy, wz)[idx]
        tracking = measured / target * 100.0 if abs(target) > 1e-6 else float("nan")
        results.append((label, target, measured, tracking, survival))
        print(f"[eval] {label:10s} target={target:+.2f} measured={measured:+.3f} "
              f"tracking={tracking:5.1f}% survival={survival * 100:5.1f}%")
    return results


def evaluate(task: str, load_run=-1, checkpoint=-1, num_envs=64, transient=60, window=200,
             log_root=None, experiment_name=None, device="cuda"):
    """Load the checkpoint (``get_load_path`` under ``log_root``, by default
    ``logs/<experiment_name>``) into a runner on ``device`` and :func:`track`
    the six commands. Returns the rows of :func:`track`."""
    env_cfg, train_cfg = evaluation_config(task, num_envs)
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    runner = OnPolicyRunner(env, train_cfg, device=device)
    root = log_root or os.path.join(ROOT_DIR, "logs", experiment_name or train_cfg.runner.experiment_name)
    path = get_load_path(root, load_run=load_run, checkpoint=checkpoint)
    print(f"[eval] loading {path}")
    state = runner.load(path)
    return track(env, runner.get_inference_policy(), state.env_state, transient, window)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="GR1T1")
    ap.add_argument("--load_run", default=-1)
    ap.add_argument("--checkpoint", type=int, default=-1)
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--experiment_name", default=None,
                    help="log dir under logs/ (default: the task's experiment_name, as train.py uses)")
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain lane program")
    args = ap.parse_args()
    evaluate(args.task, args.load_run, args.checkpoint, args.num_envs,
             experiment_name=args.experiment_name, device=args.device)
