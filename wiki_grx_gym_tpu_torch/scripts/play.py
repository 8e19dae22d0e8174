"""Run a trained policy (port of ``wiki_grx_gym_tpu/scripts/play.py``).

Applies the same eval overrides (<= 50 envs, no noise, no domain
randomization, no pushes), builds the env and runner on the requested
device (default ``cuda``), loads the latest ``model_<it>.pt`` of the
experiment's runs (or the one ``--load_run``/``--checkpoint`` name) through
``get_load_path`` and ``runner.load``, exports the actor to
``<log root>/exported/policies/policy.npz`` in the deploy format
(``utils/helpers.py:export_policy_npz``) and rolls the deterministic policy,
logging the tracking channels of one robot. ``--policy <npz>`` plays a
``policy.npz`` instead of a checkpoint (and exports nothing).

A recurrent task (``GR1T1_lstm``) plays its stateful policy: the LSTM memory
is carried from step to step and, as in the JAX package and the reference's
``PolicyExporterLSTM``, not zeroed when an env resets. Its ``policy.npz``
holds the LSTM layers too (``lstm{i}_w_ih`` ...), which ``--policy`` loads
back.

    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1 [--load_run R] [--checkpoint C]
    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1 --policy policy.npz
    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1_lstm
"""

from __future__ import annotations

import os

import torch

from wiki_grx_gym_tpu_torch.convert import load_actor_npz
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
from wiki_grx_gym_tpu_torch.utils.helpers import export_policy_npz, get_args, set_seed
from wiki_grx_gym_tpu_torch.utils.task_registry import ROOT_DIR, get_load_path, update_cfg_from_args


def play(args, num_steps: int = None, device=None, log_root="default"):
    """Returns a dict of per-step logged channels (lists of floats) and the
    per-step total reward of the logged robot. ``log_root``: the directory
    of the experiment's runs (``logs/<experiment_name>`` under the checkout
    by default)."""
    num_steps = int(num_steps if num_steps is not None else getattr(args, "steps", 500))
    device = device or getattr(args, "device", "cuda")
    env_cfg, train_cfg = task_registry.get_cfgs(args.task)

    # eval overrides
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, 50)
    env_cfg.terrain.num_rows = 5
    env_cfg.terrain.num_cols = 5
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    dr = env_cfg.domain_rand
    dr.randomize_friction = dr.randomize_restitution = False
    dr.randomize_base_mass = dr.randomize_base_com = False
    dr.randomize_motor_strength = dr.push_robots = False
    dr.randomize_init_dof_pos = dr.randomize_init_base_velocity = False

    train_cfg.seed = set_seed(args.seed if args.seed is not None else train_cfg.seed)
    env, env_cfg = task_registry.make_env(args.task, args=args, env_cfg=env_cfg, device=device)
    update_cfg_from_args(None, train_cfg, args)
    runner = OnPolicyRunner(env, train_cfg, device=device)
    if log_root == "default":
        log_root = os.path.join(ROOT_DIR, "logs", train_cfg.runner.experiment_name)

    if getattr(args, "policy", None):
        print(f"Loading policy from: {args.policy}")
        load_actor_npz(runner.net, args.policy)
        state = runner.init_state()
    else:
        path = get_load_path(log_root, train_cfg.runner.load_run, train_cfg.runner.checkpoint)
        print(f"Loading policy from: {path}")
        state = runner.load(path)
        export_dir = os.path.join(log_root, "exported", "policies")
        os.makedirs(export_dir, exist_ok=True)
        export_policy_npz(runner.net, os.path.join(export_dir, "policy.npz"))
        print(f"Exported policy to {export_dir}/policy.npz")
    policy = runner.get_inference_policy()

    env_state, obs = state.env_state, state.obs
    robot_index = min(int(getattr(env.cfg.viewer, "ref_env", 0)), env.num_envs - 1)
    knees = [i for i, nm in enumerate(env.model.dof_names) if "knee" in nm]
    joint_index = knees[0] if knees else min(1, env.num_dof - 1)

    log = {k: [] for k in (
        "dof_pos_target", "dof_pos", "dof_vel", "dof_torque", "command_x", "command_y",
        "command_yaw", "base_vel_x", "base_vel_y", "base_vel_z", "base_vel_yaw", "rew_total",
    )}
    dones = 0
    for _ in range(num_steps):
        actions = policy(obs)
        env_state, out = env.step(env_state, actions)
        obs = out.obs
        r, j = robot_index, joint_index
        row = torch.stack([
            actions[r, j] * env.cfg.control.action_scale,
            env_state.physics.q[r, j], env_state.physics.qd[r, j], env_state.torques[r, j],
            env_state.commands[r, 0], env_state.commands[r, 1], env_state.commands[r, 2],
            out.extras["base_lin_vel"][r, 0], out.extras["base_lin_vel"][r, 1],
            out.extras["base_lin_vel"][r, 2], out.extras["base_ang_vel"][r, 2], out.rew[r],
        ]).tolist()
        for k, v in zip(log, row):
            log[k].append(v)
        dones += int(out.reset.sum())
    n = max(len(log["rew_total"]), 1)
    print(f"{num_steps} steps on {env.device}: mean reward {sum(log['rew_total']) / n:.4f}, "
          f"resets {dones}")
    log["dones"] = dones
    return log


if __name__ == "__main__":
    play(get_args())
