"""Run a trained policy (port of ``wiki_grx_gym_tpu/scripts/play.py``).

Applies the same eval overrides (<= 50 envs, no noise, no domain
randomization, no pushes), builds the env and runner on the requested
device (default ``cuda``), loads the latest ``model_<it>.pt`` of the
experiment's runs (or the one ``--load_run``/``--checkpoint`` name) through
``get_load_path`` and ``runner.load``, exports the actor to
``<log root>/exported/policies/policy.npz`` (``utils/helpers.py:export_policy_npz``)
and ``policy.grxpolicy`` (the native runtime's format,
``deploy/runtime.py:export_policy_bin``), and rolls the deterministic
policy through :func:`play_loop`, which logs the tracking channels of one
robot into an ``EvalLogger``. Then it prints the logger's rewards and
writes its dashboard to ``<log root>/eval_plots.png`` (where matplotlib is
installed; otherwise it says on one line that no dashboard was written).
``--record`` writes the robot's trajectory to ``<log root>/traj.npz``
(``base_pos`` (T, 3), ``base_quat`` (T, 4), ``q`` (T, D) float32, ``dt``
float32 and ``task``), which ``tools/visualize.py --replay`` animates.
``--policy <npz>`` plays a ``policy.npz`` instead of a checkpoint (and
exports nothing).

A recurrent task (``GR1T1_lstm``) plays its stateful policy: the LSTM memory
is carried from step to step and, as in the JAX package and the reference's
``PolicyExporterLSTM``, not zeroed when an env resets. Its exports hold the
LSTM layers too.

    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1 [--load_run R] [--checkpoint C] [--record]
    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1 --policy policy.npz
    python -m wiki_grx_gym_tpu_torch.scripts.play --task GR1T1_lstm
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.convert import load_actor_npz
from wiki_grx_gym_tpu_torch.deploy.runtime import export_policy_bin
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
from wiki_grx_gym_tpu_torch.utils.helpers import export_policy_npz, get_args, set_seed
from wiki_grx_gym_tpu_torch.utils.logger import EvalLogger
from wiki_grx_gym_tpu_torch.utils.task_registry import ROOT_DIR, get_load_path, update_cfg_from_args

# the channels play_loop logs a step, in the order of its host row
_SCALARS = ("dof_pos_target", "dof_pos", "dof_vel", "dof_torque", "command_x", "command_y",
            "command_yaw", "base_vel_x", "base_vel_y", "base_vel_z", "base_vel_yaw")


def no_randomization(env_cfg):
    """Observation noise, domain randomization and pushes off (play's eval
    overrides, shared with the tools)."""
    env_cfg.noise.add_noise = False
    dr = env_cfg.domain_rand
    dr.randomize_friction = dr.randomize_restitution = False
    dr.randomize_base_mass = dr.randomize_base_com = False
    dr.randomize_motor_strength = dr.push_robots = False
    dr.randomize_init_dof_pos = dr.randomize_init_base_velocity = False
    return env_cfg


def play_loop(env, policy, env_state, obs, steps: int, record: bool = False):
    """Step ``policy`` in ``env`` for ``steps`` policy steps from
    (``env_state``, ``obs``), logging one robot (``viewer.ref_env``) and one
    joint (the first knee, else joint 1) as JAX's play does. The env steps
    through ``env.step_graph`` (a CUDA graph replay on the card, as JAX's
    play steps through ``step_jit``). Each step's logged values leave the
    device in one copy. Returns (the
    :class:`EvalLogger`, the trajectory: ``{"base_pos", "base_quat", "q"}``
    stacked float32 arrays with ``record``, else None)."""
    r = min(int(getattr(env.cfg.viewer, "ref_env", 0)), env.num_envs - 1)
    knees = [i for i, nm in enumerate(env.model.dof_names) if "knee" in nm]
    j = knees[0] if knees else min(1, env.num_dof - 1)
    scale = env.cfg.control.action_scale
    logger = EvalLogger(env.dt)
    traj = {"base_pos": [], "base_quat": [], "q": []}
    for _ in range(steps):
        actions = policy(obs)
        env_state, out = env.step_graph(env_state, actions)
        obs = out.obs
        ph = env_state.physics
        lin, ang = out.extras["base_lin_vel"][r], out.extras["base_ang_vel"][r]
        parts = [actions[r, j:j + 1], ph.q[r, j:j + 1], ph.qd[r, j:j + 1], env_state.torques[r, j:j + 1],
                 env_state.commands[r, :3], lin, ang[2:3], out.extras["feet_contact_force"][r, :, 2],
                 out.rew[r:r + 1], out.reset.sum().reshape(1)]
        if record:
            parts += [ph.base_pos[r], ph.base_quat[r], ph.q[r]]
        row = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        vals = row[: len(_SCALARS)].tolist()
        vals[0] *= scale
        nf = out.extras["feet_contact_force"].shape[1]
        at = len(_SCALARS)
        logger.log_states({**dict(zip(_SCALARS, vals)),
                           "contact_forces_z": row[at: at + nf].astype(np.float32)})
        rew, resets = row[at + nf], row[at + nf + 1]
        logger.log_rewards({"rew_total": float(rew)}, int(resets))
        if record:
            at += nf + 2
            for key, width in (("base_pos", 3), ("base_quat", 4), ("q", env.num_dof)):
                traj[key].append(row[at: at + width].astype(np.float32))
                at += width
    return logger, ({k: np.stack(v) for k, v in traj.items()} if record else None)


def play(args, num_steps: int = None, device=None, log_root="default"):
    """Returns the :class:`EvalLogger` of the run. ``log_root``: the
    directory of the experiment's runs (``logs/<experiment_name>`` under
    the checkout by default); the dashboard, ``traj.npz`` and the exports
    go there."""
    num_steps = int(num_steps if num_steps is not None else getattr(args, "steps", 500))
    device = device or getattr(args, "device", "cuda")
    env_cfg, train_cfg = task_registry.get_cfgs(args.task)

    # eval overrides
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, 50)
    env_cfg.terrain.num_rows = 5
    env_cfg.terrain.num_cols = 5
    env_cfg.terrain.curriculum = False
    no_randomization(env_cfg)

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
        export_policy_bin(runner.net, os.path.join(export_dir, "policy.grxpolicy"))
        print(f"Exported policy to {export_dir}/policy.npz and .grxpolicy")
    policy = runner.get_inference_policy()

    record = bool(getattr(args, "record", False))
    logger, traj = play_loop(env, policy, state.env_state, state.obs, num_steps, record=record)
    logger.print_rewards()
    os.makedirs(log_root, exist_ok=True)
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no eval dashboard is written")
    else:
        logger.save_plots(os.path.join(log_root, "eval_plots.png"))
    if record:
        traj_path = os.path.join(log_root, "traj.npz")
        np.savez(traj_path, **traj, dt=np.float32(env.dt), task=np.str_(args.task))
        print(f"Recorded {num_steps}-step trajectory to {traj_path}")
    return logger


if __name__ == "__main__":
    play(get_args())
