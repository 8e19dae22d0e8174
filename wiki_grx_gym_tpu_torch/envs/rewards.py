"""Reward library: every reward term of the FFTAI/GR1T1 stack as a plain
PyTorch function ``(env, ctx) -> (num_envs,)`` on ``(N, ...)`` tensors.

Port of ``wiki_grx_gym_tpu/envs/rewards.py``: the same 51 terms of
``REWARDS``, the same formulas in the same order. The env's post stage
outside K1 (``LeggedEnv.step`` on terrain and with heading commands) sums
the terms its config selects. Per-dof constants are read from the env's
device copies (``default_dof_pos_t``, ``dof_pos_soft_lower_t``,
``dof_pos_soft_upper_t``, ``dof_vel_limits_t``, ``torque_limits_t``).

Function semantics mirror, line for line in math:
- `legged_gym/envs/fftai/legged_robot_fftai.py:181-353`
- `legged_gym/envs/gr1t1/gr1t1.py:340-589`
- `legged_gym/envs/base/legged_robot.py:1277-1376` (the ETH originals)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RewardContext(NamedTuple):
    """Everything the reward stack reads, post-physics for one policy step."""

    commands: torch.Tensor             # (N, 3)
    base_lin_vel: torch.Tensor         # (N, 3) base frame
    base_ang_vel: torch.Tensor         # (N, 3) base frame
    base_projected_gravity: torch.Tensor  # (N, 3)
    base_heights_offset: torch.Tensor  # (N,) pre-scaled by the obs height scale
    base_height: torch.Tensor          # (N,) raw mean(base_z - measured_heights)
    torso_projected_gravity: torch.Tensor     # (N, 3)
    forehead_projected_gravity: torch.Tensor  # (N, 3)
    dof_pos: torch.Tensor              # (N, D)
    dof_vel: torch.Tensor              # (N, D)
    dof_acc: torch.Tensor              # (N, D)
    torques: torch.Tensor              # (N, D)
    actions: torch.Tensor              # (N, A)
    last_actions: torch.Tensor         # (N, A)
    last_last_actions: torch.Tensor    # (N, A)
    feet_contact: torch.Tensor         # (N, F) bool
    feet_first_contact: torch.Tensor   # (N, F) float
    feet_air_time: torch.Tensor        # (N, F)
    feet_land_time: torch.Tensor       # (N, F)
    feet_height: torch.Tensor          # (N, F) vs measured terrain
    feet_contact_force: torch.Tensor   # (N, F, 3) net per-foot contact force
    avg_feet_contact_force: torch.Tensor  # (N, F) decimation average of |force|
    avg_feet_speed_xyz: torch.Tensor   # (N, F, 3) decimation average of |v|
    penalized_contact_count: torch.Tensor  # (N,) penalized links with |F| > 0.1
    reset_buf: torch.Tensor            # (N,) bool
    time_out_buf: torch.Tensor         # (N,) bool


def _cmd_active(ctx):
    """No gait reward for near-zero commands (`gr1t1.py:498` etc.)."""
    return torch.linalg.vector_norm(ctx.commands[:, :2], dim=1) > 0.1


# ---------------------------------------------------------------------------
# FFTAI base terms (legged_robot_fftai.py:181-353)
# ---------------------------------------------------------------------------


def termination(env, ctx):
    return (ctx.reset_buf & ~ctx.time_out_buf).to(torch.float32)


def collision(env, ctx):
    sig = env.cfg.rewards.sigma_collision
    return 1.0 - torch.exp(sig * ctx.penalized_contact_count)


def stand_still(env, ctx):
    sig = env.cfg.rewards.sigma_stand_still
    err = torch.sum(torch.abs(ctx.dof_pos - env.default_dof_pos_t), dim=1)
    sel = torch.linalg.vector_norm(ctx.commands[:, :2], dim=1) < 0.1
    return torch.exp(sig * err) * sel


def cmd_diff_lin_vel_x(env, ctx):
    err = torch.abs(ctx.commands[:, 0] - ctx.base_lin_vel[:, 0])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_lin_vel_x * err)


def cmd_diff_lin_vel_y(env, ctx):
    err = torch.abs(ctx.commands[:, 1] - ctx.base_lin_vel[:, 1])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_lin_vel_y * err)


def cmd_diff_lin_vel_z(env, ctx):
    err = torch.abs(ctx.base_lin_vel[:, 2])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_lin_vel_z * err)


def cmd_diff_ang_vel_roll(env, ctx):
    err = torch.abs(ctx.base_ang_vel[:, 0])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_ang_vel_roll * err)


def cmd_diff_ang_vel_pitch(env, ctx):
    err = torch.abs(ctx.base_ang_vel[:, 1])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_ang_vel_pitch * err)


def cmd_diff_ang_vel_yaw(env, ctx):
    err = torch.abs(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_ang_vel_yaw * err)


def cmd_diff_base_height(env, ctx):
    # only heights below target are penalized (fftai:241-245)
    err = torch.abs(ctx.base_heights_offset) * (ctx.base_heights_offset < 0)
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_base_height * err)


def cmd_diff_base_orient(env, ctx):
    err = torch.sum(torch.abs(ctx.base_projected_gravity[:, :2]), dim=1)
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_base_orient * err)


def cmd_diff_torso_orient(env, ctx):
    err = torch.sum(torch.abs(ctx.torso_projected_gravity[:, :2]), dim=1)
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_torso_orient * err)


def cmd_diff_forehead_orient(env, ctx):
    err = torch.sum(torch.abs(ctx.forehead_projected_gravity[:, :2]), dim=1)
    return torch.exp(env.cfg.rewards.sigma_cmd_diff_forehead_orient * err)


def action_diff(env, ctx):
    err = (ctx.last_actions - ctx.actions) * env.cfg.control.action_scale
    err = torch.sum(torch.abs(err), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_action_diff * err)


def action_diff_diff(env, ctx):
    # NOTE: the reference updates last_last_actions *after* last_actions
    # every step (legged_robot_fftai.py:94 after legged_robot.py:299), so at
    # reward time last_last == last and this is a second action_diff with a
    # different sigma. Reproduced faithfully.
    d1 = (ctx.last_actions - ctx.actions) * env.cfg.control.action_scale
    d0 = (ctx.last_last_actions - ctx.last_actions) * env.cfg.control.action_scale
    err = torch.sum(torch.abs(d1 - d0), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_action_diff_diff * err)


def action_diff_knee(env, ctx):
    idx = env.index_t(env.knee_dofs)
    err = (ctx.actions[:, idx] - ctx.last_actions[:, idx]) * env.cfg.control.action_scale
    err = torch.sum(torch.abs(err), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_action_diff_knee * err)


def dof_vel_new(env, ctx):
    err = torch.sum(torch.abs(ctx.dof_vel), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_dof_vel_new * err)


def dof_vel_new_knee(env, ctx):
    idx = env.index_t(env.knee_dofs)
    err = torch.sum(torch.abs(ctx.dof_vel[:, idx]), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_dof_vel_new_knee * err)


def dof_acc_new(env, ctx):
    err = torch.sum(torch.abs(ctx.dof_acc), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_dof_acc_new * err)


def dof_tor_new(env, ctx):
    err = torch.sum(torch.abs(ctx.torques), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_dof_tor_new * err)


def dof_tor_new_hip_roll(env, ctx):
    idx = env.index_t(env.hip_roll_dofs)
    err = torch.sum(torch.abs(ctx.torques[:, idx]), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_dof_tor_new_hip_roll * err)


def pose_offset(env, ctx):
    err = torch.sum(torch.abs(ctx.dof_pos - env.default_dof_pos_t), dim=1)
    return torch.exp(env.cfg.rewards.sigma_pose_offset * err)


def pose_offset_hip_yaw(env, ctx):
    idx = env.index_t(env.hip_yaw_dofs)
    err = torch.sum(torch.abs(ctx.dof_pos[:, idx] - env.default_dof_pos_t[idx]), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_pose_offset_hip_yaw * err)


def limits_dof_pos(env, ctx):
    lo = -torch.clamp(ctx.dof_pos - env.dof_pos_soft_lower_t, max=0.0)
    hi = torch.clamp(ctx.dof_pos - env.dof_pos_soft_upper_t, min=0.0)
    err = torch.sum(torch.abs(lo + hi), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_limits_dof_pos * err)


def limits_dof_vel(env, ctx):
    over = torch.clamp(
        torch.abs(ctx.dof_vel) - env.dof_vel_limits_t * env.cfg.rewards.soft_dof_vel_limit,
        min=0.0,
        max=1.0,
    )
    err = torch.sum(over, dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_limits_dof_vel * err)


def limits_dof_tor(env, ctx):
    over = torch.clamp(
        torch.abs(ctx.torques) - env.torque_limits_t * env.cfg.rewards.soft_torque_limit,
        min=0.0,
    )
    err = torch.sum(over, dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_limits_dof_tor * err)


# ---------------------------------------------------------------------------
# GR1T1 foot/gait terms (gr1t1.py:398-589)
# ---------------------------------------------------------------------------


def dof_tor_ankle_feet_lift_up(env, ctx):
    sig = env.cfg.rewards.sigma_dof_tor_ankle_feet_lift_up
    target = env.cfg.rewards.swing_feet_height_target
    ankles = env.ankle_dofs
    half = len(ankles) // 2
    left = env.index_t(ankles[:half])
    right = env.index_t(ankles[half:])
    lh, rh = ctx.feet_height[:, 0], ctx.feet_height[:, 1]
    err_l = (
        torch.sum(torch.abs(ctx.torques[:, left]), dim=1) * torch.abs(lh) * (lh > target / 2)
    )
    err_r = (
        torch.sum(torch.abs(ctx.torques[:, right]), dim=1) * torch.abs(rh) * (rh > target / 2)
    )
    return 1.0 - torch.exp(sig * (err_l + err_r))


def feet_speed_xy_close_to_ground(env, ctx):
    sig = env.cfg.rewards.sigma_feet_speed_xy_close_to_ground
    quarter = env.cfg.rewards.swing_feet_height_target / 4
    h = ctx.feet_height                                  # (N, 2)
    closeness = torch.abs(h - quarter) * (h < quarter) / quarter
    speed_xy = torch.linalg.vector_norm(ctx.avg_feet_speed_xyz[:, :, :2], dim=2)
    err = torch.sum(speed_xy * closeness, dim=1)
    return torch.exp(sig * err)


def feet_speed_z_close_to_height_target(env, ctx):
    sig = env.cfg.rewards.sigma_feet_speed_z_close_to_height_target
    target = env.cfg.rewards.swing_feet_height_target
    h = ctx.feet_height
    closeness = torch.abs(h - target * 3 / 4) * (h > target * 3 / 4) / (target / 4)
    speed_z = torch.abs(ctx.avg_feet_speed_xyz[:, :, 2])
    err = torch.sum(speed_z * closeness, dim=1)
    return torch.exp(sig * err)


def feet_air_time(env, ctx):
    sig = env.cfg.rewards.sigma_feet_air_time
    err = torch.abs(ctx.feet_air_time - env.cfg.rewards.feet_air_time_target)
    rew = torch.exp(sig * err) * ctx.feet_first_contact
    return torch.sum(rew, dim=1) * _cmd_active(ctx)


def feet_air_height(env, ctx):
    sig = env.cfg.rewards.sigma_feet_air_height
    target = env.cfg.rewards.swing_feet_height_target
    min_h = torch.amin(ctx.feet_height, dim=1, keepdim=True)
    err_h = torch.abs(ctx.feet_height - min_h - target)
    mid_err = torch.abs(ctx.feet_air_time - env.cfg.rewards.feet_air_time_target / 2)
    rew = torch.exp(sig * torch.sum(mid_err * err_h, dim=1))
    return rew * _cmd_active(ctx)


def feet_air_force(env, ctx):
    sig = env.cfg.rewards.sigma_feet_air_force
    mid_err = torch.abs(ctx.feet_air_time - env.cfg.rewards.feet_air_time_target / 2)
    err = torch.sum(mid_err * ctx.avg_feet_contact_force, dim=1)
    return torch.exp(sig * err) * _cmd_active(ctx)


def feet_land_time(env, ctx):
    sig = env.cfg.rewards.sigma_feet_land_time
    over = (ctx.feet_land_time - env.cfg.rewards.feet_land_time_max) * (
        ctx.feet_land_time > env.cfg.rewards.feet_land_time_max
    )
    rew = torch.sum(1.0 - torch.exp(sig * over), dim=1)
    return rew * _cmd_active(ctx)


def on_the_air(env, ctx):
    return (torch.sum(ctx.feet_contact, dim=1) == 0).to(torch.float32)


def feet_stumble(env, ctx):
    sig = env.cfg.rewards.sigma_feet_stumble
    ratio = env.cfg.rewards.feet_stumble_ratio
    fxy = torch.linalg.vector_norm(ctx.feet_contact_force[:, :, :2], dim=2)
    fz = torch.abs(ctx.feet_contact_force[:, :, 2])
    err = torch.clamp(fxy - ratio * fz, min=0.0)
    rew = torch.sum(1.0 - torch.exp(sig * err), dim=1)
    return rew


# ---------------------------------------------------------------------------
# ETH base terms (legged_robot.py:1277-1376), selectable for custom tasks
# ---------------------------------------------------------------------------


def lin_vel_z(env, ctx):
    return torch.square(ctx.base_lin_vel[:, 2])


def ang_vel_xy(env, ctx):
    return torch.sum(torch.square(ctx.base_ang_vel[:, :2]), dim=1)


def orientation(env, ctx):
    return torch.sum(torch.square(ctx.base_projected_gravity[:, :2]), dim=1)


def torques(env, ctx):
    return torch.sum(torch.square(ctx.torques), dim=1)


def dof_vel(env, ctx):
    return torch.sum(torch.square(ctx.dof_vel), dim=1)


def dof_acc(env, ctx):
    return torch.sum(torch.square(ctx.dof_acc), dim=1)


def action_rate(env, ctx):
    return torch.sum(torch.square(ctx.last_actions - ctx.actions), dim=1)


def tracking_lin_vel(env, ctx):
    err = torch.sum(torch.square(ctx.commands[:, :2] - ctx.base_lin_vel[:, :2]), dim=1)
    return torch.exp(-err / env.cfg.rewards.tracking_sigma)


def tracking_ang_vel(env, ctx):
    err = torch.square(ctx.commands[:, 2] - ctx.base_ang_vel[:, 2])
    return torch.exp(-err / env.cfg.rewards.tracking_sigma)


def feet_contact_forces(env, ctx):
    over = torch.clamp(
        torch.linalg.vector_norm(ctx.feet_contact_force, dim=-1) - env.cfg.rewards.max_contact_force,
        min=0.0,
    )
    return torch.sum(over, dim=1)


def base_height(env, ctx):
    """legged_robot.py:1289-1292: squared distance of terrain-relative base
    height from the target."""
    return torch.square(ctx.base_height - env.cfg.rewards.base_height_target)


def dof_pos_limits(env, ctx):
    """legged_robot.py:1317-1321: linear out-of-soft-limit excess (the soft
    scaling of `_process_dof_props`, legged_robot.py:594-615, is baked into
    ``env.dof_pos_soft_lower_t/upper_t``)."""
    under = torch.clamp(ctx.dof_pos - env.dof_pos_soft_lower_t, max=0.0)
    over = torch.clamp(ctx.dof_pos - env.dof_pos_soft_upper_t, min=0.0)
    return torch.sum(over - under, dim=1)


def dof_vel_limits(env, ctx):
    """legged_robot.py:1323-1326: velocity excess, clipped to 1 rad/s/joint."""
    over = torch.clamp(
        torch.abs(ctx.dof_vel) - env.dof_vel_limits_t * env.cfg.rewards.soft_dof_vel_limit,
        min=0.0,
        max=1.0,
    )
    return torch.sum(over, dim=1)


def torque_limits(env, ctx):
    """legged_robot.py:1328-1330."""
    over = torch.clamp(
        torch.abs(ctx.torques) - env.torque_limits_t * env.cfg.rewards.soft_torque_limit,
        min=0.0,
    )
    return torch.sum(over, dim=1)


def limits_actions(env, ctx):
    """legged_robot_fftai.py:308-320: exp-shaped penalty on scaled actions
    outside the soft dof position limits (note the reference compares the
    scaled action directly, without the default-pose offset)."""
    scaled = ctx.actions * env.cfg.control.action_scale
    under = torch.clamp(scaled - env.dof_pos_soft_lower_t, max=0.0)
    over = torch.clamp(scaled - env.dof_pos_soft_upper_t, min=0.0)
    err = torch.sum(torch.square(over - under), dim=1)
    return 1.0 - torch.exp(env.cfg.rewards.sigma_limits_actions * err)


def stumble(env, ctx):
    """ETH stumble (legged_robot.py:1354-1357): any foot whose tangential
    contact force exceeds 5x its normal force (hit a vertical surface)."""
    fxy = torch.linalg.vector_norm(ctx.feet_contact_force[:, :, :2], dim=2)
    fz = torch.abs(ctx.feet_contact_force[:, :, 2])
    return torch.any(fxy > 5.0 * fz, dim=1).to(torch.float32)


REWARDS = {
    "termination": termination,
    "collision": collision,
    "stand_still": stand_still,
    "cmd_diff_lin_vel_x": cmd_diff_lin_vel_x,
    "cmd_diff_lin_vel_y": cmd_diff_lin_vel_y,
    "cmd_diff_lin_vel_z": cmd_diff_lin_vel_z,
    "cmd_diff_ang_vel_roll": cmd_diff_ang_vel_roll,
    "cmd_diff_ang_vel_pitch": cmd_diff_ang_vel_pitch,
    "cmd_diff_ang_vel_yaw": cmd_diff_ang_vel_yaw,
    "cmd_diff_base_height": cmd_diff_base_height,
    "cmd_diff_base_orient": cmd_diff_base_orient,
    "cmd_diff_torso_orient": cmd_diff_torso_orient,
    "cmd_diff_forehead_orient": cmd_diff_forehead_orient,
    "action_diff": action_diff,
    "action_diff_diff": action_diff_diff,
    "action_diff_knee": action_diff_knee,
    "dof_vel_new": dof_vel_new,
    "dof_vel_new_knee": dof_vel_new_knee,
    "dof_acc_new": dof_acc_new,
    "dof_tor_new": dof_tor_new,
    "dof_tor_new_hip_roll": dof_tor_new_hip_roll,
    "pose_offset": pose_offset,
    "pose_offset_hip_yaw": pose_offset_hip_yaw,
    "limits_dof_pos": limits_dof_pos,
    "limits_dof_vel": limits_dof_vel,
    "limits_dof_tor": limits_dof_tor,
    "dof_tor_ankle_feet_lift_up": dof_tor_ankle_feet_lift_up,
    "feet_speed_xy_close_to_ground": feet_speed_xy_close_to_ground,
    "feet_speed_z_close_to_height_target": feet_speed_z_close_to_height_target,
    "feet_air_time": feet_air_time,
    "feet_air_height": feet_air_height,
    "feet_air_force": feet_air_force,
    "feet_land_time": feet_land_time,
    "on_the_air": on_the_air,
    "feet_stumble": feet_stumble,
    # ETH base terms
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "orientation": orientation,
    "torques": torques,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "action_rate": action_rate,
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "feet_contact_forces": feet_contact_forces,
    "base_height": base_height,
    "dof_pos_limits": dof_pos_limits,
    "dof_vel_limits": dof_vel_limits,
    "torque_limits": torque_limits,
    "limits_actions": limits_actions,
    "stumble": stumble,
}
