"""Forward kinematics over the static kinematic tree.

Port of ``wiki_grx_gym_tpu/sim/kinematics.py:forward_kinematics``. The env
runs it at build time (self-collision pair selection); the hot path uses the
lane-form FK inside the decimation program instead. Broadcasts over leading
batch dimensions of the state arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wiki_grx_gym_tpu_torch.models.robot import RobotModel
from wiki_grx_gym_tpu_torch.utils.maths import _cross, quat_apply, quat_from_angle_axis, quat_mul


class Kinematics(NamedTuple):
    """Per-body world kinematics in base-origin reference coordinates."""

    quat: torch.Tensor      # (..., B, 4) body orientation, world axes
    pos_rel: torch.Tensor   # (..., B, 3) body origin relative to the base origin
    axis_w: torch.Tensor    # (..., B, 3) joint axis in world axes (row 0 zero)
    subspace: torch.Tensor  # (..., B, 6) revolute motion subspace (row 0 zero)
    twist: torch.Tensor     # (..., B, 6) spatial velocity [w; v at the base origin]


def forward_kinematics(
    model: RobotModel,
    base_quat: torch.Tensor,     # (..., 4)
    base_ang_vel: torch.Tensor,  # (..., 3) world
    base_lin_vel: torch.Tensor,  # (..., 3) world, of the base origin
    q: torch.Tensor,             # (..., D)
    qd: torch.Tensor,            # (..., D)
) -> Kinematics:
    dev, dt = base_quat.device, base_quat.dtype
    tree_quat = model.tree_quat.to(dev, dt)
    tree_pos = model.tree_pos.to(dev, dt)
    axis = model.axis.to(dev, dt)
    zeros3 = torch.zeros_like(base_ang_vel)
    quats = [base_quat]
    pos_rel = [zeros3]
    axis_w = [zeros3]
    subspace = [torch.cat([zeros3, zeros3], dim=-1)]
    twists = [torch.cat([base_ang_vel, base_lin_vel], dim=-1)]

    for i in range(1, model.num_bodies):
        p = model.parent[i]
        d = i - 1
        # parent frame -> joint frame (static) -> rotate about the joint axis
        q_static = quat_mul(quats[p], tree_quat[i].expand_as(quats[p]))
        q_joint = quat_from_angle_axis(q[..., d], axis[i].expand_as(pos_rel[p]))
        quats.append(quat_mul(q_static, q_joint))
        pos_rel.append(pos_rel[p] + quat_apply(quats[p], tree_pos[i].expand_as(pos_rel[p])))
        a_w = quat_apply(quats[i], axis[i].expand_as(pos_rel[p]))
        axis_w.append(a_w)
        s = torch.cat([a_w, _cross(pos_rel[i], a_w)], dim=-1)
        subspace.append(s)
        twists.append(twists[p] + s * qd[..., d: d + 1])

    return Kinematics(
        quat=torch.stack(quats, dim=-2),
        pos_rel=torch.stack(pos_rel, dim=-2),
        axis_w=torch.stack(axis_w, dim=-2),
        subspace=torch.stack(subspace, dim=-2),
        twist=torch.stack(twists, dim=-2),
    )
