"""Forward kinematics over the static kinematic tree.

Port of ``wiki_grx_gym_tpu/sim/kinematics.py``. The engine path
(``sim/engine.physics_step``) runs it every substep, the env at build time
(self-collision pair selection) and after the engine's policy step; K1 and
its lane program carry their own lane-form FK. Broadcasts over leading
batch dimensions of the state arguments; the model's constants follow the
arguments' device and dtype (:func:`model_const`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
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

    def point_pos_rel(self, body: int, offset: torch.Tensor) -> torch.Tensor:
        """World-axes position of a body-frame point, relative to the base origin."""
        return self.pos_rel[..., body, :] + quat_apply(self.quat[..., body, :], offset.expand_as(
            self.pos_rel[..., body, :]))

    def point_vel(self, body: int, pos_rel: torch.Tensor) -> torch.Tensor:
        """World-axes linear velocity of a body-fixed point at ``pos_rel``."""
        tw = self.twist[..., body, :]
        return tw[..., 3:] + _cross(tw[..., :3], pos_rel)


_CONSTS = {}


def model_const(t: torch.Tensor, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """The model constant ``t`` (a host tensor) on ``like``'s device and in
    its dtype (or ``dtype``), converted once and cached: the engine reads
    the same constants every substep."""
    dtype = like.dtype if dtype is None else dtype
    key = (id(t), like.device, dtype)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not t:
        hit = (t, t.to(like.device, dtype))
        _CONSTS[key] = hit
    return hit[1]


@functools.lru_cache(maxsize=None)
def static_index(values: tuple) -> torch.Tensor:
    """A host int64 index tensor of static values, one object per tuple
    (so that :func:`model_const` caches its device copies)."""
    return torch.as_tensor(values, dtype=torch.int64)


def forward_kinematics(
    model: RobotModel,
    base_quat: torch.Tensor,     # (..., 4)
    base_ang_vel: torch.Tensor,  # (..., 3) world
    base_lin_vel: torch.Tensor,  # (..., 3) world, of the base origin
    q: torch.Tensor,             # (..., D)
    qd: torch.Tensor,            # (..., D)
) -> Kinematics:
    tree_quat = model_const(model.tree_quat, base_quat)
    tree_pos = model_const(model.tree_pos, base_quat)
    axis = model_const(model.axis, base_quat)
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


def _body_ancestor_mask(model: RobotModel) -> np.ndarray:
    """(B, D) static mask: m[i, d] = 1 iff dof ``d`` (joint ``d + 1``) is an
    ancestor-or-self joint of body ``i``."""
    m = np.zeros((model.num_bodies, model.num_dof), dtype=np.float32)
    for i in range(1, model.num_bodies):
        b = i
        while b > 0:
            m[i, b - 1] = 1.0
            b = model.parent[b]
    return m


def jacobians(model: RobotModel, kin: Kinematics) -> torch.Tensor:
    """Per-body geometric Jacobian (the reference's
    ``gym.acquire_jacobian_tensor``; off the training path).

    Returns ``J`` of shape ``(..., B, 6, 6 + D)`` mapping the generalized
    velocity ``[base_ang_vel; base_lin_vel; qd]`` (world axes, as in
    ``PhysicsState``) to each body's ``[w_i; v_i]``, ``v_i`` the linear
    velocity of body ``i``'s frame origin in world axes."""
    nb = model.num_bodies
    ref = kin.quat
    mask = torch.as_tensor(_body_ancestor_mask(model), dtype=ref.dtype, device=ref.device)   # (B, D)
    # joint columns at the shared base-origin reference: S_d masked per body
    s = kin.subspace[..., 1:, :]                                                # (..., D, 6)
    j_joints = mask[:, None, :] * s.transpose(-1, -2)[..., None, :, :]          # (..., B, 6, D)
    # base columns: a base twist is every body's twist at the shared reference
    j_base = torch.eye(6, dtype=ref.dtype, device=ref.device).expand(j_joints.shape[:-3] + (nb, 6, 6))
    j = torch.cat([j_base, j_joints], dim=-1)                                   # (..., B, 6, 6+D)
    # the linear rows move from the base origin to each body's origin:
    # v_i = v_ref + w x p_i, column by column
    w_cols = j[..., :3, :].transpose(-1, -2)                                    # (..., B, C, 3)
    shift = _cross(w_cols, kin.pos_rel[..., :, None, :].expand_as(w_cols))      # (..., B, C, 3)
    return torch.cat([j[..., :3, :], j[..., 3:, :] + shift.transpose(-1, -2)], dim=-2)
