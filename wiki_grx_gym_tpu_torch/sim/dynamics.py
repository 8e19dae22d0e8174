"""Articulated rigid-body dynamics: CRBA mass matrix, RNEA bias, dense solve.

Port of ``wiki_grx_gym_tpu/sim/dynamics.py``, batched over leading
dimensions (the env axis) instead of vmapped. The equations of motion are
formed explicitly,

    M(q) [a0; qdd] = [0; tau] - C(q, v, f_ext),

with ``M`` by the Composite Rigid Body Algorithm, ``C`` (Coriolis, gravity,
external and contact wrenches) by a zero-qdd recursive Newton-Euler pass,
and the (6+D) x (6+D) SPD system solved by the unrolled Cholesky of
``ops/linalg.py``.

**Block form.** Each body's inertia is the triplet ``(m, h = m com,
I_org)`` (mass, first moment, rotational inertia about the reference
origin, world axes): composite inertias are sums, and an inertia applied
to a twist ``[w; v]`` is ``[I_org w + h x v; m v + w x h]``. Tree loops run
over the static topology in Python. The dtype and device follow the
inputs; the model's constants are cast to them (``kinematics.model_const``).

``mass_matrix`` and ``bias_forces`` are public so that the tests hold them
to autograd of the Lagrangian (M is the Hessian of the kinetic energy, the
gravity bias the gradient of the potential).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.models.robot import RobotModel
from wiki_grx_gym_tpu_torch.ops.linalg import spd_solve
from wiki_grx_gym_tpu_torch.sim.kinematics import Kinematics, model_const
from wiki_grx_gym_tpu_torch.sim.spatial import spatial_inertia
from wiki_grx_gym_tpu_torch.utils.maths import (
    _cross,
    mat3_sandwich,
    mat3_vec,
    outer3,
    quat_apply,
    quat_to_rotmat,
    skew,
)

_RIDGE = 1e-6
GRAVITY = torch.tensor([0.0, 0.0, -9.81])


@functools.lru_cache(maxsize=None)
def _ancestor_table(parent: Tuple[int, ...]) -> torch.Tensor:
    """(D, D) host mask: A[i, j] = 1 iff joint j is an ancestor-or-self of
    joint i (one tensor object per topology, so that its device copies are
    cached)."""
    d = len(parent) - 1
    a = np.zeros((d, d), dtype=np.float32)
    for i in range(d):
        b = i + 1
        while b > 0:
            a[i, b - 1] = 1.0
            b = parent[b]
    return torch.from_numpy(a)


def _ancestor_matrix(model: RobotModel, like: torch.Tensor) -> torch.Tensor:
    return model_const(_ancestor_table(tuple(model.parent)), like)


class BlockInertia(NamedTuple):
    """Per-body inertial triplet at the reference origin (world axes)."""

    m: torch.Tensor       # (..., B)
    h: torch.Tensor       # (..., B, 3) first moment m * com_rel
    i_org: torch.Tensor   # (..., B, 3, 3) rotational inertia about the reference origin


def inertial_quantities(model: RobotModel, kin: Kinematics, base_mass_scale=None, base_com_offset=None):
    """(masses (..., B), world com_rel (..., B, 3), block inertias). The
    base's mass scale (...,) and body-frame com offset (..., 3) are the
    reference's rigid-body property randomization (`legged_robot.py:
    618-648`) as per-env values."""
    like = kin.pos_rel
    batch = like.shape[:-2]
    mass = model_const(model.mass, like).expand(batch + (model.num_bodies,))
    com_local = model_const(model.com, like).expand(batch + (model.num_bodies, 3))
    if base_mass_scale is not None:
        mass = torch.cat([mass[..., :1] * base_mass_scale[..., None], mass[..., 1:]], dim=-1)
    if base_com_offset is not None:
        com_local = torch.cat([com_local[..., :1, :] + base_com_offset[..., None, :], com_local[..., 1:, :]],
                              dim=-2)
    rot = quat_to_rotmat(kin.quat)
    com_rel = kin.pos_rel + quat_apply(kin.quat, com_local)
    inertia_w = mat3_sandwich(rot, model_const(model.inertia, like))
    # (cx cx) = c c^T - |c|^2 E, so i_org = I_w + m (|c|^2 E - c c^T)
    c2 = torch.sum(com_rel * com_rel, dim=-1)
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    i_org = inertia_w + mass[..., None, None] * (c2[..., None, None] * eye - outer3(com_rel, com_rel))
    return mass, com_rel, BlockInertia(m=mass, h=mass[..., None] * com_rel, i_org=i_org)


def spatial_inertia6(mass, com_rel, blocks: BlockInertia) -> torch.Tensor:
    """Dense (..., B, 6, 6) spatial inertias (the tests' energies).
    ``i_org = I_w - m cx cx``, so ``I_w = i_org + m cx cx``."""
    cx = skew(com_rel)
    i_w = blocks.i_org + mass[..., None, None] * (cx @ cx)
    return spatial_inertia(mass, com_rel, i_w)


def _apply(m, h, io, w, v):
    """Momentum [L; p] of the inertia (m, h, io) under the twist [w; v]."""
    l_ang = mat3_vec(io, w) + _cross(h, v)
    p_lin = m[..., None] * v + _cross(w, h)
    return l_ang, p_lin


def _base_block(cm, ch, cio):
    hx = skew(ch)
    eye = torch.eye(3, dtype=hx.dtype, device=hx.device)
    return torch.cat([
        torch.cat([cio, hx], dim=-1),
        torch.cat([-hx, cm[..., None, None] * eye], dim=-1),
    ], dim=-2)


def mass_matrix(model: RobotModel, kin: Kinematics, blocks: BlockInertia) -> torch.Tensor:
    """The (..., 6+D, 6+D) generalized mass matrix by CRBA in block form,
    symmetrized as ``0.5 (M + M^T)``, the armature on the joint diagonal."""
    nb, nd = model.num_bodies, model.num_dof
    subspace = kin.subspace

    # composite inertias: the triplets add up the tree
    cm = [blocks.m[..., i] for i in range(nb)]
    ch = [blocks.h[..., i, :] for i in range(nb)]
    cio = [blocks.i_org[..., i, :, :] for i in range(nb)]
    for i in range(nb - 1, 0, -1):
        p = model.parent[i]
        cm[p] = cm[p] + cm[i]
        ch[p] = ch[p] + ch[i]
        cio[p] = cio[p] + cio[i]
    m_bb = _base_block(cm[0], ch[0], cio[0])
    if nd == 0:
        return m_bb

    # F_j = Ic_{j+1} S_{j+1} with S = [a; s]
    sw = subspace[..., 1:, :3]                       # (..., D, 3)
    sv = subspace[..., 1:, 3:]
    c_m = torch.stack(cm[1:], dim=-1)                # (..., D)
    c_h = torch.stack(ch[1:], dim=-2)                # (..., D, 3)
    c_io = torch.stack(cio[1:], dim=-3)              # (..., D, 3, 3)
    f_ang = mat3_vec(c_io, sw) + _cross(c_h, sv)
    f_lin = c_m[..., None] * sv + _cross(sw, c_h)
    f_crb = torch.cat([f_ang, f_lin], dim=-1)        # (..., D, 6)

    s_joint = subspace[..., 1:, :]
    # (D, 6) @ (6, D) as a sum of rank-1 products, in the JAX package's order
    gram = sum(f_crb[..., :, None, k] * s_joint[..., None, :, k] for k in range(6))
    lower = _ancestor_matrix(model, gram) * gram
    m_joint = (lower + lower.transpose(-1, -2) - torch.diag_embed(torch.diagonal(gram, dim1=-2, dim2=-1))
               + torch.diag(model_const(model.armature, gram)))
    m_full = torch.cat([
        torch.cat([m_bb, f_crb.transpose(-1, -2)], dim=-1),
        torch.cat([f_crb, m_joint], dim=-1),
    ], dim=-2)
    return 0.5 * (m_full + m_full.transpose(-1, -2))


def bias_forces(model: RobotModel, kin: Kinematics, qd: torch.Tensor, blocks: BlockInertia,
                ext_ang: torch.Tensor, ext_lin: torch.Tensor) -> torch.Tensor:
    """Generalized bias C (..., 6+D): the force for zero acceleration.
    ``ext_ang`` (..., B, 3) is the external torque about the reference
    origin (gravity included), ``ext_lin`` (..., B, 3) the external force."""
    nb, nd = model.num_bodies, model.num_dof
    subspace, twist = kin.subspace, kin.twist

    bias_acc = [torch.zeros_like(twist[..., 0, :])]
    for i in range(1, nb):
        p = model.parent[i]
        sqd = subspace[..., i, :] * qd[..., i - 1: i]
        tw = twist[..., i, :]
        cross = torch.cat([
            _cross(tw[..., :3], sqd[..., :3]),
            _cross(tw[..., :3], sqd[..., 3:]) + _cross(tw[..., 3:], sqd[..., :3]),
        ], dim=-1)
        bias_acc.append(bias_acc[p] + cross)
    bias_acc = torch.stack(bias_acc, dim=-2)             # (..., B, 6)

    w, v = twist[..., :3], twist[..., 3:]
    l_mom, p_mom = _apply(blocks.m, blocks.h, blocks.i_org, w, v)
    ia_ang, ia_lin = _apply(blocks.m, blocks.h, blocks.i_org, bias_acc[..., :3], bias_acc[..., 3:])
    # v x* P = [w x L + v x p; w x p]
    f_ang = ia_ang + _cross(w, l_mom) + _cross(v, p_mom) - ext_ang
    f_lin = ia_lin + _cross(w, p_mom) - ext_lin
    f_body = torch.cat([f_ang, f_lin], dim=-1)           # (..., B, 6)

    f_acc = [f_body[..., i, :] for i in range(nb)]
    for i in range(nb - 1, 0, -1):
        f_acc[model.parent[i]] = f_acc[model.parent[i]] + f_acc[i]
    if nd == 0:
        return f_acc[0]
    f_joint = torch.stack(f_acc[1:], dim=-2)             # (..., D, 6)
    c_joint = torch.sum(subspace[..., 1:, :] * f_joint, dim=-1)
    return torch.cat([f_acc[0], c_joint], dim=-1)


class ForwardDynamics(NamedTuple):
    base_acc: torch.Tensor   # (..., 6) spatial acceleration of the base at the reference origin
    qdd: torch.Tensor        # (..., D) joint accelerations
    blocks: BlockInertia     # per-body block inertias


def forward_dynamics(
    model: RobotModel,
    kin: Kinematics,
    qd: torch.Tensor,              # (..., D)
    tau: torch.Tensor,             # (..., D) joint torques
    ext_wrench: torch.Tensor,      # (..., B, 6) external wrenches at the reference origin
    base_mass_scale: torch.Tensor = None,   # (...,) mass multiplier of body 0
    base_com_offset: torch.Tensor = None,   # (..., 3) body-frame com shift of body 0
    fixed_base: bool = False,               # asset option fix_base_link
    joint_diag: torch.Tensor = None,        # (..., D) extra joint diagonal (implicit damping)
) -> ForwardDynamics:
    nd = model.num_dof
    mass, com_rel, blocks = inertial_quantities(model, kin, base_mass_scale, base_com_offset)

    # gravity as an explicit force at each com, so that the solved base
    # acceleration is the true spatial acceleration
    grav_lin = mass[..., None] * (model_const(GRAVITY, com_rel) * getattr(model, "gravity_scale", 1.0))
    ext_ang = _cross(com_rel, grav_lin) + ext_wrench[..., :3]
    ext_lin = grav_lin + ext_wrench[..., 3:]

    c_full = bias_forces(model, kin, qd, blocks, ext_ang, ext_lin)
    m_full = mass_matrix(model, kin, blocks)
    if joint_diag is not None:
        # implicit actuator damping: (M + dt D) qdd = tau_explicit is the
        # backward-Euler form of the -D qd drive term (PhysX's implicit
        # joint drives), stable for kd on tiny-inertia links
        m_full = m_full + torch.diag_embed(torch.cat([torch.zeros_like(joint_diag[..., :1]).expand(
            joint_diag.shape[:-1] + (6,)), joint_diag], dim=-1))

    if fixed_base:
        m_jj = m_full[..., 6:, 6:] + _RIDGE * torch.eye(nd, dtype=qd.dtype, device=qd.device)
        qdd = spd_solve(m_jj, tau - c_full[..., 6:])
        return ForwardDynamics(base_acc=torch.zeros_like(c_full[..., :6]), qdd=qdd, blocks=blocks)

    m_full = m_full + _RIDGE * torch.eye(6 + nd, dtype=qd.dtype, device=qd.device)
    rhs = torch.cat([torch.zeros_like(c_full[..., :6]), tau], dim=-1) - c_full
    x = spd_solve(m_full, rhs)
    return ForwardDynamics(base_acc=x[..., :6], qdd=x[..., 6:], blocks=blocks)
