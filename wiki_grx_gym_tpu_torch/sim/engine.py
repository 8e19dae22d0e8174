"""The simulation engine: one functional physics substep, batched over envs.

Port of ``wiki_grx_gym_tpu/sim/engine.py``. The JAX package writes
:func:`physics_step` for one robot and vmaps it over the env axis; here it
takes (N, ...) tensors (any leading dimensions) and runs the same program
with the batch written out. State in, state out: the reference's
``set_dof_actuation_force_tensor`` / ``simulate`` / ``refresh_*_tensor``
cycle (`legged_robot_fftai.py:56-76`) is the ``tau`` argument, the call and
its outputs.

The env steps through this engine when ``cfg.sim.use_pallas`` is off
(``envs/legged_env.py``, ``_decimation_scan``); otherwise through K1
(``sim/cuda_step.py``) or its lane program, which carry the same physics in
component form. Everything is plain PyTorch on the inputs' device and in
their dtype, so the same code runs in float64 for the autograd checks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from wiki_grx_gym_tpu_torch.models.robot import RobotModel
from wiki_grx_gym_tpu_torch.sim.contact import (
    ContactParams,
    HeightFn,
    body_wrenches,
    contact_forces,
    self_collision_forces,
)
from wiki_grx_gym_tpu_torch.sim.dynamics import forward_dynamics
from wiki_grx_gym_tpu_torch.sim.kinematics import Kinematics, forward_kinematics, model_const, static_index
from wiki_grx_gym_tpu_torch.utils.maths import _cross, _div, quat_apply, quat_integrate

_MAX_LIN_VEL = 100.0   # asset max_linear_velocity (legged_robot_config.py:128-129)
_MAX_ANG_VEL = 100.0
_MAX_DOF_VEL = 100.0   # PhysX maxJointVelocity analogue: breaks contact runaway


@dataclasses.dataclass
class PhysicsState:
    """Minimal-coordinate state, batched (N, ...)."""

    base_pos: torch.Tensor      # (N, 3) world
    base_quat: torch.Tensor     # (N, 4) x, y, z, w
    base_lin_vel: torch.Tensor  # (N, 3) world, velocity of the base origin
    base_ang_vel: torch.Tensor  # (N, 3) world
    q: torch.Tensor             # (N, D)
    qd: torch.Tensor            # (N, D)
    anchor: torch.Tensor        # (N, P, 3) stick-friction anchors (world)

    def replace(self, **kw) -> "PhysicsState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class BodyRandomization:
    """Per-env domain randomization of the physical model, (N,) leaves."""

    friction: torch.Tensor         # (N,)
    restitution: torch.Tensor      # (N,)
    base_mass_scale: torch.Tensor  # (N,)
    base_com_offset: torch.Tensor  # (N, 3)

    def replace(self, **kw) -> "BodyRandomization":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def identity(batch=(), device=None) -> "BodyRandomization":
        """No randomization: friction 1, restitution 0, mass scale 1, no
        com offset, float32 leaves of shape ``batch``."""
        batch = tuple(batch)
        full = lambda v, shape: torch.full(shape, v, dtype=torch.float32, device=device)
        return BodyRandomization(friction=full(1.0, batch), restitution=full(0.0, batch),
                                 base_mass_scale=full(1.0, batch), base_com_offset=full(0.0, batch + (3,)))


class PhysicsOutput(NamedTuple):
    kin: Kinematics              # per-body kinematics (reference frame at the base origin)
    point_force: torch.Tensor    # (..., P, 3) world contact force per proxy sphere
    point_pos: torch.Tensor      # (..., P, 3) world sphere centers
    qdd: torch.Tensor            # (..., D)


def default_state(model: RobotModel, base_pos, base_quat, q, device=None) -> PhysicsState:
    """A float32 state at rest; ``base_pos`` (..., 3), ``base_quat`` (..., 4)
    and ``q`` (..., D) give its leading dimensions (none for one robot)."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    base_pos, base_quat, q = t(base_pos), t(base_quat), t(q)
    zeros = lambda *shape: torch.zeros(base_pos.shape[:-1] + shape, dtype=torch.float32, device=device)
    return PhysicsState(base_pos=base_pos, base_quat=base_quat, base_lin_vel=zeros(3), base_ang_vel=zeros(3),
                        q=q, qd=zeros(model.num_dof), anchor=zeros(model.num_points, 3))


def physics_step(
    model: RobotModel,
    state: PhysicsState,
    tau: torch.Tensor,               # (..., D) actuation torques (already clipped)
    height_fn: HeightFn,
    contact_params: ContactParams,
    rand: BodyRandomization,
    dt: float,
    fixed_base: bool = False,
    self_pairs: tuple = ((), ()),    # static (pairs_i, pairs_j) for self-collision
    joint_damping: torch.Tensor = None,   # (..., D) actuator damping, solved implicitly
    ground_query=None,               # riser-aware 9-channel query (trimesh)
):
    """One substep: joint limits, FK, contact, forward dynamics and
    semi-implicit Euler. Returns ``(new_state, PhysicsOutput)``."""
    q, qd = state.q, state.qd
    # joint position limits (PhysX enforces the URDF's as hard constraints):
    # an effort-scaled penalty k = effort / joint_limit_violation whose
    # damping 2 k dt, active inside the violation only, is integrated
    # implicitly (forward_dynamics' joint_diag): stable for any k and inertia
    if contact_params.joint_limit_violation > 0.0 and model.num_dof:
        k_lim = _div(model_const(model.dof_effort_limit, q), contact_params.joint_limit_violation)
        over = torch.clamp(q - model_const(model.dof_upper, q), min=0.0)
        under = torch.clamp(model_const(model.dof_lower, q) - q, min=0.0)
        violating = ((over > 0.0) | (under > 0.0)).to(q.dtype)
        lim_damp = (2.0 * k_lim * dt) * violating
        tau = tau + k_lim * (under - over) - lim_damp * qd
        joint_damping = lim_damp if joint_damping is None else joint_damping + lim_damp

    kin = forward_kinematics(model, state.base_quat, state.base_ang_vel, state.base_lin_vel, q, qd)

    # contact proxy spheres: world position and velocity
    pb = model_const(static_index(tuple(model.point_body)), q, torch.int64)
    point_quat = kin.quat[..., pb, :]
    point_rel = kin.pos_rel[..., pb, :] + quat_apply(point_quat, model_const(model.point_offset, q).expand(
        point_quat.shape[:-1] + (3,)))
    tw = kin.twist[..., pb, :]
    point_vel = tw[..., 3:] + _cross(tw[..., :3], point_rel)
    point_pos = state.base_pos[..., None, :] + point_rel
    radius = model_const(model.point_radius, q)

    if contact_params.tangent_stiffness > 0.0:
        f_points, new_anchor = contact_forces(
            contact_params, height_fn, point_pos, point_vel, radius, rand.friction, rand.restitution,
            dt, anchor=state.anchor, ground_query=ground_query,
        )
    else:
        f_points = contact_forces(
            contact_params, height_fn, point_pos, point_vel, radius, rand.friction, rand.restitution,
            dt, ground_query=ground_query,
        )
        new_anchor = state.anchor
    if self_pairs[0]:
        f_points = f_points + self_collision_forces(
            contact_params, point_pos, point_vel, radius, self_pairs[0], self_pairs[1], dt,
        )
    ext = body_wrenches(model.num_bodies, model.point_body, point_rel, f_points)

    dyn = forward_dynamics(
        model, kin, qd, tau, ext,
        base_mass_scale=rand.base_mass_scale,
        base_com_offset=rand.base_com_offset,
        fixed_base=fixed_base,
        joint_diag=None if joint_damping is None else joint_damping * dt,
    )

    # semi-implicit Euler; the base point's conventional acceleration needs
    # the w x v correction (spatial -> conventional, RBDA eq. 2.47)
    if fixed_base:
        ang_vel = torch.zeros_like(state.base_ang_vel)
        lin_vel = torch.zeros_like(state.base_lin_vel)
        base_pos, base_quat = state.base_pos, state.base_quat
    else:
        ang_vel = state.base_ang_vel + dyn.base_acc[..., :3] * dt
        lin_acc = dyn.base_acc[..., 3:] + _cross(state.base_ang_vel, state.base_lin_vel)
        lin_vel = state.base_lin_vel + lin_acc * dt
        ang_vel = torch.clamp(ang_vel, -_MAX_ANG_VEL, _MAX_ANG_VEL)
        lin_vel = torch.clamp(lin_vel, -_MAX_LIN_VEL, _MAX_LIN_VEL)
        base_pos = state.base_pos + lin_vel * dt
        base_quat = quat_integrate(state.base_quat, ang_vel, dt)
    qd = torch.clamp(qd + dyn.qdd * dt, -_MAX_DOF_VEL, _MAX_DOF_VEL)

    new_state = PhysicsState(
        base_pos=base_pos,
        base_quat=base_quat,
        base_lin_vel=lin_vel,
        base_ang_vel=ang_vel,
        q=q + qd * dt,
        qd=qd,
        anchor=new_anchor,
    )
    return new_state, PhysicsOutput(kin=kin, point_force=f_points, point_pos=point_pos, qdd=dyn.qdd)


def flat_ground(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plane terrain (`legged_robot.py:868-876`)."""
    return torch.zeros_like(x)
