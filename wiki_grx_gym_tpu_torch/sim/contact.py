"""Penalty contact between the robot's proxy spheres and the ground.

Port of ``wiki_grx_gym_tpu/sim/contact.py``, batched over leading
dimensions (the env axis) instead of vmapped: every proxy sphere tests
against the terrain height function every substep, with no broad phase and
no data-dependent shapes. Per point (world axes):

- penetration ``d = h(x, y) - (z - r)``, active iff ``d > 0``;
- normal: ``f_n = k_n d - d_n v_n`` clipped at 0, the damping scaled down by
  the env's restitution;
- tangential: a spring to a per-point anchor that slips along the Coulomb
  cone ``|f_t| <= mu f_n`` (stick friction), or without anchors the
  capped-viscous law;
- on trimesh terrain the riser walls of ``terrain/composer.riser_channels``
  push back horizontally (:func:`wall_forces`).

The per-body net force (the reference's ``net_contact_force_tensor``) is a
sum over each body's points in a fixed order (:func:`body_wrenches`), with
no scatter: the sums give the same bits on every run. The lane program
(``sim/scalarized.py``) and K1 carry the same law in component form.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.sim.kinematics import model_const, static_index
from wiki_grx_gym_tpu_torch.utils.maths import _cross, _div

# height_fn: (x, y) -> height; world frame, broadcasts over point batches
HeightFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """Global contact material/solver constants (static per build).

    ``point_mass`` is the effective inertia one proxy sphere sees at high
    frequency; damping and friction coefficients are capped at
    ``point_mass / dt``."""

    stiffness: float = 1.0e4          # N/m
    damping_ratio: float = 0.7
    point_mass: float = 0.25          # kg
    slip_velocity: float = 1e-5
    # anchored (stick) friction spring; 0 = capped-viscous friction
    tangent_stiffness: float = 1.0e4  # N/m
    # joint position limits as an effort-scaled penalty; 0 disables
    joint_limit_violation: float = 0.05  # rad
    # sphere-sphere self-collision spring
    self_collision_stiffness: float = 1.0e5

    def replace(self, **kw) -> "ContactParams":
        return dataclasses.replace(self, **kw)


def ground_normal(height_fn: HeightFn, x: torch.Tensor, y: torch.Tensor, eps: float = 0.05):
    """Terrain normal from central differences of the height function."""
    dhdx = _div(height_fn(x + eps, y) - height_fn(x - eps, y), 2.0 * eps)
    dhdy = _div(height_fn(x, y + eps) - height_fn(x, y - eps), 2.0 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def wall_forces(params: ContactParams, pos, vel, radius, walls, d_n):
    """Riser-face penalty forces from per-point wall channels (the last 6 of
    ``riser_channels``: per axis ``(pos, top, sign)``; solid where
    ``sign * (coord - pos) > 0`` below ``top``). The face is frictionless.
    ``d_n`` is the normal damping, broadcastable against the points.

    Returns ``(force (..., 3), inside (...))``; ``inside`` marks points whose
    center is strictly within a wall's solid below its top (their tread
    force is suppressed)."""
    out = [torch.zeros_like(pos[..., 0]) for _ in range(2)]
    inside = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for a in range(2):
        wp = walls[..., 3 * a + 0]
        wt = walls[..., 3 * a + 1]
        ws = walls[..., 3 * a + 2]
        below = pos[..., 2] < wt
        pen = ws * (pos[..., a] - wp) + radius
        act = (ws != 0.0) & (pen > 0.0) & below
        v_n = -ws * vel[..., a]   # the velocity along the face's outward normal
        f = torch.clamp(params.stiffness * torch.clamp(pen, max=0.5) - d_n * v_n, min=0.0)
        f = torch.where(act, f, 0.0)
        out[a] = out[a] + (-ws * f)
        inside = inside | ((ws != 0.0) & (ws * (pos[..., a] - wp) > 0.0) & below)
    return torch.stack([out[0], out[1], torch.zeros_like(out[0])], dim=-1), inside


def contact_forces(
    params: ContactParams,
    height_fn: HeightFn,
    pos: torch.Tensor,          # (..., P, 3) world sphere centers
    vel: torch.Tensor,          # (..., P, 3) world point velocities
    radius: torch.Tensor,       # (P,)
    friction: torch.Tensor,     # (...,) per-env friction coefficient
    restitution: torch.Tensor,  # (...,) per-env restitution in [0, 1]
    dt: float,
    anchor: torch.Tensor = None,   # (..., P, 3) stick-friction anchors (world)
    ground_query=None,             # (x, y) -> (..., 9) riser channels (trimesh)
):
    """World-frame contact force (..., P, 3) on each proxy sphere.

    With ``anchor``, tangential friction is a spring to a per-point anchor
    that slips along the Coulomb cone, and ``(force, new_anchor)`` is
    returned; without it, friction is the capped-viscous law and the force
    alone is returned. With ``ground_query`` (trimesh) the tread height and
    normal come from the riser-aware channels and the riser faces push
    back (:func:`wall_forces`)."""
    if ground_query is not None:
        ch = ground_query(pos[..., 0], pos[..., 1])
        h = ch[..., 0] + ch[..., 1] * pos[..., 0] + ch[..., 2] * pos[..., 1]
        nv = torch.stack([-ch[..., 1], -ch[..., 2], torch.ones_like(h)], dim=-1)
        n = nv / torch.linalg.vector_norm(nv, dim=-1, keepdim=True)
        walls = ch[..., 3:]
    else:
        h = height_fn(pos[..., 0], pos[..., 1])
        n = ground_normal(height_fn, pos[..., 0], pos[..., 1])
        walls = None

    # deep-penetration clamp (PhysX: max_depenetration_velocity)
    depth = torch.clamp(h - (pos[..., 2] - radius), max=0.5)
    active = depth > 0.0

    v_n = torch.sum(vel * n, dim=-1)
    v_t = vel - v_n[..., None] * n

    imp_cap = params.point_mass / dt  # the largest stable viscous coefficient
    zeta = params.damping_ratio * torch.clamp(1.0 - restitution, 0.05, 1.0)
    d_n = torch.clamp(2.0 * zeta * float(np.sqrt(params.stiffness * params.point_mass)), max=imp_cap)[..., None]
    f_n = torch.clamp(params.stiffness * depth - d_n * v_n, min=0.0)
    f_n = torch.where(active, f_n, 0.0)
    if walls is not None:
        f_wall, inside_wall = wall_forces(params, pos, vel, radius, walls, d_n)
        # a center inside a riser solid resolves horizontally, not up
        # through the high tread
        f_n = torch.where(inside_wall, 0.0, f_n)

    cone = friction[..., None] * f_n
    use_anchor = anchor is not None and params.tangent_stiffness > 0.0
    if use_anchor:
        # a spring to the anchor (in the tangent plane) with stabilizing
        # damping; the error clamp re-anchors across teleporting resets
        err = torch.clamp(pos - anchor, -0.1, 0.1)
        err = err - torch.sum(err * n, dim=-1, keepdim=True) * n
        d_t = min(2.0 * float(np.sqrt(params.tangent_stiffness * params.point_mass)), imp_cap)
        f_t = -params.tangent_stiffness * err - d_t * v_t
        mag = torch.linalg.vector_norm(f_t, dim=-1)
        scale = torch.clamp(cone / torch.clamp(mag, min=1e-9), max=1.0)
        f_t = f_t * scale[..., None]
        # slipping points drag their anchor to the cone's edge; airborne
        # points re-anchor where they are
        new_anchor = pos + _div(f_t, params.tangent_stiffness)
        new_anchor = torch.where(active[..., None], new_anchor, pos)
        f_t = torch.where(active[..., None], f_t, 0.0)
    else:
        speed_t = torch.linalg.vector_norm(v_t, dim=-1)
        k_t = torch.clamp(cone / torch.clamp(speed_t, min=params.slip_velocity), max=imp_cap)
        f_t = -k_t[..., None] * v_t

    force = f_n[..., None] * n + f_t
    if walls is not None:
        force = force + f_wall
    if use_anchor:
        return force, new_anchor
    return force


@functools.lru_cache(maxsize=None)
def _incidence(pairs_i: Tuple[int, ...], pairs_j: Tuple[int, ...], num_points: int):
    """Static padded incidence table of the pairs: per point, the slots of
    its pairs (``len(pairs)`` = the zero row) and their signs."""
    k = len(pairs_i)
    incidence = [[] for _ in range(num_points)]
    for slot, (a, b) in enumerate(zip(pairs_i, pairs_j)):
        incidence[a].append((slot, 1.0))
        incidence[b].append((slot, -1.0))
    maxdeg = max(len(lst) for lst in incidence)
    slots = np.full((num_points, maxdeg), k, np.int64)
    signs = np.zeros((num_points, maxdeg), np.float32)
    for p, lst in enumerate(incidence):
        for col, (slot, sign) in enumerate(lst):
            slots[p, col] = slot
            signs[p, col] = sign
    return (torch.as_tensor(pairs_i, dtype=torch.int64), torch.as_tensor(pairs_j, dtype=torch.int64),
            torch.from_numpy(slots), torch.from_numpy(signs))


def self_collision_forces(
    params: ContactParams,
    pos: torch.Tensor,       # (..., P, 3) world sphere centers
    vel: torch.Tensor,       # (..., P, 3) world sphere velocities
    radius: torch.Tensor,    # (P,)
    pairs_i,                 # static tuple of point indices
    pairs_j,                 # static tuple of point indices
    dt: float,
) -> torch.Tensor:
    """Sphere-sphere self-collision penalty forces summed per point (..., P,
    3), over a static candidate pair list (different limbs, separated at
    the default pose). Each point's pair forces are summed through a static
    padded incidence table (a gather, no scatter)."""
    if not pairs_i:
        return torch.zeros_like(pos)
    ii, jj, slots, signs = _incidence(tuple(pairs_i), tuple(pairs_j), pos.shape[-2])
    ii, jj, slots = (model_const(t, pos, torch.int64) for t in (ii, jj, slots))
    d = pos[..., ii, :] - pos[..., jj, :]                    # (..., K, 3)
    dist = torch.linalg.vector_norm(d, dim=-1)
    n = d / torch.clamp(dist, min=1e-6)[..., None]
    pen = (radius[ii] + radius[jj]) - dist
    active = pen > 0.0

    rel_v = vel[..., ii, :] - vel[..., jj, :]
    v_n = torch.sum(rel_v * n, dim=-1)
    imp_cap = params.point_mass / dt
    k_self = params.self_collision_stiffness
    d_n = min(2.0 * params.damping_ratio * float(np.sqrt(k_self * params.point_mass)), imp_cap)
    f_mag = torch.clamp(k_self * torch.clamp(pen, max=0.1) - d_n * v_n, min=0.0)
    f = torch.where(active, f_mag, 0.0)[..., None] * n      # on point i (+n), on j (-n)

    f_pad = torch.cat([f, torch.zeros_like(f[..., :1, :])], dim=-2)   # (..., K+1, 3)
    return torch.sum(model_const(signs, pos)[..., None] * f_pad[..., slots, :], dim=-2)


def body_wrenches(
    num_bodies: int,
    point_body: Tuple[int, ...],
    point_pos_rel: torch.Tensor,   # (..., P, 3) relative to the reference origin
    point_force: torch.Tensor,     # (..., P, 3)
) -> torch.Tensor:
    """Per-body spatial wrenches (..., B, 6) at the reference origin: each
    body's points summed in a fixed order over static index lists (a body
    whose points are not contiguous gathers them through a cached device
    index, never a Python list, whose host copy a CUDA graph's capture
    refuses)."""
    tau = _cross(point_pos_rel, point_force)
    wrench_p = torch.cat([tau, point_force], dim=-1)        # (..., P, 6)
    zero = wrench_p.new_zeros(wrench_p.shape[:-2] + (6,))
    per_body = []
    for b in range(num_bodies):
        idx = [p for p, pb in enumerate(point_body) if pb == b]
        if not idx:
            per_body.append(zero)
        elif len(idx) == 1:
            per_body.append(wrench_p[..., idx[0], :])
        elif idx == list(range(idx[0], idx[-1] + 1)):
            per_body.append(torch.sum(wrench_p[..., idx[0]: idx[-1] + 1, :], dim=-2))
        else:
            rows = model_const(static_index(tuple(idx)), wrench_p, torch.int64)
            per_body.append(torch.sum(wrench_p[..., rows, :], dim=-2))
    return torch.stack(per_body, dim=-2)                     # (..., B, 6)
