"""6D spatial-vector algebra (Featherstone), angular-first convention.

Port of ``wiki_grx_gym_tpu/sim/spatial.py``. All spatial quantities of an
env live in one shared frame: world-aligned axes with the origin at the
robot's current base position. A motion vector (twist) is ``[w; v]`` with
``v`` the linear velocity of the body-fixed point at the reference origin;
a force vector (wrench) is ``[tau; f]`` with ``tau`` the moment about the
reference origin. Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

from wiki_grx_gym_tpu_torch.utils.maths import _cross, skew


def motion_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product ``a x b`` for twists (..., 6)."""
    aw, av = a[..., :3], a[..., 3:]
    bw, bv = b[..., :3], b[..., 3:]
    return torch.cat([_cross(aw, bw), _cross(aw, bv) + _cross(av, bw)], dim=-1)


def force_cross(a: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product ``a x* f`` (twist a, wrench f)."""
    aw, av = a[..., :3], a[..., 3:]
    ft, ff = f[..., :3], f[..., 3:]
    return torch.cat([_cross(aw, ft) + _cross(av, ff), _cross(aw, ff)], dim=-1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor, inertia_com: torch.Tensor) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) at the reference origin from the mass
    (...,), the com (..., 3) relative to the origin and the rotational
    inertia about the com (..., 3, 3), all in reference axes:
    ``I = [[I_c - m cx cx, m cx], [-m cx, m E]]`` with ``cx = skew(com)``."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([inertia_com - m * (cx @ cx), m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def wrench_at(point: torch.Tensor, force: torch.Tensor, torque: torch.Tensor = None) -> torch.Tensor:
    """Wrench (..., 6) at the reference origin of a force applied at
    ``point`` (relative to the origin)."""
    tau = _cross(point, force)
    if torque is not None:
        tau = tau + torque
    return torch.cat([tau, force], dim=-1)


def revolute_subspace(axis_world: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """Motion subspace S (..., 6) of a revolute joint: world-axes ``axis``
    through ``anchor`` (relative to the reference origin)."""
    return torch.cat([axis_world, _cross(anchor, axis_world)], dim=-1)


def twist_kinetic_energy(inertia6: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """0.5 v^T I v (the energy checks)."""
    return 0.5 * torch.einsum("...i,...ij,...j->...", twist, inertia6, twist)
