"""Contact constants (port of ``wiki_grx_gym_tpu/sim/contact.py:ContactParams``).

Only the container is ported in slice 1: the force law itself lives in the
lane program (``sim/scalarized.py``) and in K1. The batched contact path
(``contact_forces``, ``self_collision_forces``) waits for ROADMAP queue 1
item 9."""

from __future__ import annotations

import dataclasses


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
