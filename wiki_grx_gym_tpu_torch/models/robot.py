"""Static robot description, compiled once on the host.

Port of ``wiki_grx_gym_tpu/models/robot.py``: the same fields and name
resolution, with the arrays held as float32 CPU tensors. The model is read
at env build time (gains, contact groups, kernel constants); nothing on the
hot path touches it except through those constants.

Conventions (unchanged): moving bodies are topologically ordered, body 0 is
the floating base, and body ``i > 0`` hangs from ``parent[i]`` by revolute
DOF ``i - 1``. Contact proxy spheres remember the original link they came
from (``point_link``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

ARRAY_FIELDS = (
    "tree_pos",
    "tree_quat",
    "axis",
    "mass",
    "com",
    "inertia",
    "armature",
    "dof_lower",
    "dof_upper",
    "dof_vel_limit",
    "dof_effort_limit",
    "point_offset",
    "point_radius",
)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    # --- joint geometry ---
    tree_pos: torch.Tensor        # (B, 3) parent-frame position of the joint frame at q=0
    tree_quat: torch.Tensor       # (B, 4) parent-frame orientation (x, y, z, w) at q=0
    axis: torch.Tensor            # (B, 3) revolute axis in the body frame (row 0 unused)
    # --- per-body inertial parameters (body frame) ---
    mass: torch.Tensor            # (B,)
    com: torch.Tensor             # (B, 3)
    inertia: torch.Tensor         # (B, 3, 3) about the com
    # --- per-DOF parameters (D = B - 1) ---
    armature: torch.Tensor        # (D,)
    dof_lower: torch.Tensor       # (D,)
    dof_upper: torch.Tensor       # (D,)
    dof_vel_limit: torch.Tensor   # (D,)
    dof_effort_limit: torch.Tensor  # (D,)
    # --- contact proxy spheres ---
    point_offset: torch.Tensor    # (P, 3) body-frame offset of the sphere center
    point_radius: torch.Tensor    # (P,)
    # --- static topology ---
    parent: Tuple[int, ...] = ()
    point_body: Tuple[int, ...] = ()
    point_link: Tuple[int, ...] = ()
    # asset option disable_gravity: 0.0 turns gravity off for the articulation
    gravity_scale: float = 1.0
    name: str = ""
    body_names: Tuple[str, ...] = ()
    dof_names: Tuple[str, ...] = ()
    link_names: Tuple[str, ...] = ()
    # link_name -> (moving body idx, offset xyz, offset quat xyzw)
    link_frames: Tuple[Tuple[str, int, Tuple[float, ...], Tuple[float, ...]], ...] = ()

    def replace(self, **kw) -> "RobotModel":
        return dataclasses.replace(self, **kw)

    @property
    def num_bodies(self) -> int:
        return len(self.parent)

    @property
    def num_dof(self) -> int:
        return len(self.parent) - 1

    @property
    def num_points(self) -> int:
        return len(self.point_body)

    def ancestors(self, body: int) -> Tuple[int, ...]:
        """Chain of ancestor bodies of ``body`` (without the base, with
        ``body`` itself if > 0), root-most first."""
        chain = []
        b = body
        while b > 0:
            chain.append(b)
            b = self.parent[b]
        return tuple(reversed(chain))

    # ---- name resolution (host side, build time only) ----

    def link_frame(self, link_name: str) -> Tuple[int, torch.Tensor, torch.Tensor]:
        """(moving body index, body-frame offset pos, quat) of an original link."""
        for name, body, pos, quat in self.link_frames:
            if name == link_name:
                return (
                    body,
                    torch.tensor(pos, dtype=torch.float32),
                    torch.tensor(quat, dtype=torch.float32),
                )
        raise KeyError(f"unknown link {link_name!r}")

    def find_links(self, substring: str) -> Tuple[str, ...]:
        """All original link names containing ``substring``."""
        return tuple(n for n in self.link_names if substring in n)

    def find_dofs(self, substring: str) -> Tuple[int, ...]:
        """DOF indices whose joint name contains ``substring``."""
        return tuple(i for i, n in enumerate(self.dof_names) if substring in n)

    def link_point_mask(self, link_names, device=None) -> torch.Tensor:
        """(P,) float32 mask on ``device`` of the contact points belonging to
        any of the links."""
        idx = {self.link_names.index(n) for n in link_names}
        return torch.tensor([1.0 if l in idx else 0.0 for l in self.point_link],
                            dtype=torch.float32, device=device)

    def summary(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "num_bodies": self.num_bodies,
            "num_dof": self.num_dof,
            "num_points": self.num_points,
            "total_mass": float(torch.sum(self.mass)),
            "dof_names": list(self.dof_names),
        }
