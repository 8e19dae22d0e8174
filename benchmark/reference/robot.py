"""The robot as the plain reference reads it: the static model from its
raw description (``benchmark/reference/models/<asset>.json``, the spec the
configuration's ``asset`` names), the contact constants, quaternion maths
in (x, y, z, w) layout and forward kinematics at a given pose.

The model's fields and conventions are the robot spec's: moving bodies are
topologically ordered, body 0 is the floating base, and body ``i > 0``
hangs from ``parent[i]`` by revolute DOF ``i - 1``. Contact proxy spheres
remember the original link they came from (``point_link``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

MODELS = Path(__file__).resolve().parent / "models"
ARRAY_FIELDS = ("tree_pos", "tree_quat", "axis", "mass", "com", "inertia", "armature", "dof_lower",
                "dof_upper", "dof_vel_limit", "dof_effort_limit", "point_offset", "point_radius")
STATIC_FIELDS = ("parent", "point_body", "point_link", "name", "body_names", "dof_names", "link_names",
                 "link_frames")
_EPS = 1e-9


def _div(a, c: float):
    """``a / c`` for a Python float ``c`` as a true division on every device
    (a 0-d tensor divisor: CUDA would multiply by the float32 reciprocal)."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_apply(torch.cat([-q[..., :3], q[..., 3:4]], dim=-1), v)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    axis = normalize(axis)
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


@dataclasses.dataclass(frozen=True)
class RobotModel:
    tree_pos: torch.Tensor        # (B, 3) parent-frame position of the joint frame at q=0
    tree_quat: torch.Tensor       # (B, 4) parent-frame orientation at q=0
    axis: torch.Tensor            # (B, 3) revolute axis in the body frame (row 0 unused)
    mass: torch.Tensor            # (B,)
    com: torch.Tensor             # (B, 3)
    inertia: torch.Tensor         # (B, 3, 3) about the com
    armature: torch.Tensor        # (D,)
    dof_lower: torch.Tensor       # (D,)
    dof_upper: torch.Tensor       # (D,)
    dof_vel_limit: torch.Tensor   # (D,)
    dof_effort_limit: torch.Tensor  # (D,)
    point_offset: torch.Tensor    # (P, 3) body-frame offset of each contact sphere's center
    point_radius: torch.Tensor    # (P,)
    parent: Tuple[int, ...] = ()
    point_body: Tuple[int, ...] = ()
    point_link: Tuple[int, ...] = ()
    gravity_scale: float = 1.0
    name: str = ""
    body_names: Tuple[str, ...] = ()
    dof_names: Tuple[str, ...] = ()
    link_names: Tuple[str, ...] = ()
    # link_name -> (moving body idx, offset xyz, offset quat xyzw)
    link_frames: Tuple[Tuple[str, int, Tuple[float, ...], Tuple[float, ...]], ...] = ()

    @property
    def num_bodies(self) -> int:
        return len(self.parent)

    @property
    def num_dof(self) -> int:
        return len(self.parent) - 1

    @property
    def num_points(self) -> int:
        return len(self.point_body)

    def link_frame(self, link_name: str):
        """(moving body index, body-frame offset pos, quat) of an original link."""
        for name, body, pos, quat in self.link_frames:
            if name == link_name:
                return body, torch.tensor(pos, dtype=torch.float32), torch.tensor(quat, dtype=torch.float32)
        raise KeyError(f"unknown link {link_name!r}")

    def find_links(self, substring: str) -> Tuple[str, ...]:
        return tuple(n for n in self.link_names if substring in n)

    def find_dofs(self, substring: str) -> Tuple[int, ...]:
        return tuple(i for i, n in enumerate(self.dof_names) if substring in n)


def _tuplify(x):
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


def load_model(asset: str) -> RobotModel:
    """The robot spec ``benchmark/reference/models/<asset>.json``."""
    with open(MODELS / f"{asset}.json") as f:
        blob = json.load(f)
    kw = {k: torch.from_numpy(np.asarray(blob[k], dtype=np.float32)) for k in ARRAY_FIELDS}
    kw.update({k: _tuplify(blob[k]) for k in STATIC_FIELDS})
    return RobotModel(**kw)


@dataclasses.dataclass(frozen=True)
class ContactParams:
    """The contact model's material and solver constants."""

    stiffness: float = 1.0e4
    damping_ratio: float = 0.7
    point_mass: float = 0.25
    slip_velocity: float = 1e-5
    tangent_stiffness: float = 1.0e4
    joint_limit_violation: float = 0.05
    self_collision_stiffness: float = 1.0e5

    def replace(self, **kw) -> "ContactParams":
        return dataclasses.replace(self, **kw)


def body_poses(model: RobotModel, q: torch.Tensor):
    """(quat (B, 4), position relative to the base origin (B, 3)) of every
    body with the base at the identity and the joints at ``q`` (D,)."""
    quats = [torch.tensor([0.0, 0.0, 0.0, 1.0])]
    pos_rel = [torch.zeros(3)]
    for i in range(1, model.num_bodies):
        p = model.parent[i]
        q_static = quat_mul(quats[p], model.tree_quat[i])
        quats.append(quat_mul(q_static, quat_from_angle_axis(q[i - 1], model.axis[i])))
        pos_rel.append(pos_rel[p] + quat_apply(quats[p], model.tree_pos[i]))
    return torch.stack(quats), torch.stack(pos_rel)
