"""URDF parser and robot compiler (port of ``wiki_grx_gym_tpu/models/urdf.py``).

Host code that runs once, when a robot is imported: the URDF (or, through
:func:`parse_robot_xml`, an MJCF document, ``models/mjcf.py``) is parsed
into a small intermediate (:class:`Urdf`) and compiled into the port's
:class:`RobotModel`. Every quantity is computed in numpy float64 and cast
to float32 at the end, in the JAX package's order, so each field equals
the JAX compiler's bit for bit.

Supported, as in the JAX package:

- revolute (and ``continuous``) joints become DOFs;
- fixed joints are welded into their moving ancestor (inertia composition:
  ``collapse_fixed_joints`` always on), while each original link's frame
  and its contact attribution are kept;
- joint limits (lower/upper/effort/velocity), and one armature for every
  DOF (the asset option ``armature``);
- collision geometry (sphere / cylinder / box) becomes contact proxy
  spheres; meshes give none.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from wiki_grx_gym_tpu_torch.models.robot import RobotModel

# ----------------------------------------------------------------------------
# host-side (numpy) quaternion helpers, (x, y, z, w) layout
# ----------------------------------------------------------------------------


def _quat_from_rpy(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis RPY (R = Rz(y) @ Ry(p) @ Rx(r)) → quat (x,y,z,w)."""
    r, p, y = rpy
    cy, sy = np.cos(y * 0.5), np.sin(y * 0.5)
    cr, sr = np.cos(r * 0.5), np.sin(r * 0.5)
    cp, sp = np.cos(p * 0.5), np.sin(p * 0.5)
    return np.array(
        [
            cy * sr * cp - sy * cr * sp,
            cy * cr * sp + sy * sr * cp,
            sy * cr * cp - cy * sr * sp,
            cy * cr * cp + sy * sr * sp,
        ]
    )


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class Transform:
    pos: np.ndarray
    quat: np.ndarray  # (x, y, z, w)

    @staticmethod
    def identity() -> "Transform":
        return Transform(np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))

    def compose(self, other: "Transform") -> "Transform":
        return Transform(
            self.pos + _quat_to_mat(self.quat) @ other.pos,
            _quat_mul(self.quat, other.quat),
        )

    def apply(self, p: np.ndarray) -> np.ndarray:
        return self.pos + _quat_to_mat(self.quat) @ p

    def rot(self) -> np.ndarray:
        return _quat_to_mat(self.quat)


def _xyz(elem: Optional[ET.Element], attr: str = "xyz") -> np.ndarray:
    if elem is None or elem.get(attr) is None:
        return np.zeros(3)
    return np.array([float(v) for v in elem.get(attr).split()])


def _origin(elem: Optional[ET.Element]) -> Transform:
    if elem is None:
        return Transform.identity()
    o = elem.find("origin")
    if o is None:
        return Transform.identity()
    return Transform(_xyz(o, "xyz"), _quat_from_rpy(_xyz(o, "rpy")))


# ----------------------------------------------------------------------------
# raw URDF structures
# ----------------------------------------------------------------------------


@dataclass
class UrdfGeom:
    kind: str                 # sphere | cylinder | box | mesh
    origin: Transform
    params: Dict[str, float] = field(default_factory=dict)


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com_tf: Transform = field(default_factory=Transform.identity)
    inertia_diag6: np.ndarray = field(default_factory=lambda: np.zeros(6))  # ixx ixy ixz iyy iyz izz
    collisions: List[UrdfGeom] = field(default_factory=list)

    def inertia_com(self) -> np.ndarray:
        """3x3 rotational inertia about the com, in link-frame axes."""
        ixx, ixy, ixz, iyy, iyz, izz = self.inertia_diag6
        i_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        r = self.com_tf.rot()
        return r @ i_local @ r.T


@dataclass
class UrdfJoint:
    name: str
    kind: str                 # revolute | continuous | fixed | prismatic ...
    parent: str
    child: str
    origin: Transform
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0


@dataclass
class Urdf:
    name: str
    links: Dict[str, UrdfLink]
    joints: List[UrdfJoint]

    def root_link(self) -> str:
        children = {j.child for j in self.joints}
        roots = [n for n in self.links if n not in children]
        if len(roots) != 1:
            raise ValueError(f"expected exactly one root link, got {roots}")
        return roots[0]


def parse_urdf(source: str) -> Urdf:
    """Parse a URDF from a file path or an XML string."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()

    links: Dict[str, UrdfLink] = {}
    for le in root.findall("link"):
        link = UrdfLink(name=le.get("name"))
        inertial = le.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            link.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            link.com_tf = _origin(inertial)
            ine = inertial.find("inertia")
            if ine is not None:
                link.inertia_diag6 = np.array(
                    [float(ine.get(k, "0")) for k in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")]
                )
        for ce in le.findall("collision"):
            g = ce.find("geometry")
            if g is None:
                continue
            tf = _origin(ce)
            for child in g:
                tag = child.tag.split("}")[-1]
                if tag == "sphere":
                    link.collisions.append(
                        UrdfGeom("sphere", tf, {"radius": float(child.get("radius"))})
                    )
                elif tag == "cylinder":
                    link.collisions.append(
                        UrdfGeom(
                            "cylinder",
                            tf,
                            {"radius": float(child.get("radius")), "length": float(child.get("length"))},
                        )
                    )
                elif tag == "box":
                    sx, sy, sz = (float(v) for v in child.get("size").split())
                    link.collisions.append(UrdfGeom("box", tf, {"sx": sx, "sy": sy, "sz": sz}))
                # meshes are visual-fidelity geometry; proxy spheres come from
                # the primitive shapes (the GRx URDFs use primitives for feet).
        links[link.name] = link

    joints: List[UrdfJoint] = []
    for je in root.findall("joint"):
        lim = je.find("limit")
        joints.append(
            UrdfJoint(
                name=je.get("name"),
                kind=je.get("type"),
                parent=je.find("parent").get("link"),
                child=je.find("child").get("link"),
                origin=_origin(je),
                axis=_xyz(je.find("axis")) if je.find("axis") is not None else np.array([1.0, 0, 0]),
                lower=float(lim.get("lower", "0")) if lim is not None else 0.0,
                upper=float(lim.get("upper", "0")) if lim is not None else 0.0,
                effort=float(lim.get("effort", "0")) if lim is not None else 0.0,
                velocity=float(lim.get("velocity", "0")) if lim is not None else 0.0,
            )
        )
    return Urdf(name=root.get("name", "robot"), links=links, joints=joints)


def parse_robot_xml(source: str) -> Urdf:
    """Format-dispatching robot parser: URDF (<robot>) or MJCF (<mujoco>)
    by root tag."""
    text = source if source.lstrip().startswith("<") else open(source).read()
    root_tag = ET.fromstring(text).tag
    if root_tag == "mujoco":
        from wiki_grx_gym_tpu_torch.models.mjcf import parse_mjcf

        return parse_mjcf(text)
    return parse_urdf(text)


# ----------------------------------------------------------------------------
# compiler: URDF → RobotModel
# ----------------------------------------------------------------------------


def _geom_points(geom: UrdfGeom) -> List[Tuple[np.ndarray, float]]:
    """Proxy-sphere decomposition of a collision primitive (center, radius)."""
    if geom.kind == "sphere":
        return [(geom.origin.pos.copy(), geom.params["radius"])]
    if geom.kind == "cylinder":
        r, half = geom.params["radius"], geom.params["length"] / 2.0
        ends = []
        for s in (-1.0, 1.0):
            ends.append((geom.origin.apply(np.array([0.0, 0.0, s * half])), r))
        return ends
    if geom.kind == "box":
        sx, sy, sz = geom.params["sx"], geom.params["sy"], geom.params["sz"]
        r = max(1e-3, 0.25 * min(sx, sy, sz))
        pts = []
        for ix in (-1.0, 1.0):
            for iy in (-1.0, 1.0):
                for iz in (-1.0, 1.0):
                    local = np.array(
                        [ix * (sx / 2 - r), iy * (sy / 2 - r), iz * (sz / 2 - r)]
                    )
                    pts.append((geom.origin.apply(local), r))
        return pts
    return []


def compile_robot(
    source: str,
    armature: float = 0.0,
    extra_points: Optional[Dict[str, List[Tuple[Tuple[float, float, float], float]]]] = None,
) -> RobotModel:
    """Compile a URDF into a :class:`RobotModel`.

    Args:
        source: URDF path or XML string.
        armature: rotor inertia added to every DOF (asset option
            `legged_robot_config.py:130`).
        extra_points: optional ``{link_name: [((x, y, z), radius), ...]}``
            additional contact proxies (e.g. for links whose collision shape
            is only a mesh).
    """
    urdf = parse_robot_xml(source)
    root = urdf.root_link()

    # joints by parent link, preserving document order (IsaacGym DOF order
    # follows asset traversal; for the GRx URDFs document order == traversal
    # order of each kinematic chain).
    by_parent: Dict[str, List[UrdfJoint]] = {}
    for j in urdf.joints:
        by_parent.setdefault(j.parent, []).append(j)

    movable_kinds = {"revolute", "continuous"}

    parent: List[int] = [-1]
    tree_pos: List[np.ndarray] = [np.zeros(3)]
    tree_quat: List[np.ndarray] = [np.array([0.0, 0, 0, 1.0])]
    axis: List[np.ndarray] = [np.zeros(3)]
    body_names: List[str] = [root]
    dof_names: List[str] = []
    limits: List[Tuple[float, float, float, float]] = []

    # per-moving-body accumulators: mass, first moment, inertia about body origin
    acc_mass: List[float] = []
    acc_moment: List[np.ndarray] = []
    acc_inertia0: List[np.ndarray] = []

    link_frames: List[Tuple[str, int, Tuple[float, ...], Tuple[float, ...]]] = []
    link_names: List[str] = []
    points: List[Tuple[int, np.ndarray, float, int]] = []  # (body, offset, radius, link_idx)

    def _ensure_body_slot():
        acc_mass.append(0.0)
        acc_moment.append(np.zeros(3))
        acc_inertia0.append(np.zeros((3, 3)))

    _ensure_body_slot()

    def _absorb_link(body: int, tf: Transform, link: UrdfLink):
        """Add link inertia (at ``tf`` within the body frame) to body ``body``."""
        link_idx = len(link_names)
        link_names.append(link.name)
        link_frames.append((link.name, body, tuple(tf.pos), tuple(tf.quat)))
        if link.mass > 0.0:
            com_b = tf.apply(link.com_tf.pos)
            rot = tf.rot()
            i_com_b = rot @ link.inertia_com() @ rot.T
            cx = _skew(com_b)
            acc_mass[body] += link.mass
            acc_moment[body] += link.mass * com_b
            acc_inertia0[body] += i_com_b - link.mass * (cx @ cx)
        for geom in link.collisions:
            for center_local, radius in _geom_points(geom):
                points.append((body, tf.apply(center_local), radius, link_idx))
        if extra_points and link.name in extra_points:
            for center, radius in extra_points[link.name]:
                points.append((body, tf.apply(np.array(center)), radius, link_idx))

    # Assign DOF indices in *document order* of movable joints (worklist until
    # all joints resolve). For the GRx URDFs this yields left-leg chain then
    # right-leg chain — the order the reference's positional action/obs
    # layouts assume (`gr1t1_lower_limb_config.py:83-90`). Parents resolve
    # before children, so body indexing stays topological.
    link_body: Dict[str, Tuple[int, Transform]] = {root: (0, Transform.identity())}
    pending: List[UrdfJoint] = list(urdf.joints)
    while pending:
        progressed = False
        remaining: List[UrdfJoint] = []
        for j in pending:
            if j.parent not in link_body or j.child in link_body:
                remaining.append(j)
                continue
            progressed = True
            body, tf = link_body[j.parent]
            child_tf = tf.compose(j.origin)
            if j.kind in movable_kinds:
                new_body = len(body_names)
                parent.append(body)
                tree_pos.append(child_tf.pos)
                tree_quat.append(child_tf.quat)
                axis.append(j.axis / max(np.linalg.norm(j.axis), 1e-9))
                body_names.append(j.child)
                dof_names.append(j.name)
                limits.append((j.lower, j.upper, j.velocity, j.effort))
                _ensure_body_slot()
                link_body[j.child] = (new_body, Transform.identity())
            elif j.kind == "fixed":
                link_body[j.child] = (body, child_tf)
            else:
                raise NotImplementedError(f"joint type {j.kind!r} ({j.name})")
        if not progressed:
            raise ValueError(f"unresolvable joints: {[j.name for j in remaining]}")
        pending = remaining

    # absorb inertias / collision proxies in URDF link document order
    for lname, link in urdf.links.items():
        if lname in link_body:
            body, tf = link_body[lname]
            _absorb_link(body, tf, link)

    nb = len(body_names)
    mass = np.array(acc_mass)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for b in range(nb):
        if mass[b] > 0.0:
            com[b] = acc_moment[b] / mass[b]
            cx = _skew(com[b])
            inertia[b] = acc_inertia0[b] + mass[b] * (cx @ cx)
        else:
            inertia[b] = np.eye(3) * 1e-6

    nd = nb - 1
    lim = np.array(limits) if limits else np.zeros((0, 4))
    num_p = len(points)

    return RobotModel(
        tree_pos=_f32(np.stack(tree_pos)),
        tree_quat=_f32(np.stack(tree_quat)),
        axis=_f32(np.stack(axis)),
        mass=_f32(mass),
        com=_f32(com),
        inertia=_f32(inertia),
        armature=torch.full((nd,), armature, dtype=torch.float32),
        dof_lower=_f32(lim[:, 0]),
        dof_upper=_f32(lim[:, 1]),
        dof_vel_limit=_f32(lim[:, 2]),
        dof_effort_limit=_f32(lim[:, 3]),
        point_offset=_f32(np.stack([p[1] for p in points]) if num_p else np.zeros((0, 3))),
        point_radius=_f32(np.array([p[2] for p in points], dtype=np.float32)),
        parent=tuple(parent),
        point_body=tuple(int(p[0]) for p in points),
        point_link=tuple(int(p[3]) for p in points),
        name=urdf.name,
        body_names=tuple(body_names),
        dof_names=tuple(dof_names),
        link_names=tuple(link_names),
        link_frames=tuple(link_frames),
    )


def _f32(a: np.ndarray) -> torch.Tensor:
    """numpy float64 (or float32) -> a float32 CPU tensor, each value
    rounded once to the nearest float32, as the JAX compiler's cast does."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32)))


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
