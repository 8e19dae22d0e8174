"""MJCF (MuJoCo XML) parser (port of ``wiki_grx_gym_tpu/models/mjcf.py``).

Produces the same intermediate as the URDF parser (``models/urdf.py``), so
``compile_robot`` serves both formats. The supported subset, as in the JAX
package, maps onto the floating-base, revolute-joint model:

- ``<compiler angle="degree|radian">`` (MJCF defaults to degrees) and
  ``eulerseq`` "xyz";
- nested ``<body pos quat euler childclass>`` under ``<worldbody>``; the
  single top-level body is the floating base;
- ``<joint type="hinge">`` (a ``<freejoint>`` or ``type="free"`` on the base
  is implicit) with ``axis``, ``pos`` (the anchor: the child frame is
  shifted so that it rotates about its origin, as in URDF), ``range`` and
  ``limited``; per-joint armature and damping are ignored in favour of the
  asset-level armature;
- ``<inertial pos quat mass diaginertia|fullinertia>`` (massive bodies need
  an explicit inertial);
- ``<geom type="sphere|capsule|cylinder|box" size pos quat euler fromto>``
  become the URDF path's proxy spheres (MJCF sizes are half-extents);
- ``<default>`` classes (nested, with ``class``/``childclass`` resolution)
  for joint and geom attributes.

Other joints (``slide``, ``ball``) raise NotImplementedError.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from wiki_grx_gym_tpu_torch.models.urdf import (
    Transform,
    Urdf,
    UrdfGeom,
    UrdfJoint,
    UrdfLink,
    _quat_from_rpy,
    _quat_mul,
    _quat_to_mat,
)


def _f3(s: Optional[str], default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if not s:
        return np.asarray(default, np.float64)
    return np.asarray([float(v) for v in s.split()], np.float64)


def _body_tf(elem, angle_scale: float) -> Transform:
    """Frame transform from MJCF pos/quat/euler attributes."""
    pos = _f3(elem.get("pos"))
    if elem.get("quat"):
        w, x, y, z = (float(v) for v in elem.get("quat").split())
        quat = np.asarray([x, y, z, w], np.float64)  # MJCF is (w,x,y,z)
        quat = quat / np.linalg.norm(quat)
    elif elem.get("euler"):
        e = _f3(elem.get("euler")) * angle_scale
        quat = _quat_from_rpy(e)  # eulerseq "xyz" == URDF fixed-axis RPY
    else:
        quat = np.asarray([0.0, 0.0, 0.0, 1.0])
    return Transform(pos=pos, quat=quat)


class _Defaults:
    """MJCF <default> class tree: attribute lookup by (class, tag)."""

    def __init__(self, root: ET.Element):
        self.by_class: Dict[str, Dict[str, Dict[str, str]]] = {}
        top = root.find("default")
        if top is not None:
            self._walk(top, "main", {})

    def _walk(self, elem: ET.Element, cls: str, inherited: Dict[str, Dict[str, str]]):
        merged = {tag: dict(attrs) for tag, attrs in inherited.items()}
        for child in elem:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {}).update(child.attrib)
        self.by_class[cls] = merged
        for child in elem.findall("default"):
            self._walk(child, child.get("class", "main"), merged)

    def get(self, cls: str, tag: str, attrib: Dict[str, str]) -> Dict[str, str]:
        out = dict(self.by_class.get(cls, {}).get(tag, {}))
        out.update(attrib)
        return out


def parse_mjcf(source: str) -> Urdf:
    """Parse an MJCF file path or XML string into the URDF intermediate."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()
    assert root.tag == "mujoco", f"not an MJCF document (root <{root.tag}>)"

    comp = root.find("compiler")
    angle_scale = 1.0
    if comp is None or comp.get("angle", "degree") == "degree":
        angle_scale = np.pi / 180.0
    if comp is not None and comp.get("eulerseq", "xyz") != "xyz":
        raise NotImplementedError("MJCF eulerseq other than 'xyz'")

    defaults = _Defaults(root)
    world = root.find("worldbody")
    assert world is not None, "MJCF has no <worldbody>"
    top_bodies = world.findall("body")
    if len(top_bodies) != 1:
        raise ValueError(
            f"expected exactly one top-level <body> (the floating base), got {len(top_bodies)}"
        )

    links: Dict[str, UrdfLink] = {}
    joints: List[UrdfJoint] = []
    counter = [0]

    def geom_to_urdf(gattrs: Dict[str, str], shift: np.ndarray) -> Optional[UrdfGeom]:
        gtype = gattrs.get("type", "sphere")
        size = [float(v) for v in gattrs.get("size", "0").split()]
        if gattrs.get("fromto"):
            ft = np.asarray([float(v) for v in gattrs["fromto"].split()])
            a, b = ft[:3] - shift, ft[3:] - shift
            mid = 0.5 * (a + b)
            d = b - a
            length = float(np.linalg.norm(d))
            if length < 1e-12:
                quat = np.asarray([0.0, 0, 0, 1.0])
            else:
                dn = d / length
                # quat rotating +z onto dn
                zaxis = np.asarray([0.0, 0.0, 1.0])
                v = np.cross(zaxis, dn)
                c = float(np.dot(zaxis, dn))
                if np.linalg.norm(v) < 1e-12:
                    quat = (
                        np.asarray([0.0, 0, 0, 1.0]) if c > 0
                        else np.asarray([1.0, 0, 0, 0.0])
                    )
                else:
                    s = np.sqrt((1.0 + c) * 2.0)
                    quat = np.asarray([v[0] / s, v[1] / s, v[2] / s, s / 2.0])
                    quat = quat / np.linalg.norm(quat)
            tf = Transform(pos=mid, quat=quat)
        else:
            pos = _f3(gattrs.get("pos")) - shift
            if gattrs.get("quat"):
                w, x, y, z = (float(v) for v in gattrs["quat"].split())
                quat = np.asarray([x, y, z, w], np.float64)
            elif gattrs.get("euler"):
                e = np.asarray(
                    [float(v) for v in gattrs["euler"].split()]) * angle_scale
                quat = _quat_from_rpy(e)  # eulerseq "xyz" == fixed-axis RPY
            else:
                quat = np.asarray([0.0, 0, 0, 1.0])
            tf = Transform(pos=pos, quat=quat)
            length = 2.0 * size[1] if len(size) > 1 else 0.0

        if gtype == "sphere":
            return UrdfGeom("sphere", tf, {"radius": size[0]})
        if gtype in ("capsule", "cylinder"):
            return UrdfGeom("cylinder", tf, {"radius": size[0], "length": length})
        if gtype == "box":
            sx, sy, sz = (2.0 * s for s in size[:3])  # MJCF sizes are half-extents
            return UrdfGeom("box", tf, {"sx": sx, "sy": sy, "sz": sz})
        return None  # planes/meshes: no proxy spheres

    def walk(body: ET.Element, parent_link: Optional[str], cls: str):
        name = body.get("name") or f"body_{counter[0]}"
        counter[0] += 1
        cls = body.get("childclass", cls)
        tf = _body_tf(body, angle_scale)

        jels = body.findall("joint") + body.findall("freejoint")
        shift = np.zeros(3)
        joint_spec = None
        if parent_link is None:
            # base body: an explicit free joint is the implicit floating base
            for je in jels:
                jattrs = defaults.get(je.get("class", cls), "joint", je.attrib)
                jtype = "free" if je.tag == "freejoint" else jattrs.get("type", "hinge")
                if jtype != "free":
                    raise NotImplementedError(
                        "a movable joint on the base body (only free/none supported)"
                    )
        else:
            if len(jels) > 1:
                raise NotImplementedError(
                    f"body {name!r} has {len(jels)} joints; at most one hinge per body"
                )
            if jels:
                je = jels[0]
                jattrs = defaults.get(je.get("class", cls), "joint", je.attrib)
                jtype = "free" if je.tag == "freejoint" else jattrs.get("type", "hinge")
                if jtype != "hinge":
                    raise NotImplementedError(
                        f"MJCF joint type {jtype!r} (revolute/weld dynamics core)"
                    )
                jpos = _f3(jattrs.get("pos"))
                axis = _f3(jattrs.get("axis"), (0.0, 0.0, 1.0))
                limited = jattrs.get("limited", "auto")
                rng = jattrs.get("range")
                if rng and limited in ("true", "auto"):
                    lo, hi = (float(v) * angle_scale for v in rng.split())
                    kind = "revolute"
                else:
                    lo = hi = 0.0
                    kind = "continuous"
                # shift the child frame to the joint anchor so rotation is
                # about the frame origin (URDF convention)
                shift = jpos
                joint_spec = dict(
                    name=jattrs.get("name", name + "_joint"), kind=kind,
                    axis=axis, lower=lo, upper=hi,
                    effort=float(jattrs.get("actuatorfrcrange", "0 0").split()[-1])
                    if jattrs.get("actuatorfrcrange") else 0.0,
                )
            origin = Transform(
                pos=tf.pos + tf.rot() @ shift, quat=tf.quat
            )

        link = UrdfLink(name=name)
        inertial = body.find("inertial")
        if inertial is not None:
            link.mass = float(inertial.get("mass", "0"))
            ipos = _f3(inertial.get("pos")) - shift
            if inertial.get("quat"):
                w, x, y, z = (float(v) for v in inertial.get("quat").split())
                iquat = np.asarray([x, y, z, w], np.float64)
            else:
                iquat = np.asarray([0.0, 0, 0, 1.0])
            link.com_tf = Transform(pos=ipos, quat=iquat)
            if inertial.get("diaginertia"):
                dxx, dyy, dzz = (float(v) for v in inertial.get("diaginertia").split())
                link.inertia_diag6 = np.asarray([dxx, 0.0, 0.0, dyy, 0.0, dzz])
            elif inertial.get("fullinertia"):
                xx, yy, zz, xy, xz, yz = (
                    float(v) for v in inertial.get("fullinertia").split()
                )
                link.inertia_diag6 = np.asarray([xx, xy, xz, yy, yz, zz])

        for ge in body.findall("geom"):
            gattrs = defaults.get(ge.get("class", cls), "geom", ge.attrib)
            g = geom_to_urdf(gattrs, shift)
            if g is not None:
                link.collisions.append(g)
        links[name] = link

        if parent_link is not None:
            spec = joint_spec or dict(
                name=name + "_weld", kind="fixed",
                axis=np.asarray([1.0, 0, 0]), lower=0.0, upper=0.0, effort=0.0,
            )
            joints.append(
                UrdfJoint(
                    name=spec["name"], kind=spec["kind"], parent=parent_link,
                    child=name, origin=origin, axis=np.asarray(spec["axis"], np.float64),
                    lower=spec["lower"], upper=spec["upper"],
                    effort=spec.get("effort", 0.0), velocity=0.0,
                )
            )

        for sub in body.findall("body"):
            # grandchildren frames are relative to the (shifted) child frame
            if np.any(shift):
                sub_tf = _body_tf(sub, angle_scale)
                sub.set("pos", " ".join(str(v) for v in (sub_tf.pos - shift)))
                if not sub.get("quat") and sub.get("euler"):
                    pass  # euler preserved; only pos needed shifting
            walk(sub, name, cls)

    walk(top_bodies[0], None, "main")
    return Urdf(name=root.get("model", "robot"), links=links, joints=joints)
