"""K1's plain program, frozen: a copy of the port's component-form
("scalarized") physics program, ``ScalarSubstep`` and ``ScalarDecimation``,
which K1 (``csrc/decimation.cu``) computes per env.

Every scalar quantity (a quaternion component, one entry of the mass
matrix, ...) is a lane: a tensor whose shape is the env batch ``(N,)``.
Model constants are Python floats folded in float64 on the host. The
statements, their order and the association of every sum are the port's as
it stood when the benchmark was written, so the program agrees with K1 to
rounding; a later change to K1 does not change this copy.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.robot import ContactParams, RobotModel, _div

_MAX_LIN_VEL = 100.0
_MAX_ANG_VEL = 100.0
_MAX_DOF_VEL = 100.0
_RIDGE = 1e-6
_GRAV = -9.81
# input lanes of ground a contact point reads, per terrain mode
PLANE_LANES = {"plane": 0, "local_plane": 3, "local_plane_walls": 9}
# the control laws (cfg.control.control_type) and their codes in
# csrc/decimation.cu (K1_CTRL)
CONTROL_TYPES = {"P": 0, "V": 1, "T": 2}


# ---------------------------------------------------------------------------
# lane-algebra helpers: vectors are length-3 lists, quats length-4 (x,y,z,w);
# elements are tensors of a shared shape or Python floats
# ---------------------------------------------------------------------------


def _maximum(a, b):
    """``jnp.maximum`` on lanes and Python floats (NaN propagates)."""
    if isinstance(b, (int, float)):
        return torch.clamp(a, min=b)
    if isinstance(a, (int, float)):
        return torch.clamp(b, min=a)
    return torch.maximum(a, b)


def _minimum(a, b):
    """``jnp.minimum`` on lanes and Python floats (NaN propagates)."""
    if isinstance(b, (int, float)):
        return torch.clamp(a, max=b)
    if isinstance(a, (int, float)):
        return torch.clamp(b, max=a)
    return torch.minimum(a, b)


def _cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _add(a, b):
    return [a[i] + b[i] for i in range(len(a))]


def _sub(a, b):
    return [a[i] - b[i] for i in range(len(a))]


def _scale(a, s):
    return [a[i] * s for i in range(len(a))]


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ]


def _qapply(q, v):
    """maths.quat_apply: v + w*t + q_xyz x t with t = 2 q_xyz x v."""
    xyz = q[:3]
    t = _scale(_cross(xyz, v), 2.0)
    return _add(_add(v, _scale(t, q[3])), _cross(xyz, t))


def _q_from_angle_axis(angle, axis_unit):
    half = 0.5 * angle
    s = torch.sin(half)
    return [axis_unit[0] * s, axis_unit[1] * s, axis_unit[2] * s, torch.cos(half)]


def _q_to_rotmat(q):
    qx, qy, qz, qw = q
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [
        [1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)],
    ]


def _m3_vec(m, v):
    return [m[r][0] * v[0] + m[r][1] * v[1] + m[r][2] * v[2] for r in range(3)]


def _m3_sandwich_const(r, i_const):
    """R I R^T with I a constant 3x3 (numpy); returns 3x3 lane matrix."""
    b = [[sum(r[a][k] * float(i_const[k, c]) for k in range(3)) for c in range(3)]
         for a in range(3)]
    return [[sum(b[a][k] * r[c][k] for k in range(3)) for c in range(3)] for a in range(3)]


def _clip(x, lo, hi):
    return _minimum(_maximum(x, lo), hi)


# ---------------------------------------------------------------------------


class ScalarSubstep:
    """One physics substep in component form, bound to a static model.

    State dict lanes: ``pos`` [3], ``quat`` [4], ``lin`` [3], ``ang`` [3],
    ``q`` [D], ``qd`` [D], ``anchor`` [P][3].
    DR lanes: per-env ``friction``, ``restitution``, ``mass_scale``,
    ``com_offset`` [3] (``engine.BodyRandomization``)."""

    def __init__(
        self,
        model: RobotModel,
        contact: ContactParams,
        dt: float,
        self_pairs=((), ()),
        ground_height: float = 0.0,
        terrain_mode: str = "plane",
    ):
        self.model = model
        self.contact = contact
        self.dt = float(dt)
        self.self_pairs = tuple(zip(*self_pairs)) if self_pairs[0] else ()
        self.ground_height = float(ground_height)
        # "plane": flat ground at ground_height, normal +z. "local_plane": a
        # ground plane per contact point, lanes (c, gx, gy) in
        # state["plane"], h(x, y) = c + gx x + gy y, sampled from the
        # heightfield once a policy step outside the kernel.
        # "local_plane_walls": 9 lanes a point, the tread plane and up to
        # one riser face per axis (trimesh; terrain/composer.riser_channels).
        if terrain_mode not in PLANE_LANES:
            raise ValueError(f"unknown terrain_mode {terrain_mode!r}")
        self.terrain_mode = terrain_mode
        self.plane_lanes = PLANE_LANES[terrain_mode]

        m = model
        self.nb = m.num_bodies
        self.nd = m.num_dof
        self.np_ = m.num_points
        f = lambda a: np.asarray(a, np.float64)
        self.parent = tuple(int(p) for p in m.parent)
        self.tree_pos = f(m.tree_pos)
        self.tree_quat = f(m.tree_quat)
        self.axis = f(m.axis)
        axn = self.axis / np.maximum(
            np.linalg.norm(self.axis, axis=-1, keepdims=True), 1e-9
        )
        self.axis_unit = axn
        self.mass = f(m.mass)
        self.com = f(m.com)
        self.inertia = f(m.inertia)
        self.armature = f(m.armature)
        self.point_body = tuple(int(b) for b in m.point_body)
        self.point_offset = f(m.point_offset)
        self.point_radius = f(m.point_radius)
        self.dof_lower = f(m.dof_lower)
        self.dof_upper = f(m.dof_upper)
        self.dof_effort = f(m.dof_effort_limit)

        # ancestor-or-self mask over dofs
        d = self.nd
        anc = np.zeros((d, d), bool)
        for i in range(d):
            b = i + 1
            while b > 0:
                anc[i, b - 1] = True
                b = self.parent[b]
        self.ancestor = anc

    # -- forward kinematics -------------------------------------------------

    def fk(self, state):
        quats = [state["quat"]]
        pos_rel = [[0.0, 0.0, 0.0]]
        subspace = [None]
        twists = [state["ang"] + state["lin"]]  # 6 lanes [w; v]
        for i in range(1, self.nb):
            p = self.parent[i]
            dref = i - 1
            q_static = _qmul(quats[p], [float(c) for c in self.tree_quat[i]])
            q_joint = _q_from_angle_axis(
                state["q"][dref], [float(c) for c in self.axis_unit[i]]
            )
            quats.append(_qmul(q_static, q_joint))
            pos_rel.append(
                _add(pos_rel[p], _qapply(quats[p], [float(c) for c in self.tree_pos[i]]))
            )
            a_w = _qapply(quats[i], [float(c) for c in self.axis[i]])
            s = a_w + _cross(pos_rel[i], a_w)
            subspace.append(s)
            qd = state["qd"][dref]
            twists.append([twists[p][k] + s[k] * qd for k in range(6)])
        return quats, pos_rel, subspace, twists

    # -- contact (flat ground + self-collision) -----------------------------

    def contact_forces(self, state, quats, pos_rel, twists):
        """Returns (point world pos [P][3], forces [P][3], new anchors)."""
        c = self.contact
        dt = self.dt
        imp_cap = c.point_mass / dt
        mu = state["friction"]
        zeta = c.damping_ratio * _clip(1.0 - state["restitution"], 0.05, 1.0)
        d_n = _minimum(2.0 * zeta * math.sqrt(c.stiffness * c.point_mass), imp_cap)
        h0 = self.ground_height

        pts_pos, pts_vel, forces, anchors = [], [], [], []
        for p in range(self.np_):
            b = self.point_body[p]
            off = [float(x) for x in self.point_offset[p]]
            rel = _add(pos_rel[b], _qapply(quats[b], off))
            tw = twists[b]
            vel = _add(tw[3:], _cross(tw[:3], rel))
            pos = _add(state["pos"], rel)
            pts_pos.append(pos)
            pts_vel.append(vel)

            r = float(self.point_radius[p])
            if self.plane_lanes:
                f_p, a_p = self._local_plane_contact(
                    state["plane"][p], state["anchor"][p], pos, vel, r, mu, d_n, imp_cap)
                forces.append(f_p)
                anchors.append(a_p)
                continue
            depth = _minimum(h0 - (pos[2] - r), 0.5)
            active = depth > 0.0
            f_n = _maximum(c.stiffness * depth - d_n * vel[2], 0.0)
            f_n = torch.where(active, f_n, 0.0)
            cone = mu * f_n

            if c.tangent_stiffness > 0.0:
                kt = c.tangent_stiffness
                d_t = min(2.0 * math.sqrt(kt * c.point_mass), imp_cap)
                a = state["anchor"][p]
                ex = _clip(pos[0] - a[0], -0.1, 0.1)
                ey = _clip(pos[1] - a[1], -0.1, 0.1)
                ftx = -kt * ex - d_t * vel[0]
                fty = -kt * ey - d_t * vel[1]
                mag = torch.sqrt(ftx * ftx + fty * fty)
                sc = _minimum(1.0, cone / _maximum(mag, 1e-9))
                ftx, fty = ftx * sc, fty * sc
                new_a = [
                    torch.where(active, pos[0] + _div(ftx, kt), pos[0]),
                    torch.where(active, pos[1] + _div(fty, kt), pos[1]),
                    pos[2] + torch.zeros_like(pos[2]),
                ]
                ftx = torch.where(active, ftx, 0.0)
                fty = torch.where(active, fty, 0.0)
                anchors.append(new_a)
            else:
                speed_t = torch.sqrt(vel[0] * vel[0] + vel[1] * vel[1])
                k_t = _minimum(imp_cap, cone / _maximum(speed_t, c.slip_velocity))
                ftx, fty = -k_t * vel[0], -k_t * vel[1]
                anchors.append(state["anchor"][p])
            forces.append([ftx, fty, f_n])

        # sphere-sphere self-collision
        if self.self_pairs:
            k_self = c.self_collision_stiffness
            d_ns = min(
                2.0 * c.damping_ratio * math.sqrt(k_self * c.point_mass), imp_cap
            )
            for (i, j) in self.self_pairs:
                d = _sub(pts_pos[i], pts_pos[j])
                dist = torch.sqrt(_maximum(_dot(d, d), 0.0))
                inv = 1.0 / _maximum(dist, 1e-6)
                n = _scale(d, inv)
                pen = (float(self.point_radius[i]) + float(self.point_radius[j])) - dist
                active = pen > 0.0
                rel_v = _sub(pts_vel[i], pts_vel[j])
                v_n = _dot(rel_v, n)
                f_mag = _maximum(
                    k_self * _minimum(pen, 0.1) - d_ns * v_n, 0.0
                )
                f_mag = torch.where(active, f_mag, 0.0)
                forces[i] = _add(forces[i], _scale(n, f_mag))
                forces[j] = _sub(forces[j], _scale(n, f_mag))

        return pts_pos, forces, anchors

    def _local_plane_contact(self, lanes, a, pos, vel, r, mu, d_n, imp_cap):
        """(force [3], new anchor [3]) of one point against its ground lanes:
        the normal-aware penalty on the plane h = c + gx x + gy y, the
        anchored friction projected on it, and in "local_plane_walls" the
        frictionless riser-face penalty per axis and the tread force
        suppressed for a center inside a riser solid."""
        c = self.contact
        cpl, gx, gy = lanes[:3]
        inv = 1.0 / torch.sqrt(gx * gx + gy * gy + 1.0)
        n = [-gx * inv, -gy * inv, inv]
        h = cpl + gx * pos[0] + gy * pos[1]
        depth = _minimum(h - (pos[2] - r), 0.5)
        active = depth > 0.0
        v_n = _dot(vel, n)
        f_n = _maximum(c.stiffness * depth - d_n * v_n, 0.0)
        f_n = torch.where(active, f_n, 0.0)
        wall_fx = [0.0, 0.0]
        if self.terrain_mode == "local_plane_walls":
            for ax in range(2):
                wp_, wt_, ws_ = lanes[3 + 3 * ax], lanes[4 + 3 * ax], lanes[5 + 3 * ax]
                below = pos[2] < wt_
                pen = ws_ * (pos[ax] - wp_) + r
                act_w = (ws_ != 0.0) & (pen > 0.0) & below
                v_nw = -ws_ * vel[ax]   # outward-normal velocity
                f_w = _maximum(c.stiffness * _minimum(pen, 0.5) - d_n * v_nw, 0.0)
                wall_fx[ax] = -ws_ * torch.where(act_w, f_w, 0.0)
                inside = (ws_ != 0.0) & (ws_ * (pos[ax] - wp_) > 0.0) & below
                f_n = torch.where(inside, 0.0, f_n)
        cone = mu * f_n
        v_t = _sub(vel, _scale(n, v_n))
        if c.tangent_stiffness > 0.0:
            kt = c.tangent_stiffness
            d_t = min(2.0 * math.sqrt(kt * c.point_mass), imp_cap)
            err = [_clip(pos[k] - a[k], -0.1, 0.1) for k in range(3)]
            err = _sub(err, _scale(n, _dot(err, n)))
            f_t = [-kt * err[k] - d_t * v_t[k] for k in range(3)]
            mag = torch.sqrt(_dot(f_t, f_t))
            sc = _minimum(1.0, cone / _maximum(mag, 1e-9))
            f_t = _scale(f_t, sc)
            new_a = [torch.where(active, pos[k] + _div(f_t[k], kt), pos[k]) for k in range(3)]
            f_t = [torch.where(active, f_t[k], 0.0) for k in range(3)]
        else:
            speed_t = torch.sqrt(_dot(v_t, v_t))
            k_t = _minimum(imp_cap, cone / _maximum(speed_t, c.slip_velocity))
            f_t = _scale(v_t, -k_t)
            new_a = a
        force = _add(_scale(n, f_n), f_t)
        if self.terrain_mode == "local_plane_walls":
            force[0] = force[0] + wall_fx[0]
            force[1] = force[1] + wall_fx[1]
        return force, new_a

    # -- dynamics -----------------------------------------------------------

    def dynamics(self, state, quats, pos_rel, subspace, twists, ext_ang, ext_lin, tau,
                 joint_damp=None):
        """Solve M [a0; qdd] = rhs. Returns (base_acc [6], qdd [D]).

        ``joint_damp``: per-dof damping lanes; dt*damp is added to the joint
        diagonal (implicit drive damping)."""
        nb, nd = self.nb, self.nd

        # per-body inertial triplets (m, h, i_org) at the base origin
        mass = [float(self.mass[b]) for b in range(nb)]
        mass[0] = mass[0] * state["mass_scale"]
        com_local = [[float(x) for x in self.com[b]] for b in range(nb)]
        com_local[0] = _add(com_local[0], state["com_offset"])

        h = [None] * nb
        i_org = [None] * nb
        com_rel = [None] * nb
        for b in range(nb):
            r = _q_to_rotmat(quats[b])
            cr = _add(pos_rel[b], _qapply(quats[b], com_local[b]))
            com_rel[b] = cr
            iw = _m3_sandwich_const(r, self.inertia[b])
            c2 = _dot(cr, cr)
            m = mass[b]
            io = [
                [
                    iw[a][c] + m * ((c2 if a == c else 0.0) - cr[a] * cr[c])
                    for c in range(3)
                ]
                for a in range(3)
            ]
            i_org[b] = io
            h[b] = _scale(cr, m)

        # gravity as external force at each com
        e_ang = []
        e_lin = []
        for b in range(nb):
            gl = [0.0, 0.0, mass[b] * _GRAV * getattr(self.model, 'gravity_scale', 1.0)]
            e_ang.append(_add(_cross(com_rel[b], gl), ext_ang[b]))
            e_lin.append(_add(gl, ext_lin[b]))

        # ---- bias forces ----
        bias_acc = [[0.0] * 6]
        for i in range(1, nb):
            p = self.parent[i]
            qd = state["qd"][i - 1]
            sqd = [subspace[i][k] * qd for k in range(6)]
            tw = twists[i]
            ca = _cross(tw[:3], sqd[:3])
            cl = _add(_cross(tw[:3], sqd[3:]), _cross(tw[3:], sqd[:3]))
            bias_acc.append(_add(bias_acc[p], ca + cl))

        f_body = []
        for b in range(nb):
            w, v = twists[b][:3], twists[b][3:]
            l_mom = _add(_m3_vec(i_org[b], w), _cross(h[b], v))
            p_mom = _add(_scale(v, mass[b]), _cross(w, h[b]))
            ba_w, ba_v = bias_acc[b][:3], bias_acc[b][3:]
            ia_ang = _add(_m3_vec(i_org[b], ba_w), _cross(h[b], ba_v))
            ia_lin = _add(_scale(ba_v, mass[b]), _cross(ba_w, h[b]))
            f_ang = _sub(_add(ia_ang, _add(_cross(w, l_mom), _cross(v, p_mom))), e_ang[b])
            f_lin = _sub(_add(ia_lin, _cross(w, p_mom)), e_lin[b])
            f_body.append(f_ang + f_lin)

        f_acc = [list(fb) for fb in f_body]
        for i in range(nb - 1, 0, -1):
            p = self.parent[i]
            f_acc[p] = _add(f_acc[p], f_acc[i])
        c_full = f_acc[0] + [
            sum(subspace[i + 1][k] * f_acc[i + 1][k] for k in range(6)) for i in range(nd)
        ]

        # ---- CRBA mass matrix (block form) ----
        cm = list(mass)
        ch = [list(hb) for hb in h]
        cio = [[list(row) for row in io] for io in i_org]
        for i in range(nb - 1, 0, -1):
            p = self.parent[i]
            cm[p] = cm[p] + cm[i]
            ch[p] = _add(ch[p], ch[i])
            cio[p] = [[cio[p][a][c] + cio[i][a][c] for c in range(3)] for a in range(3)]

        f_crb = []
        for j in range(nd):
            b = j + 1
            sw, sv = subspace[b][:3], subspace[b][3:]
            fa = _add(_m3_vec(cio[b], sw), _cross(ch[b], sv))
            fl = _add(_scale(sv, cm[b]), _cross(sw, ch[b]))
            f_crb.append(fa + fl)

        n = 6 + nd
        a = {}  # lower triangle (i >= j) of M + ridge
        # base-base block [[cio0, hx], [-hx, cm0 E]]
        hx = [[0.0, -ch[0][2], ch[0][1]], [ch[0][2], 0.0, -ch[0][0]], [-ch[0][1], ch[0][0], 0.0]]
        for i in range(3):
            for j in range(i + 1):
                a[(i, j)] = cio[0][i][j]
        for i in range(3):
            for j in range(3):
                if 3 + i >= j:
                    a[(3 + i, j)] = -hx[i][j]   # bottom-left = -hx (= hx^T)
        for i in range(3):
            for j in range(i + 1):
                a[(3 + i, 3 + j)] = (cm[0] if i == j else 0.0) + (
                    0.0 * a.get((3 + i, 3 + j), 0.0)
                )
        # joint-base block: f_crb rows
        for i in range(nd):
            for j in range(6):
                a[(6 + i, j)] = f_crb[i][j]
        # joint-joint block: gram on ancestor pairs
        for i in range(nd):
            for j in range(i + 1):
                if self.ancestor[i][j] or self.ancestor[j][i] or i == j:
                    g = sum(f_crb[i][k] * subspace[j + 1][k] for k in range(6))
                else:
                    g = 0.0
                if i == j:
                    g = g + float(self.armature[i])
                    if joint_damp is not None:
                        g = g + self.dt * joint_damp[i]
                a[(6 + i, 6 + j)] = g
        for i in range(n):
            a[(i, i)] = a[(i, i)] + _RIDGE

        # ---- unrolled Cholesky + solves ----
        rhs = [-c_full[k] for k in range(6)] + [tau[i] - c_full[6 + i] for i in range(nd)]
        l = {}
        for j in range(n):
            d = torch.sqrt(_maximum(a[(j, j)], 1e-12))
            inv_d = 1.0 / d
            l[(j, j)] = d
            for i in range(j + 1, n):
                l[(i, j)] = a[(i, j)] * inv_d
            for i in range(j + 1, n):
                for k in range(j + 1, i + 1):
                    a[(i, k)] = a[(i, k)] - l[(i, j)] * l[(k, j)]
        y = [None] * n
        for i in range(n):
            acc = rhs[i]
            for j in range(i):
                acc = acc - l[(i, j)] * y[j]
            y[i] = acc / l[(i, i)]
        x = [None] * n
        for i in reversed(range(n)):
            acc = y[i]
            for j in range(i + 1, n):
                acc = acc - l[(j, i)] * x[j]
            x[i] = acc / l[(i, i)]
        return x[:6], x[6:]

    # -- full substep -------------------------------------------------------

    def substep(self, state: Dict, tau: Sequence, joint_damp: Sequence = None):
        """One semi-implicit Euler substep. Returns (new_state, aux) with
        aux = dict(point_force [P][3], quats, pos_rel, twists) from the
        pre-step kinematics."""
        dt = self.dt
        damp = list(joint_damp) if joint_damp is not None else [0.0] * self.nd
        # joint position limits
        if self.contact.joint_limit_violation > 0.0 and self.nd:
            tau = list(tau)
            for i in range(self.nd):
                k = float(self.dof_effort[i]) / self.contact.joint_limit_violation
                over = _maximum(state["q"][i] - float(self.dof_upper[i]), 0.0)
                under = _maximum(float(self.dof_lower[i]) - state["q"][i], 0.0)
                viol = ((over > 0.0) | (under > 0.0)).to(over.dtype)
                lim_damp = (2.0 * k * dt) * viol
                tau[i] = tau[i] + k * (under - over) - lim_damp * state["qd"][i]
                damp[i] = damp[i] + lim_damp

        quats, pos_rel, subspace, twists = self.fk(state)
        pts_pos, forces, anchors = self.contact_forces(state, quats, pos_rel, twists)

        # per-body external wrenches at the base origin
        ext_ang = [[0.0, 0.0, 0.0] for _ in range(self.nb)]
        ext_lin = [[0.0, 0.0, 0.0] for _ in range(self.nb)]
        for p in range(self.np_):
            b = self.point_body[p]
            rel = _sub(pts_pos[p], state["pos"])
            ext_ang[b] = _add(ext_ang[b], _cross(rel, forces[p]))
            ext_lin[b] = _add(ext_lin[b], forces[p])

        base_acc, qdd = self.dynamics(
            state, quats, pos_rel, subspace, twists, ext_ang, ext_lin, tau,
            joint_damp=damp,
        )

        ang = [
            _clip(state["ang"][k] + base_acc[k] * dt, -_MAX_ANG_VEL, _MAX_ANG_VEL)
            for k in range(3)
        ]
        lin_acc = _add(base_acc[3:], _cross(state["ang"], state["lin"]))
        lin = [
            _clip(state["lin"][k] + lin_acc[k] * dt, -_MAX_LIN_VEL, _MAX_LIN_VEL)
            for k in range(3)
        ]
        pos = [state["pos"][k] + lin[k] * dt for k in range(3)]

        # quat_integrate: exact exponential map + renormalize
        w = ang
        angle = torch.sqrt(_maximum(_dot(w, w), 0.0))
        inv = 1.0 / _maximum(angle, 1e-9)
        axis = _scale(w, inv)
        dq = _q_from_angle_axis(angle * dt, axis)
        quat = _qmul(dq, state["quat"])
        qn = torch.sqrt(_maximum(sum(c * c for c in quat), 0.0))
        quat = _scale(quat, 1.0 / _maximum(qn, 1e-9))

        qd = [
            _clip(state["qd"][i] + qdd[i] * dt, -_MAX_DOF_VEL, _MAX_DOF_VEL)
            for i in range(self.nd)
        ]
        q = [state["q"][i] + qd[i] * dt for i in range(self.nd)]

        new_state = dict(state)
        new_state.update(pos=pos, quat=quat, lin=lin, ang=ang, q=q, qd=qd, anchor=anchors)
        aux = {"point_force": forces, "quats": quats, "pos_rel": pos_rel, "twists": twists}
        return new_state, aux


# ---------------------------------------------------------------------------
# full decimation loop
# ---------------------------------------------------------------------------


class ScalarDecimation:
    """PD control + ``decimation`` substeps + per-substep foot accumulators,
    all in component form: the program K1 executes per env."""

    def __init__(
        self,
        sub: ScalarSubstep,
        decimation: int,
        control_type: str,
        action_scale: float,
        p_gains: np.ndarray,
        d_gains: np.ndarray,
        default_dof_pos: np.ndarray,
        torque_limits: np.ndarray,
        feet_bodies: Sequence[int],
        feet_point_groups: Sequence[Sequence[int]],
        post_bodies: Sequence[int] = (),
        damping_coeff: np.ndarray = None,
        post=None,
    ):
        if control_type not in CONTROL_TYPES:
            raise ValueError(f"unknown control_type {control_type!r}")
        self.sub = sub
        self.decimation = int(decimation)
        self.control_type = control_type
        self.action_scale = float(action_scale)
        self.p_gains = np.asarray(p_gains, np.float64)
        self.d_gains = np.asarray(d_gains, np.float64)
        self.default_dof_pos = np.asarray(default_dof_pos, np.float64)
        self.torque_limits = np.asarray(torque_limits, np.float64)
        self.feet_bodies = tuple(int(b) for b in feet_bodies)
        self.feet_point_groups = tuple(tuple(int(p) for p in g) for g in feet_point_groups)
        # bodies whose final-state FK the env consumes post-physics
        self.post_bodies = tuple(int(b) for b in post_bodies)
        # implicit-PD-damping coefficient per dof, scaled by motor strength
        self.damping_coeff = (
            None if damping_coeff is None else np.asarray(damping_coeff, np.float64)
        )
        # lane-form post-physics program (post_lanes.LanePost) or None
        self.post = post

    def torques(self, state, use_act, motor_strength, last_qd=None):
        """The control law in component form: P
        (joint position targets), V (velocity targets, damped by the change
        of joint velocity since the previous policy step over the sim dt) or
        T (torques)."""
        nd = self.sub.nd
        taus = []
        for i in range(nd):
            scaled = use_act[i] * self.action_scale
            if self.control_type == "P":
                t = (
                    float(self.p_gains[i]) * (scaled + float(self.default_dof_pos[i]) - state["q"][i])
                    - float(self.d_gains[i]) * state["qd"][i]
                )
            elif self.control_type == "V":
                t = float(self.p_gains[i]) * (scaled - state["qd"][i]) - _div(
                    float(self.d_gains[i]) * (state["qd"][i] - last_qd[i]), self.sub.dt
                )
            else:
                t = scaled
            lim = float(self.torque_limits[i])
            taus.append(_clip(t * motor_strength[i], -lim, lim))
        return taus

    def run(self, state, actions, last_actions, motor_strength, delay, last_qd=None,
            extra=None):
        """Full decimation loop. ``delay`` is a per-env lane of substeps.

        Returns (state, acc) with acc: ``force_sum`` [F], ``vxyz_sum``
        [F][3], ``vrpy_sum`` [F][3], ``tau`` [D] (final substep),
        ``point_force`` [P][3] (final substep), ``post_quat``/``post_rel``
        for ``post_bodies``, in the terrain modes ``point_pos`` [P][3] (the
        final state's contact points), and with a ``post`` program
        ``acc["post"]``. In the terrain modes ``state["plane"]`` holds each
        point's ground lanes."""
        f = len(self.feet_bodies)
        zeros = torch.zeros_like(delay)
        force_sum = [zeros for _ in range(f)]
        vxyz_sum = [[zeros] * 3 for _ in range(f)]
        vrpy_sum = [[zeros] * 3 for _ in range(f)]

        taus = point_force = None
        for s in range(self.decimation):
            gate = float(s) < delay
            use_act = [
                torch.where(gate, last_actions[d], actions[d]) for d in range(self.sub.nd)
            ]
            taus = self.torques(state, use_act, motor_strength, last_qd)
            damp = (
                None if self.damping_coeff is None else
                [float(self.damping_coeff[d]) * motor_strength[d]
                 for d in range(self.sub.nd)]
            )
            state, aux = self.sub.substep(state, taus, joint_damp=damp)
            for g in range(f):
                pts = self.feet_point_groups[g]
                fx = sum(aux["point_force"][p][0] for p in pts)
                fy = sum(aux["point_force"][p][1] for p in pts)
                fz = sum(aux["point_force"][p][2] for p in pts)
                force_sum[g] = force_sum[g] + torch.sqrt(fx * fx + fy * fy + fz * fz)
                b = self.feet_bodies[g]
                tw = aux["twists"][b]
                rel = aux["pos_rel"][b]
                v_lin = _add(tw[3:], _cross(tw[:3], rel))
                vxyz_sum[g] = [vxyz_sum[g][k] + torch.abs(v_lin[k]) for k in range(3)]
                vrpy_sum[g] = [vrpy_sum[g][k] + torch.abs(tw[k]) for k in range(3)]
            point_force = aux["point_force"]

        acc = {
            "force_sum": force_sum,
            "vxyz_sum": vxyz_sum,
            "vrpy_sum": vrpy_sum,
            "tau": taus,
            "point_force": point_force,
        }
        if self.post_bodies or self.sub.plane_lanes:
            # FK of the final (post-integration) state
            quats, pos_rel, _, _ = self.sub.fk(state)
            like = state["pos"][0]
            lane = lambda v: v + torch.zeros_like(like) if isinstance(v, float) else v
            if self.post_bodies:
                acc["post_quat"] = [[lane(c) for c in quats[b]] for b in self.post_bodies]
                acc["post_rel"] = [[lane(c) for c in pos_rel[b]] for b in self.post_bodies]
            if self.sub.plane_lanes:
                # final-state contact-point world positions: where the env
                # samples the ground planes of the next step
                pp = []
                for p in range(self.sub.np_):
                    b = self.sub.point_body[p]
                    off = [float(x) for x in self.sub.point_offset[p]]
                    rel = _add(pos_rel[b], _qapply(quats[b], off))
                    pp.append([lane(c) for c in _add(state["pos"], rel)])
                acc["point_pos"] = pp
        if self.post is not None:
            acc["post"] = self.post.run(
                state, acc, actions, last_actions, extra, last_qd
            )
        return state, acc
