"""K1, the decimation kernel: wrapper, build and dispatch.

Counterpart of ``wiki_grx_gym_tpu/sim/pallas_step.py:PallasDecimation``,
with the same call signature and return tuple. One call runs a whole
policy step per env: delay gate, PD torques, ``decimation`` physics
substeps, the feet accumulators, the final-state FK of the post bodies and
the folded post-physics stage (``envs/post_lanes.LanePost``).

Dispatch is by the device of the tensors it is given:

- CUDA tensors: the inputs are packed component-major into one contiguous
  ``(C_in, N)`` float32 tensor in the order of :func:`_schema`, the kernel
  of ``csrc/decimation.cu`` writes ``(C_out, N)``, and the outputs are
  sliced back out. The kernel is built with ``nvcc`` at first use
  (:func:`build_library`); a failed build or launch raises.
- CPU tensors: the plain lane program (``ScalarDecimation.run`` +
  ``LanePost.run``) runs instead. :meth:`CudaDecimation.plain` runs that
  program on any device; it is the kernel's reference on the card.

``LAUNCHES["k1"]`` (shared with the other kernels, ``build.LAUNCHES``)
counts the kernel launches of all wrappers; it adds one where the kernel is
launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from wiki_grx_gym_tpu_torch import build as _build
from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts  # noqa: F401
from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarDecimation

_SOURCE = _build.CSRC / "decimation.cu"
_LIB_NAME = "k1_decimation"
NVCC_FLAGS = _build.BASE_FLAGS + [
    # no contraction of a*b+c into FMA: the kernel rounds as the plain lane
    # program does, op by op (the tolerance of the kernel-vs-plain check
    # then covers only library differences of sin/cos/exp/sqrt)
    "--fmad=false",
]

# the sizes the kernel is instantiated for (csrc/decimation.cu, GR1T1 lower limb)
SIZES = dict(NB=11, ND=10, NP=29, NF=2, NPAIR=64, NR=24, NPOST=3)
_MAXG = 8          # termination groups capacity

# reward terms that have a CUDA implementation (ids match csrc/decimation.cu)
REWARD_IDS = {
    name: i for i, name in enumerate([
        "action_diff", "action_diff_diff", "cmd_diff_ang_vel_yaw",
        "cmd_diff_base_height", "cmd_diff_base_orient", "cmd_diff_lin_vel_x",
        "cmd_diff_lin_vel_y", "cmd_diff_lin_vel_z", "cmd_diff_torso_orient",
        "dof_acc_new", "dof_tor_ankle_feet_lift_up", "dof_tor_new",
        "feet_air_force", "feet_air_height", "feet_air_time", "feet_land_time",
        "feet_speed_xy_close_to_ground", "feet_stumble", "limits_dof_pos",
        "limits_dof_tor", "limits_dof_vel", "on_the_air", "pose_offset",
        "stand_still",
    ])
}

IN_GROUPS = (
    "pos", "quat", "lin", "ang", "q", "qd", "anchor", "actions", "last_actions",
    "motor", "delay", "friction", "restitution", "mass_scale", "com_offset",
    "last_qd", "commands", "last_last_actions", "feet_air_time", "feet_land_time",
    "feet_contact_last",
)
OUT_GROUPS = (
    "pos", "quat", "lin", "ang", "q", "qd", "anchor", "force_sum", "vxyz_sum",
    "vrpy_sum", "tau", "point_force", "post_quat", "post_rel", "rew_terms", "blv",
    "bav", "pg", "term_contact", "tilt", "bad", "feet_contact", "contact_filt",
    "first_contact", "feet_air_time_out", "feet_land_time_out", "feet_height", "bho",
)


def _schema(nd: int, np_: int, nf: int, with_last_qd: bool, npost: int = 0,
            post_extra=(), post_out=()):
    """(name, count) component layout of the kernel's input and output
    (``pallas_step._schema``, plane terrain)."""
    state = [
        ("pos", 3), ("quat", 4), ("lin", 3), ("ang", 3),
        ("q", nd), ("qd", nd), ("anchor", 3 * np_),
    ]
    inputs = state + [
        ("actions", nd), ("last_actions", nd), ("motor", nd),
        ("delay", 1), ("friction", 1), ("restitution", 1),
        ("mass_scale", 1), ("com_offset", 3),
    ]
    if with_last_qd:
        inputs.append(("last_qd", nd))
    inputs += list(post_extra)
    outputs = state + [
        ("force_sum", nf), ("vxyz_sum", 3 * nf), ("vrpy_sum", 3 * nf),
        ("tau", nd), ("point_force", 3 * np_),
    ]
    if npost:
        outputs += [("post_quat", 4 * npost), ("post_rel", 3 * npost)]
    outputs += list(post_out)
    return inputs, outputs


def _offsets(schema):
    off, out = 0, {}
    for name, cnt in schema:
        out[name] = (off, cnt)
        off += cnt
    return out, off


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_INFO = _build.BUILD_INFO.setdefault(_LIB_NAME, {})


def build_library():
    """Compile ``csrc/decimation.cu`` into a shared library (once per source
    and flag set; ``build.build``). The build time and ptxas' register/spill
    report land in ``BUILD_INFO``."""
    return _build.build(_LIB_NAME, _SOURCE, NVCC_FLAGS)


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.k1_const_size.argtypes = []
            lib.k1_const_size.restype = ctypes.c_int
            lib.k1_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.k1_set_constants.restype = ctypes.c_int
            lib.k1_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.k1_launch.restype = ctypes.c_int
            if lib.k1_const_size() != ctypes.sizeof(_ModelConst):
                raise RuntimeError(
                    f"constant struct size mismatch: kernel {lib.k1_const_size()} "
                    f"bytes, wrapper {ctypes.sizeof(_ModelConst)}"
                )
            _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# model constants (mirrors struct ModelConst in csrc/decimation.cu)
# ---------------------------------------------------------------------------

_S = SIZES
_I, _F = ctypes.c_int, ctypes.c_float


class _ModelConst(ctypes.Structure):
    _fields_ = [
        # ints
        ("parent", _I * _S["NB"]),
        ("point_body", _I * _S["NP"]),
        ("pair_i", _I * _S["NPAIR"]), ("pair_j", _I * _S["NPAIR"]),
        ("feet_body", _I * _S["NF"]),
        ("feet_start", _I * _S["NF"]), ("feet_count", _I * _S["NF"]),
        ("feet_pts", _I * _S["NP"]),
        ("post_body", _I * _S["NPOST"]),
        ("feet_slot", _I * _S["NF"]),
        ("n_term", _I), ("term_start", _I * _MAXG), ("term_count", _I * _MAXG),
        ("term_pts", _I * _S["NP"]),
        ("torso_slot", _I), ("forehead_slot", _I),
        ("n_ankle_left", _I), ("ankle_left", _I * _S["ND"]),
        ("n_ankle_right", _I), ("ankle_right", _I * _S["ND"]),
        ("reward_id", _I * _S["NR"]),
        ("decimation", _I), ("use_tangent", _I), ("use_joint_limits", _I),
        ("has_damp", _I),
        ("in_off", _I * len(IN_GROUPS)), ("out_off", _I * len(OUT_GROUPS)),
        # floats: tree + inertia
        ("tree_pos", _F * (_S["NB"] * 3)), ("tree_quat", _F * (_S["NB"] * 4)),
        ("axis_unit", _F * (_S["NB"] * 3)), ("axis", _F * (_S["NB"] * 3)),
        ("mass", _F * _S["NB"]), ("com", _F * (_S["NB"] * 3)),
        ("inertia", _F * (_S["NB"] * 9)),
        ("grav_z", _F * _S["NB"]), ("cm_sub", _F * _S["NB"]),
        ("armature", _F * _S["ND"]),
        ("dof_lower", _F * _S["ND"]), ("dof_upper", _F * _S["ND"]),
        ("lim_k", _F * _S["ND"]), ("lim_damp", _F * _S["ND"]),
        ("point_offset", _F * (_S["NP"] * 3)), ("point_radius", _F * _S["NP"]),
        ("pair_rsum", _F * _S["NPAIR"]),
        # contact + integration scalars
        ("dt", _F), ("stiffness", _F), ("damping_ratio", _F), ("sqrt_kpm", _F),
        ("imp_cap", _F), ("kt", _F), ("d_t", _F),
        ("k_self", _F), ("d_ns", _F), ("slip_velocity", _F), ("grav", _F),
        ("gscale", _F), ("ground_h", _F),
        # control
        ("action_scale", _F), ("p_gain", _F * _S["ND"]), ("d_gain", _F * _S["ND"]),
        ("default_q", _F * _S["ND"]), ("torque_limit", _F * _S["ND"]),
        ("damp_coeff", _F * _S["ND"]),
        # post stage
        ("dt_policy", _F), ("decimation_f", _F), ("hscale", _F), ("target_h", _F),
        ("feet_offset", _F * (_S["NF"] * 3)),
        ("torso_qoff", _F * 4), ("forehead_qoff", _F * 4),
        ("soft_lo", _F * _S["ND"]), ("soft_hi", _F * _S["ND"]),
        ("vel_soft", _F * _S["ND"]), ("tor_soft", _F * _S["ND"]),
        ("scale", _F * _S["NR"]), ("sigma", _F * _S["NR"]),
        ("swing_target", _F), ("swing_half", _F), ("swing_quarter", _F),
        ("fat_target", _F), ("fat_half", _F), ("flt_max", _F), ("stumble_ratio", _F),
    ]


def _fill(arr, values):
    values = list(values)
    for i, v in enumerate(values):
        arr[i] = v


def _composite_masses(parent, mass):
    """Subtree masses of bodies >= 1, folded in float64 in the order of the
    lane program's CRBA pass (bodies >= 1 carry Python-float masses there,
    so their sums are float64 sums)."""
    cm = [float(m) for m in mass]
    for i in range(len(parent) - 1, 0, -1):
        p = parent[i]
        if p != 0:
            cm[p] = cm[p] + cm[i]
    return cm


def _make_constants(deci: ScalarDecimation, in_off, out_off, c_in, c_out) -> _ModelConst:
    sub, post = deci.sub, deci.post
    c = sub.contact
    k = _ModelConst()
    nb, nd, np_ = sub.nb, sub.nd, sub.np_
    # ints
    _fill(k.parent, [max(p, 0) for p in sub.parent])
    _fill(k.point_body, sub.point_body)
    _fill(k.pair_i, [i for i, _ in sub.self_pairs])
    _fill(k.pair_j, [j for _, j in sub.self_pairs])
    _fill(k.feet_body, deci.feet_bodies)
    flat, start = [], []
    for g in deci.feet_point_groups:
        start.append(len(flat))
        flat += list(g)
    _fill(k.feet_start, start)
    _fill(k.feet_count, [len(g) for g in deci.feet_point_groups])
    _fill(k.feet_pts, flat)
    _fill(k.post_body, deci.post_bodies)
    _fill(k.feet_slot, post.feet_slots)
    k.n_term = len(post.termination_groups)
    flat, start = [], []
    for g in post.termination_groups:
        start.append(len(flat))
        flat += list(g)
    _fill(k.term_start, start)
    _fill(k.term_count, [len(g) for g in post.termination_groups])
    _fill(k.term_pts, flat)
    k.torso_slot = -1 if post.torso is None else post.torso[0]
    k.forehead_slot = -1 if post.forehead is None else post.forehead[0]
    half = len(post.ankle_dofs) // 2
    k.n_ankle_left = half
    _fill(k.ankle_left, post.ankle_dofs[:half])
    k.n_ankle_right = len(post.ankle_dofs) - half
    _fill(k.ankle_right, post.ankle_dofs[half:])
    _fill(k.reward_id, [REWARD_IDS[n] for n in post.reward_names])
    k.decimation = deci.decimation
    k.use_tangent = int(c.tangent_stiffness > 0.0)
    k.use_joint_limits = int(c.joint_limit_violation > 0.0 and nd > 0)
    k.has_damp = int(deci.damping_coeff is not None)
    _fill(k.in_off, [in_off[g][0] for g in IN_GROUPS])
    _fill(k.out_off, [out_off[g][0] for g in OUT_GROUPS])
    # tree + inertia (float64 on the host, rounded once to float32)
    _fill(k.tree_pos, sub.tree_pos.reshape(-1))
    _fill(k.tree_quat, sub.tree_quat.reshape(-1))
    _fill(k.axis_unit, sub.axis_unit.reshape(-1))
    _fill(k.axis, sub.axis.reshape(-1))
    _fill(k.mass, sub.mass)
    _fill(k.com, sub.com.reshape(-1))
    _fill(k.inertia, sub.inertia.reshape(-1))
    gscale = getattr(sub.model, "gravity_scale", 1.0)
    _fill(k.grav_z, [float(sub.mass[b]) * -9.81 * gscale for b in range(nb)])
    _fill(k.cm_sub, _composite_masses(sub.parent, sub.mass))
    _fill(k.armature, sub.armature)
    _fill(k.dof_lower, sub.dof_lower)
    _fill(k.dof_upper, sub.dof_upper)
    jlv = c.joint_limit_violation
    lim_k = [float(sub.dof_effort[i]) / jlv if jlv > 0.0 else 0.0 for i in range(nd)]
    _fill(k.lim_k, lim_k)
    _fill(k.lim_damp, [2.0 * lim_k[i] * sub.dt for i in range(nd)])
    _fill(k.point_offset, sub.point_offset.reshape(-1))
    _fill(k.point_radius, sub.point_radius)
    _fill(k.pair_rsum, [float(sub.point_radius[i]) + float(sub.point_radius[j])
                        for i, j in sub.self_pairs])
    # scalars, folded in float64 exactly as the lane program folds them
    imp_cap = c.point_mass / sub.dt
    k.dt = sub.dt
    k.stiffness = c.stiffness
    k.damping_ratio = c.damping_ratio
    k.sqrt_kpm = math.sqrt(c.stiffness * c.point_mass)
    k.imp_cap = imp_cap
    k.kt = c.tangent_stiffness
    k.d_t = min(2.0 * math.sqrt(c.tangent_stiffness * c.point_mass), imp_cap)
    k.k_self = c.self_collision_stiffness
    k.d_ns = min(2.0 * c.damping_ratio * math.sqrt(c.self_collision_stiffness * c.point_mass),
                 imp_cap)
    k.slip_velocity = c.slip_velocity
    k.grav = -9.81
    k.gscale = gscale
    k.ground_h = sub.ground_height
    # control
    k.action_scale = deci.action_scale
    _fill(k.p_gain, deci.p_gains)
    _fill(k.d_gain, deci.d_gains)
    _fill(k.default_q, deci.default_dof_pos)
    _fill(k.torque_limit, deci.torque_limits)
    if deci.damping_coeff is not None:
        _fill(k.damp_coeff, deci.damping_coeff)
    # post stage
    rw = post.rw
    k.dt_policy = post.dt
    k.decimation_f = post.decimation
    k.hscale = post.hscale
    k.target_h = post.target_h
    _fill(k.feet_offset, post.feet_offsets.reshape(-1))
    if post.torso is not None:
        _fill(k.torso_qoff, post.torso[1])
    if post.forehead is not None:
        _fill(k.forehead_qoff, post.forehead[1])
    _fill(k.soft_lo, post.dof_pos_soft_lower)
    _fill(k.soft_hi, post.dof_pos_soft_upper)
    _fill(k.vel_soft, [float(post.dof_vel_limits[i]) * rw.soft_dof_vel_limit for i in range(nd)])
    _fill(k.tor_soft, [float(post.torque_limits[i]) * rw.soft_torque_limit for i in range(nd)])
    _fill(k.scale, [post.scales[n] for n in post.reward_names])
    _fill(k.sigma, [getattr(rw, "sigma_" + n) for n in post.reward_names])
    k.swing_target = rw.swing_feet_height_target
    k.swing_half = rw.swing_feet_height_target / 2
    k.swing_quarter = rw.swing_feet_height_target / 4
    k.fat_target = rw.feet_air_time_target
    k.fat_half = rw.feet_air_time_target / 2
    k.flt_max = rw.feet_land_time_max
    k.stumble_ratio = rw.feet_stumble_ratio
    return k


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_CONST_OWNER = [None]   # the wrapper whose constants sit in __constant__ memory


class CudaDecimation:
    """Callable wrapper: (batched tensors in) -> K1 -> (batched tensors out).

    The kernel path supports what the CUDA source implements: plane
    terrain, P control, the post fold, and the GR1T1 lower-limb sizes
    (``SIZES``); anything else raises on a CUDA tensor."""

    def __init__(self, deci: ScalarDecimation):
        self.deci = deci
        self.nd = deci.sub.nd
        self.np_ = deci.sub.np_
        self.nf = len(deci.feet_bodies)
        self.npost = len(deci.post_bodies)
        self.post = deci.post
        self.with_last_qd = self.post is not None
        self.post_extra = self.post.extra_schema() if self.post else ()
        self.post_out = self.post.out_schema() if self.post else ()
        self.in_schema, self.out_schema = _schema(
            self.nd, self.np_, self.nf, self.with_last_qd, self.npost,
            self.post_extra, self.post_out,
        )
        self.in_off, self.c_in = _offsets(self.in_schema)
        self.out_off, self.c_out = _offsets(self.out_schema)
        self._const = None

    # -- what the kernel implements ------------------------------------------

    def kernel_support_error(self):
        """None if the CUDA kernel implements this program, else why not."""
        d, s = self.deci, self.deci.sub
        if self.post is None:
            return "the kernel implements the post-fold program only"
        sizes = dict(NB=s.nb, ND=s.nd, NP=s.np_, NF=self.nf, NPAIR=len(s.self_pairs),
                     NR=len(self.post.reward_names), NPOST=self.npost)
        if sizes != SIZES:
            return f"the kernel is instantiated for sizes {SIZES}, this model has {sizes}"
        missing = [n for n in self.post.reward_names if n not in REWARD_IDS]
        if missing:
            return f"reward terms without a CUDA implementation: {missing}"
        if len(self.post.termination_groups) > _MAXG:
            return f"more than {_MAXG} termination groups"
        if self.post.penalized_groups:
            return "penalized contact groups are not implemented in the kernel"
        return None

    # -- the call -----------------------------------------------------------

    def __call__(self, phys, actions, last_actions, motor, delay, rand, last_qd=None,
                 plane=None, extra=None):
        """Returns (new_phys, force_sum (N,F), vxyz_sum (N,F,3),
        vrpy_sum (N,F,3), tau (N,D), point_force (N,P,3),
        post_kin: (post_rel (N,R,3), post_quat (N,R,4)) or None,
        point_pos: None (plane terrain),
        post_out: dict of (N, cnt) tensors per LanePost.out_schema or None)."""
        if plane is not None:
            raise NotImplementedError("local ground planes are ROADMAP queue 1 item 10")
        if actions.device.type == "cpu":
            return self.plain(phys, actions, last_actions, motor, delay, rand, last_qd, extra)
        if actions.device.type != "cuda":
            raise RuntimeError(f"K1 runs on CUDA tensors, got device {actions.device}")
        return self._launch(phys, actions, last_actions, motor, delay, rand, last_qd, extra)

    # -- kernel path -----------------------------------------------------------

    def _pack(self, phys, actions, last_actions, motor, delay, rand, last_qd, extra):
        """(N, ...) tensors -> one contiguous (C_in, N) float32 tensor."""
        n = actions.shape[0]
        cols = [
            phys.base_pos, phys.base_quat, phys.base_lin_vel, phys.base_ang_vel,
            phys.q, phys.qd, phys.anchor.reshape(n, -1),
            actions, last_actions, motor,
            delay.reshape(n, 1), rand.friction.reshape(n, 1),
            rand.restitution.reshape(n, 1), rand.base_mass_scale.reshape(n, 1),
            rand.base_com_offset,
        ]
        if self.with_last_qd:
            cols.append(last_qd)
        for name, cnt in self.post_extra:
            cols.append(extra[name].reshape(n, cnt))
        comp = torch.cat([x.to(torch.float32) for x in cols], dim=1).t().contiguous()
        assert comp.shape == (self.c_in, n)
        return comp

    def _launch(self, phys, actions, last_actions, motor, delay, rand, last_qd, extra):
        why = self.kernel_support_error()
        if why is not None:
            raise NotImplementedError(f"K1 on CUDA: {why}")
        lib = _load()
        n = actions.shape[0]
        dev = actions.device
        comp = self._pack(phys, actions, last_actions, motor, delay, rand, last_qd, extra)
        out = torch.empty((self.c_out, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if self._const is None:
                self._const = _make_constants(
                    self.deci, self.in_off, self.out_off, self.c_in, self.c_out
                )
            if _CONST_OWNER[0] is not self:
                err = lib.k1_set_constants(
                    ctypes.addressof(self._const), ctypes.sizeof(self._const), stream
                )
                if err != 0:
                    raise RuntimeError(f"k1_set_constants failed: CUDA error {err}")
                _CONST_OWNER[0] = self
            err = lib.k1_launch(comp.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        LAUNCHES["k1"] += 1
        return self._unpack(out, phys, n)

    def _unpack(self, flat, phys, n):
        def take(name):
            off, cnt = self.out_off[name]
            return flat[off: off + cnt].t()  # (N, cnt)

        new_phys = phys.replace(
            base_pos=take("pos"), base_quat=take("quat"),
            base_lin_vel=take("lin"), base_ang_vel=take("ang"),
            q=take("q"), qd=take("qd"),
            anchor=take("anchor").reshape(n, self.np_, 3),
        )
        post_kin = None
        if self.npost:
            post_kin = (
                take("post_rel").reshape(n, self.npost, 3),
                take("post_quat").reshape(n, self.npost, 4),
            )
        post_out = (
            {name: take(name) for name, _ in self.post_out}
            if self.post is not None else None
        )
        return (
            new_phys,
            take("force_sum"),
            take("vxyz_sum").reshape(n, self.nf, 3),
            take("vrpy_sum").reshape(n, self.nf, 3),
            take("tau"),
            take("point_force").reshape(n, self.np_, 3),
            post_kin,
            None,
            post_out,
        )

    # -- plain path (the lane program; any device) -----------------------------

    def plain(self, phys, actions, last_actions, motor, delay, rand, last_qd=None,
              extra=None):
        """The plain PyTorch version of K1 on (N,) lanes; same return tuple."""
        n = actions.shape[0]
        col = lambda a: [a[..., i] for i in range(a.shape[-1])]
        lanes = {
            "pos": col(phys.base_pos), "quat": col(phys.base_quat),
            "lin": col(phys.base_lin_vel), "ang": col(phys.base_ang_vel),
            "q": col(phys.q), "qd": col(phys.qd),
            "anchor": [col(phys.anchor[:, p]) for p in range(phys.anchor.shape[-2])],
            "friction": rand.friction, "restitution": rand.restitution,
            "mass_scale": rand.base_mass_scale, "com_offset": col(rand.base_com_offset),
        }
        extra_lanes = {
            name: col(extra[name].reshape(n, cnt)) for name, cnt in self.post_extra
        }
        state, acc = self.deci.run(
            lanes, col(actions), col(last_actions), col(motor), delay,
            col(last_qd) if self.with_last_qd else None, extra=extra_lanes,
        )
        stack = lambda ls: torch.stack([torch.broadcast_to(x, (n,)) for x in ls], dim=-1)
        new_phys = phys.replace(
            base_pos=stack(state["pos"]), base_quat=stack(state["quat"]),
            base_lin_vel=stack(state["lin"]), base_ang_vel=stack(state["ang"]),
            q=stack(state["q"]), qd=stack(state["qd"]),
            anchor=torch.stack([stack(a) for a in state["anchor"]], dim=-2),
        )
        post_kin = None
        if self.npost:
            post_kin = (
                torch.stack([stack(r) for r in acc["post_rel"]], dim=-2),
                torch.stack([stack(q) for q in acc["post_quat"]], dim=-2),
            )
        post_out = None
        if self.post is not None:
            post_out = {name: stack(acc["post"][name]) for name, _ in self.post_out}
        return (
            new_phys,
            stack(acc["force_sum"]),
            torch.stack([stack(v) for v in acc["vxyz_sum"]], dim=-2),
            torch.stack([stack(v) for v in acc["vrpy_sum"]], dim=-2),
            stack(acc["tau"]),
            torch.stack([stack(p) for p in acc["point_force"]], dim=-2),
            post_kin,
            None,
            post_out,
        )
