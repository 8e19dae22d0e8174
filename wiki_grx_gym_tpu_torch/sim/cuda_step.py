"""K1, the decimation kernel: wrapper, build and dispatch.

Counterpart of ``wiki_grx_gym_tpu/sim/pallas_step.py:PallasDecimation``,
with the same call signature and return tuple. One call runs a whole
policy step per env: delay gate, the control law's torques (P, V or T),
``decimation`` physics
substeps against the ground of the program's terrain mode (the flat plane,
or per-point ground planes and riser walls given as the ``plane`` input),
the feet accumulators, the final-state FK of the post bodies, the
final-state contact-point positions (terrain modes), and, in the post-fold
program, the post-physics stage (``envs/post_lanes.LanePost``). Without
the fold the env runs that stage outside K1.

Dispatch is by the device of the tensors it is given:

- CUDA tensors: the inputs are packed component-major into one contiguous
  ``(C_in, N)`` float32 tensor in the order of :func:`_schema`, the team
  kernel of ``csrc/decimation.cu`` (a team of lanes an env) writes
  ``(C_out, N)``, and the outputs are sliced back out. The kernels are built
  with ``nvcc`` at first use, one library per program's sizes
  (:class:`K1Sizes`, :func:`program_sizes`) and team shape
  (:func:`team_shape`), passed as -D flags (:func:`nvcc_flags`,
  :func:`build_library`); a failed build or launch raises. The model
  constants (:func:`const_struct` of the sizes) include the team kernel's
  schedule (:func:`team_lists`). :meth:`CudaDecimation.launch_packed` also runs the
  one-thread-per-env kernel, the team kernel's bit-for-bit reference, for
  checks and timings only; :func:`team_occupancy` reports the team kernel's
  shape and occupancy, and :func:`reachable_state`,
  :func:`decimation_inputs` and :func:`reachable_case` make the inputs
  those checks run on.
- CPU tensors: the plain lane program (``ScalarDecimation.run`` +
  ``LanePost.run``) runs instead. :meth:`CudaDecimation.plain` runs that
  program on any device; it is the kernel's reference on the card.

``LAUNCHES["k1"]`` (shared with the other kernels, ``build.LAUNCHES``)
counts the kernel launches of all wrappers; it adds one where the kernel is
launched and nowhere else (``build.count_launch``: inside a CUDA graph's
capture the graph's tally, which each replay adds).

Under a CUDA graph's capture (``learn/graphs.py``) a launch is preceded by
a device-to-symbol copy of the wrapper's own constants (``k1_copy_constants``
from a device-resident copy made at the first launch outside a capture), so
a replay computes with this wrapper's constants whatever another wrapper of
the same sizes uploaded in between; after each replay the wrapper is again
the owner of the symbol.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
import threading
from typing import NamedTuple

import torch

from wiki_grx_gym_tpu_torch import build as _build
from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts  # noqa: F401
from wiki_grx_gym_tpu_torch.sim.scalarized import CONTROL_TYPES, PLANE_LANES, ScalarDecimation

_SOURCE = _build.CSRC / "decimation.cu"
NVCC_FLAGS = _build.BASE_FLAGS + [
    # no contraction of a*b+c into FMA: the kernel rounds as the plain lane
    # program does, op by op (the tolerance of the kernel-vs-plain check
    # then covers only library differences of sin/cos/exp/sqrt)
    "--fmad=false",
]


class K1Sizes(NamedTuple):
    """The program a K1 library is built for (``csrc/decimation.cu``
    struct ``Sizes``): bodies, dofs, contact points, feet, self-collision
    pairs, reward terms, post-FK bodies, input and output components, the
    terrain mode (``TERRAIN_MODES``), whether the post stage is folded in,
    the control law (``scalarized.CONTROL_TYPES``: 0 P, 1 V, 2 T), and the
    folded stage's penalized contact groups and their points in all."""

    NB: int
    ND: int
    NP: int
    NF: int
    NPAIR: int
    NR: int
    NPOST: int
    NIN: int
    NOUT: int
    TERRAIN: int
    FOLD: int
    CTRL: int
    NPEN: int
    NPENP: int


# the terrain modes' codes in csrc/decimation.cu (K1_TERRAIN)
TERRAIN_MODES = {"plane": 0, "local_plane": 1, "local_plane_walls": 2}

# the team kernel's shape (lanes an env, envs a block) per model: 16 x 8 up
# to 16 dofs; 32 x 8 above, where an env's working set and registers let
# two blocks (16 envs) share an SM (PERF.md section 6)
TEAM_SHAPE_SMALL = (16, 8)
TEAM_SHAPE_FULL_BODY = (32, 8)
MAX_DOF = 32   # anc_mask holds one bit a dof


def team_shape(sizes: K1Sizes):
    """(T, E): lanes an env and envs a block of the team kernel for these sizes."""
    return TEAM_SHAPE_SMALL if sizes.ND <= 16 else TEAM_SHAPE_FULL_BODY


def size_defines(sizes: K1Sizes) -> list:
    """The sizes and their team shape as the -D flags ``csrc/decimation.cu`` reads."""
    team = team_shape(sizes)
    return [f"-DK1_{k}={v}" for k, v in sizes._asdict().items()] + [
        f"-DK1_TEAM_T={team[0]}", f"-DK1_TEAM_E={team[1]}"]


def nvcc_flags(sizes: K1Sizes) -> list:
    """nvcc's flags for one K1 library."""
    return NVCC_FLAGS + size_defines(sizes)


def library_name(sizes: K1Sizes) -> str:
    """The name of the library of one size set and its team shape
    (``build.BUILD_INFO`` key; the file name adds a hash of the flags)."""
    team = team_shape(sizes)
    return "k1_decimation_" + "_".join(map(str, sizes)) + f"_{team[0]}x{team[1]}"


def kernel_name(mangled: str) -> str:
    """A K1 kernel's readable name from its mangled one (ptxas' report):
    the team kernel with its lanes an env and envs a block."""
    shape = re.search(r"Li(\d+)ELi(\d+)E", mangled)
    if "decimation_team_kernel" in mangled and shape:
        return f"decimation_team_kernel<{shape.group(1)}, {shape.group(2)}>"
    return "decimation_kernel" if "decimation_kernel" in mangled else mangled


def ptxas_report(sizes: K1Sizes) -> dict:
    """ptxas' registers and spills per kernel of the library for these sizes,
    by readable name (empty when the library was built before this process)."""
    lines = _build.BUILD_INFO.get(library_name(sizes), {}).get("ptxas", [])
    return {kernel_name(m): r for m, r in _build.ptxas_summary(lines).items()}


_MAXG = 8          # termination groups capacity

# the folded stage's reward terms, every lane-form term of envs/post_lanes.py
# (ids match enum Reward of csrc/decimation.cu)
REWARD_IDS = {
    name: i for i, name in enumerate([
        "action_diff", "action_diff_diff", "action_diff_knee", "action_rate",
        "ang_vel_xy", "base_height", "cmd_diff_ang_vel_pitch", "cmd_diff_ang_vel_roll",
        "cmd_diff_ang_vel_yaw", "cmd_diff_base_height", "cmd_diff_base_orient",
        "cmd_diff_forehead_orient", "cmd_diff_lin_vel_x", "cmd_diff_lin_vel_y",
        "cmd_diff_lin_vel_z", "cmd_diff_torso_orient", "collision", "dof_acc",
        "dof_acc_new", "dof_pos_limits", "dof_tor_ankle_feet_lift_up", "dof_tor_new",
        "dof_tor_new_hip_roll", "dof_vel", "dof_vel_limits", "dof_vel_new",
        "dof_vel_new_knee", "feet_air_force", "feet_air_height", "feet_air_time",
        "feet_contact_forces", "feet_land_time", "feet_speed_xy_close_to_ground",
        "feet_speed_z_close_to_height_target", "feet_stumble", "limits_actions",
        "limits_dof_pos", "limits_dof_tor", "limits_dof_vel", "lin_vel_z", "on_the_air",
        "orientation", "pose_offset", "pose_offset_hip_yaw", "stand_still", "stumble",
        "torque_limits", "torques", "tracking_ang_vel", "tracking_lin_vel",
    ])
}

IN_GROUPS = (
    "pos", "quat", "lin", "ang", "q", "qd", "anchor", "actions", "last_actions",
    "motor", "delay", "friction", "restitution", "mass_scale", "com_offset",
    "last_qd", "commands", "last_last_actions", "feet_air_time", "feet_land_time",
    "feet_contact_last", "plane",
)
OUT_GROUPS = (
    "pos", "quat", "lin", "ang", "q", "qd", "anchor", "force_sum", "vxyz_sum",
    "vrpy_sum", "tau", "point_force", "post_quat", "post_rel", "rew_terms", "blv",
    "bav", "pg", "term_contact", "tilt", "bad", "feet_contact", "contact_filt",
    "first_contact", "feet_air_time_out", "feet_land_time_out", "feet_height", "bho",
    "point_pos",
)


def _schema(nd: int, np_: int, nf: int, with_last_qd: bool, npost: int = 0,
            plane_lanes: int = 0, post_extra=(), post_out=()):
    """(name, count) component layout of the kernel's input and output
    (``pallas_step._schema``)."""
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
    if plane_lanes:
        # per-point ground lanes: (c, gx, gy), + the riser walls (9 lanes)
        inputs.append(("plane", plane_lanes * np_))
    inputs += list(post_extra)
    outputs = state + [
        ("force_sum", nf), ("vxyz_sum", 3 * nf), ("vrpy_sum", 3 * nf),
        ("tau", nd), ("point_force", 3 * np_),
    ]
    if npost:
        outputs += [("post_quat", 4 * npost), ("post_rel", 3 * npost)]
    if plane_lanes:
        # final-state point positions: where the env samples the next planes
        outputs += [("point_pos", 3 * np_)]
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

_LIBS = {}   # sizes -> the loaded library
_LIB_LOCK = threading.Lock()


def build_library(sizes: K1Sizes):
    """Compile ``csrc/decimation.cu`` for one size set and its team shape
    into a shared library (once per source and flag set; ``build.build``).
    The build time and ptxas' register/spill report land in
    ``build.BUILD_INFO[library_name(sizes)]``."""
    return _build.build(library_name(sizes), _SOURCE, nvcc_flags(sizes))


def _load(sizes: K1Sizes):
    with _LIB_LOCK:
        if sizes not in _LIBS:
            lib = ctypes.CDLL(str(build_library(sizes)))
            lib.k1_const_size.argtypes = []
            lib.k1_const_size.restype = ctypes.c_int
            lib.k1_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.k1_set_constants.restype = ctypes.c_int
            lib.k1_copy_constants.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.k1_copy_constants.restype = ctypes.c_int
            launch = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            for fn in (lib.k1_launch, lib.k1_launch_thread):
                fn.argtypes = launch
                fn.restype = ctypes.c_int
            lib.k1_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
            lib.k1_occupancy.restype = ctypes.c_int
            want = ctypes.sizeof(const_struct(sizes))
            if lib.k1_const_size() != want:
                raise RuntimeError(
                    f"constant struct size mismatch: kernel {lib.k1_const_size()} "
                    f"bytes, wrapper {want}"
                )
            _LIBS[sizes] = lib
    return _LIBS[sizes]


# ---------------------------------------------------------------------------
# model constants (mirrors struct ModelConst in csrc/decimation.cu)
# ---------------------------------------------------------------------------

_I, _U, _F = ctypes.c_int, ctypes.c_uint, ctypes.c_float


def _cap(n: int) -> int:
    """An array's capacity for a count that may be 0 (decimation.cu ``cap``)."""
    return max(n, 1)


@functools.lru_cache(maxsize=None)
def const_struct(sizes: K1Sizes):
    """The ctypes mirror of ``ModelConst<Sizes>`` for one size set."""
    nb, nd, np_, nf = sizes.NB, sizes.ND, sizes.NP, sizes.NF
    npair, nr, npost = _cap(sizes.NPAIR), _cap(sizes.NR), sizes.NPOST
    npen, npenp = _cap(sizes.NPEN), _cap(sizes.NPENP)
    fields = [
        # ints
        ("parent", _I * nb),
        ("point_body", _I * np_),
        ("pair_i", _I * npair), ("pair_j", _I * npair),
        ("feet_body", _I * nf),
        ("feet_start", _I * nf), ("feet_count", _I * nf),
        ("feet_pts", _I * np_),
        ("post_body", _I * npost),
        ("feet_slot", _I * nf),
        ("n_term", _I), ("term_start", _I * _MAXG), ("term_count", _I * _MAXG),
        ("term_pts", _I * np_),
        ("torso_slot", _I), ("forehead_slot", _I),
        ("n_ankle_left", _I), ("ankle_left", _I * nd),
        ("n_ankle_right", _I), ("ankle_right", _I * nd),
        ("n_knee", _I), ("knee", _I * nd),
        ("n_hip_roll", _I), ("hip_roll", _I * nd),
        ("n_hip_yaw", _I), ("hip_yaw", _I * nd),
        ("pen_start", _I * npen), ("pen_count", _I * npen), ("pen_pts", _I * npenp),
        ("reward_id", _I * nr),
        ("decimation", _I), ("use_tangent", _I), ("use_joint_limits", _I),
        ("has_damp", _I),
        ("in_off", _I * len(IN_GROUPS)), ("out_off", _I * len(OUT_GROUPS)),
        # the team kernel's schedule (team_lists)
        ("pt_pair_start", _I * (np_ + 1)), ("pt_pair", _I * _cap(2 * sizes.NPAIR)),
        ("body_pt_start", _I * (nb + 1)), ("body_pts", _I * np_),
        ("n_levels", _I), ("level_start", _I * nb), ("level_body", _I * nb),
        ("anc_mask", _U * nd),
        # floats: tree + inertia
        ("tree_pos", _F * (nb * 3)), ("tree_quat", _F * (nb * 4)),
        ("axis_unit", _F * (nb * 3)), ("axis", _F * (nb * 3)),
        ("mass", _F * nb), ("com", _F * (nb * 3)),
        ("inertia", _F * (nb * 9)),
        ("grav_z", _F * nb), ("cm_sub", _F * nb),
        ("armature", _F * nd),
        ("dof_lower", _F * nd), ("dof_upper", _F * nd),
        ("lim_k", _F * nd), ("lim_damp", _F * nd),
        ("point_offset", _F * (np_ * 3)), ("point_radius", _F * np_),
        ("pair_rsum", _F * npair),
        # contact + integration scalars
        ("dt", _F), ("stiffness", _F), ("damping_ratio", _F), ("sqrt_kpm", _F),
        ("imp_cap", _F), ("kt", _F), ("d_t", _F),
        ("k_self", _F), ("d_ns", _F), ("slip_velocity", _F), ("grav", _F),
        ("gscale", _F), ("ground_h", _F),
        # control
        ("action_scale", _F), ("p_gain", _F * nd), ("d_gain", _F * nd),
        ("default_q", _F * nd), ("torque_limit", _F * nd),
        ("damp_coeff", _F * nd),
        # post stage
        ("dt_policy", _F), ("decimation_f", _F), ("hscale", _F), ("target_h", _F),
        ("feet_offset", _F * (nf * 3)),
        ("torso_qoff", _F * 4), ("forehead_qoff", _F * 4),
        ("soft_lo", _F * nd), ("soft_hi", _F * nd),
        ("vel_soft", _F * nd), ("tor_soft", _F * nd),
        ("scale", _F * nr), ("sigma", _F * nr),
        ("swing_target", _F), ("swing_half", _F), ("swing_quarter", _F),
        ("fat_target", _F), ("fat_half", _F), ("flt_max", _F), ("stumble_ratio", _F),
        ("swing_3q", _F), ("tracking_sigma", _F), ("max_contact_force", _F),
    ]
    return type(f"ModelConst_{'_'.join(map(str, sizes))}", (ctypes.Structure,), {"_fields_": fields})


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


def team_lists(sub) -> dict:
    """The team kernel's schedule for a ``ScalarSubstep``, as flat lists
    (``ModelConst`` fields of ``csrc/decimation.cu``):

    - ``pt_pair_start`` / ``pt_pair``: for each point, the self-collision
      pairs it is in, in ascending pair order, each as ``2 s + 1`` where the
      point is pair s's j (its force is subtracted) and ``2 s`` where it is
      the i (added): the order in which the serial pair loop updates it;
    - ``body_pt_start`` / ``body_pts``: for each body, its contact points in
      ascending order (the serial wrench loop's);
    - ``n_levels`` / ``level_start`` / ``level_body``: the bodies >= 1 by
      depth in the tree, so that a level's parents are all in earlier ones;
    - ``anc_mask``: per dof i, bit j set where dof j is an ancestor-or-self
      of dof i (dof d moves body d + 1)."""
    npair = len(sub.self_pairs)
    per_point = [[] for _ in range(sub.np_)]
    for s, (i, j) in enumerate(sub.self_pairs):
        per_point[i].append(2 * s)
        per_point[j].append(2 * s + 1)
    per_body = [[p for p in range(sub.np_) if sub.point_body[p] == b] for b in range(sub.nb)]
    depth = [0] * sub.nb
    for i in range(1, sub.nb):
        depth[i] = depth[sub.parent[i]] + 1
    levels = [[i for i in range(1, sub.nb) if depth[i] == d] for d in range(1, max(depth) + 1)]
    anc = []
    for i in range(sub.nd):
        m, b = 0, i + 1
        while b > 0:
            m |= 1 << (b - 1)
            b = sub.parent[b]
        anc.append(m)
    starts = lambda groups: [sum(len(g) for g in groups[:k]) for k in range(len(groups) + 1)]
    flat = lambda groups: [x for g in groups for x in g]
    out = dict(
        pt_pair_start=starts(per_point), pt_pair=flat(per_point),
        body_pt_start=starts(per_body), body_pts=flat(per_body),
        n_levels=len(levels), level_start=starts(levels), level_body=flat(levels),
        anc_mask=anc,
    )
    assert len(out["pt_pair"]) == 2 * npair
    return out


def program_sizes(deci: ScalarDecimation, c_in: int, c_out: int) -> K1Sizes:
    """The sizes of one program (the K1 library it runs on)."""
    s, post = deci.sub, deci.post
    pen = () if post is None else post.penalized_groups
    return K1Sizes(NB=s.nb, ND=s.nd, NP=s.np_, NF=len(deci.feet_bodies), NPAIR=len(s.self_pairs),
                   NR=0 if post is None else len(post.reward_names), NPOST=len(deci.post_bodies),
                   NIN=c_in, NOUT=c_out, TERRAIN=TERRAIN_MODES[s.terrain_mode],
                   FOLD=int(post is not None), CTRL=CONTROL_TYPES[deci.control_type],
                   NPEN=len(pen), NPENP=sum(len(g) for g in pen))


def _fill_post(k, deci: ScalarDecimation):
    """The post stage's fields of ``ModelConst`` (the post-fold program)."""
    post, nd = deci.post, deci.sub.nd
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
    for name in ("knee", "hip_roll", "hip_yaw"):
        dofs = getattr(post, name + "_dofs")
        setattr(k, "n_" + name, len(dofs))
        _fill(getattr(k, name), dofs)
    flat, start = [], []
    for g in post.penalized_groups:
        start.append(len(flat))
        flat += list(g)
    _fill(k.pen_start, start)
    _fill(k.pen_count, [len(g) for g in post.penalized_groups])
    _fill(k.pen_pts, flat)
    _fill(k.reward_id, [REWARD_IDS[n] for n in post.reward_names])
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
    # the ETH terms have no sigma
    _fill(k.sigma, [getattr(rw, "sigma_" + n, 0.0) for n in post.reward_names])
    k.swing_target = rw.swing_feet_height_target
    k.swing_half = rw.swing_feet_height_target / 2
    k.swing_quarter = rw.swing_feet_height_target / 4
    k.fat_target = rw.feet_air_time_target
    k.fat_half = rw.feet_air_time_target / 2
    k.flt_max = rw.feet_land_time_max
    k.stumble_ratio = rw.feet_stumble_ratio
    k.swing_3q = rw.swing_feet_height_target * 3 / 4
    k.tracking_sigma = rw.tracking_sigma
    k.max_contact_force = rw.max_contact_force


def _make_constants(deci: ScalarDecimation, in_off, out_off, c_in, c_out):
    """The filled ``ModelConst`` of one program (``const_struct`` of its
    sizes); the post stage's fields stay zero without the fold."""
    sub = deci.sub
    c = sub.contact
    k = const_struct(program_sizes(deci, c_in, c_out))()
    nb, nd, np_ = sub.nb, sub.nd, sub.np_
    # ints
    _fill(k.parent, [max(p, 0) for p in sub.parent])
    lists = team_lists(sub)
    k.n_levels = lists.pop("n_levels")
    for name, values in lists.items():
        _fill(getattr(k, name), values)
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
    _fill(k.in_off, [in_off[g][0] if g in in_off else 0 for g in IN_GROUPS])
    _fill(k.out_off, [out_off[g][0] if g in out_off else 0 for g in OUT_GROUPS])
    k.decimation = deci.decimation
    k.use_tangent = int(c.tangent_stiffness > 0.0)
    k.use_joint_limits = int(c.joint_limit_violation > 0.0 and nd > 0)
    k.has_damp = int(deci.damping_coeff is not None)
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
    if deci.post is not None:
        _fill_post(k, deci)
    return k


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_CONST_OWNER = {}   # per library: the wrapper whose constants sit in its __constant__ memory


class CudaDecimation:
    """Callable wrapper: (batched tensors in) -> K1 -> (batched tensors out).

    The kernel path supports what the CUDA source implements: the three
    terrain modes, the P, V and T control laws, the program with and
    without the post fold (all 50 reward terms, penalized contact groups),
    and up to ``MAX_DOF`` dofs; anything else raises on a CUDA tensor. The
    kernel is built for this program's sizes, terrain mode, fold and
    control law (``sizes``) and team shape (``team``), one library per
    distinct set, at first use."""

    def __init__(self, deci: ScalarDecimation):
        self.deci = deci
        self.nd = deci.sub.nd
        self.np_ = deci.sub.np_
        self.nf = len(deci.feet_bodies)
        self.npost = len(deci.post_bodies)
        self.post = deci.post
        # the previous policy step's joint velocities: V's damping term and
        # the post stage's joint accelerations (pallas_step.py:104)
        self.with_last_qd = deci.control_type == "V" or self.post is not None
        self.plane_lanes = deci.sub.plane_lanes
        self.post_extra = self.post.extra_schema() if self.post else ()
        self.post_out = self.post.out_schema() if self.post else ()
        self.in_schema, self.out_schema = _schema(
            self.nd, self.np_, self.nf, self.with_last_qd, self.npost,
            self.plane_lanes, self.post_extra, self.post_out,
        )
        self.in_off, self.c_in = _offsets(self.in_schema)
        self.out_off, self.c_out = _offsets(self.out_schema)
        self.sizes = program_sizes(deci, self.c_in, self.c_out)
        self.team = team_shape(self.sizes)
        self._const = None
        self._const_dev = None   # the constants' bytes on the card (the captured upload's source)

    # -- what the kernel implements ------------------------------------------

    def kernel_support_error(self):
        """None if the CUDA kernel implements this program, else why not."""
        if self.sizes.ND > MAX_DOF:
            return f"{self.sizes.ND} dofs: the kernel's ancestor masks hold {MAX_DOF}"
        if self.post is None:
            return None
        missing = [n for n in self.post.reward_names if n not in REWARD_IDS]
        if missing:
            return f"reward terms without a CUDA implementation: {missing}"
        if len(self.post.termination_groups) > _MAXG:
            return f"more than {_MAXG} termination groups"
        return None

    # -- the call -----------------------------------------------------------

    def __call__(self, phys, actions, last_actions, motor, delay, rand, last_qd=None,
                 plane=None, extra=None):
        """Returns (new_phys, force_sum (N,F), vxyz_sum (N,F,3),
        vrpy_sum (N,F,3), tau (N,D), point_force (N,P,3),
        post_kin: (post_rel (N,R,3), post_quat (N,R,4)) or None,
        point_pos: (N,P,3) final-state contact points (terrain modes) or None,
        post_out: dict of (N, cnt) tensors per LanePost.out_schema or None).
        ``plane``: (N, P, 3) or (N, P, 9) ground lanes in the terrain modes."""
        if (plane is None) != (self.plane_lanes == 0):
            raise ValueError(f"terrain mode {self.deci.sub.terrain_mode!r} "
                             f"{'takes' if self.plane_lanes else 'takes no'} plane= input")
        if actions.device.type == "cpu":
            return self.plain(phys, actions, last_actions, motor, delay, rand, last_qd, extra, plane)
        if actions.device.type != "cuda":
            raise RuntimeError(f"K1 runs on CUDA tensors, got device {actions.device}")
        return self._launch(phys, actions, last_actions, motor, delay, rand, last_qd, extra, plane)

    # -- kernel path -----------------------------------------------------------

    def _pack(self, phys, actions, last_actions, motor, delay, rand, last_qd=None, extra=None,
              plane=None):
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
        if self.plane_lanes:
            cols.append(plane.reshape(n, self.plane_lanes * self.np_))
        for name, cnt in self.post_extra:
            cols.append(extra[name].reshape(n, cnt))
        comp = torch.cat([x.to(torch.float32) for x in cols], dim=1).t().contiguous()
        assert comp.shape == (self.c_in, n)
        return comp

    def _launch(self, phys, actions, last_actions, motor, delay, rand, last_qd, extra, plane):
        n = actions.shape[0]
        comp = self._pack(phys, actions, last_actions, motor, delay, rand, last_qd, extra, plane)
        out = torch.empty((self.c_out, n), dtype=torch.float32, device=actions.device)
        self.launch_packed(comp, out)
        _build.count_launch("k1")
        return self._unpack(out, phys, n)

    def launch_packed(self, comp, out, kernel="team"):
        """One launch on packed buffers, ``comp`` (C_in, N) -> ``out``
        (C_out, N), both contiguous float32 on the card: the team kernel
        (``kernel="team"``, the main path's), or the one-thread kernel
        (``kernel="thread"``), the team kernel's bit-for-bit reference. The main path reaches it
        through ``__call__`` only, which counts the launch; checks and
        timings call it directly, uncounted."""
        why = self.kernel_support_error()
        if why is not None:
            raise NotImplementedError(f"K1 on CUDA: {why}")
        n = comp.shape[1]
        if (comp.shape != (self.c_in, n) or out.shape != (self.c_out, n)
                or comp.dtype != torch.float32 or out.dtype != torch.float32
                or not (comp.is_contiguous() and out.is_contiguous())
                or comp.device.type != "cuda" or out.device != comp.device):
            raise ValueError("K1 takes contiguous float32 (C_in, N) and (C_out, N) CUDA buffers")
        lib = _load(self.sizes)
        dev = comp.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        with torch.cuda.device(dev):
            if capturing:
                self._capture_constants(lib, dev, stream)
            else:
                if self._const is None:
                    self._const = _make_constants(
                        self.deci, self.in_off, self.out_off, self.c_in, self.c_out
                    )
                    self._const_dev = torch.frombuffer(bytearray(bytes(self._const)), dtype=torch.uint8).to(dev)
                if _CONST_OWNER.get(self.sizes) is not self:
                    err = lib.k1_set_constants(
                        ctypes.addressof(self._const), ctypes.sizeof(self._const), stream
                    )
                    if err != 0:
                        raise RuntimeError(f"k1_set_constants failed: CUDA error {err}")
                    _CONST_OWNER[self.sizes] = self
            if kernel == "thread":
                err = lib.k1_launch_thread(comp.data_ptr(), out.data_ptr(), n, stream)
            elif kernel == "team":
                err = lib.k1_launch(comp.data_ptr(), out.data_ptr(), n, stream)
            else:
                raise ValueError(f"unknown K1 kernel {kernel!r}")
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")

    def _capture_constants(self, lib, dev, stream):
        """Under a capture: record the copy of this wrapper's constants from
        the card into the symbol, and let each replay make it the owner."""
        tally = _build.current_tally()
        if tally is None:
            raise RuntimeError("K1 captured outside build.capture_tally: its launches would go uncounted")
        if self._const_dev is None or self._const_dev.device != dev:
            raise RuntimeError("K1's constants are not on the card yet: launch it once before a capture")
        err = lib.k1_copy_constants(self._const_dev.data_ptr(), self._const_dev.numel(), stream)
        if err != 0:
            raise RuntimeError(f"k1_copy_constants failed under capture: CUDA error {err}")
        tally.after_replay.append(functools.partial(_CONST_OWNER.__setitem__, self.sizes, self))

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
        point_pos = take("point_pos").reshape(n, self.np_, 3) if self.plane_lanes else None
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
            point_pos,
            post_out,
        )

    # -- plain path (the lane program; any device) -----------------------------

    def plain(self, phys, actions, last_actions, motor, delay, rand, last_qd=None,
              extra=None, plane=None):
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
        if self.plane_lanes:
            lanes["plane"] = [col(plane[:, p]) for p in range(self.np_)]
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
        point_pos = None
        if self.plane_lanes:
            point_pos = torch.stack([stack(p) for p in acc["point_pos"]], dim=-2)
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
            point_pos,
            post_out,
        )


def team_occupancy(op: CudaDecimation):
    """The team kernel's lanes per env, envs per block, dynamic shared
    memory per block in bytes, and resident blocks per SM on the current
    card, for the library ``op`` launches."""
    lib = _load(op.sizes)
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.k1_occupancy(*[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"k1_occupancy failed: CUDA error {err}")
    return dict(zip(("threads_per_env", "envs_per_block", "smem_bytes_per_block", "blocks_per_sm"),
                    (v.value for v in vals)))


def task_env(task, n, device, mutate=None):
    """The training env of ``task`` at ``n`` envs on ``device``;
    ``mutate(cfg)`` changes the config first. Its ``decimation_op`` names
    the K1 library (sizes and team shape) the task runs on."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = n
    if mutate is not None:
        mutate(cfg)
    return task_registry.make_env(task, env_cfg=cfg, device=device)[0]


def reachable_state(n, device, steps=8, seed=0, task="GR1T1", mutate=None, spread=None):
    """(env, state): :func:`task_env` at ``n`` envs, ``steps`` policy steps
    after ``init_state`` with random actions (the robots land on their
    feet), everything drawn from ``seed``. The states K1 is checked and
    timed on. On terrain, ``spread`` (m) places each robot anywhere within
    that distance of its cell's origin, dropped from its init height above
    the highest ground within 0.3 m, instead of on the flat platform at the
    origin (so that feet land on stairs, slopes and stones)."""
    env = task_env(task, n, device, mutate)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = env.init_state(gen)
    if spread is not None:
        xy = state.env_origins[:, :2] + spread * (2.0 * torch.rand(n, 2, generator=gen, device=device) - 1.0)
        g = torch.linspace(-0.3, 0.3, 5, device=device)
        gx, gy = torch.meshgrid(g, g, indexing="ij")
        ground = env.terrain.height(xy, xy[:, :1] + gx.reshape(1, -1), xy[:, 1:] + gy.reshape(1, -1))
        z = ground.amax(dim=1, keepdim=True) + float(env.cfg.init_state.pos[2])
        state = state.replace(physics=state.physics.replace(base_pos=torch.cat([xy, z], dim=1)))
        state = env._refresh_ground_plane(state, torch.ones(n, dtype=torch.bool, device=device), force=True)
    for _ in range(steps):
        state, _ = env.step(state, 0.3 * torch.randn(n, env.num_actions, device=device, generator=gen))
    return env, state


def decimation_inputs(env, state, gen, dtype=None):
    """(args, kwargs) that ``env.step`` hands K1 from ``state``, on fresh
    random actions and delays drawn from ``gen``; every float cast to
    ``dtype`` if given. The ground lanes are the state's (sampled by the
    env) in the terrain modes."""
    n = env.num_envs
    actions = env.clip_actions(0.3 * torch.randn(n, env.num_actions, device=env.device, generator=gen))
    delay = 3.0 * torch.rand(n, device=env.device, generator=gen)
    c = (lambda x: x.to(dtype)) if dtype is not None else (lambda x: x)
    phys = state.physics.replace(**{k: c(getattr(state.physics, k)) for k in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")})
    rand = state.rand.replace(**{k: c(getattr(state.rand, k)) for k in (
        "friction", "restitution", "base_mass_scale", "base_com_offset")})
    args = (phys, c(actions), c(state.last_actions), c(state.motor_strength), c(delay), rand)
    kw = dict(last_qd=c(state.last_dof_vel), extra=None,
              plane=None if state.ground_plane is None else c(state.ground_plane))
    if env.decimation_op.post is not None:
        kw["extra"] = {k: c(v) for k, v in env.post_extra(state, state.commands).items()}
    return args, kw


def point_positions(env, state):
    """((N, P, 3) world positions of the contact points of ``state``, by its
    FK; (1, P) their radii)."""
    from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics
    from wiki_grx_gym_tpu_torch.utils import maths

    m, ph = env.model, state.physics
    kin = forward_kinematics(m, ph.base_quat, ph.base_ang_vel, ph.base_lin_vel, ph.q, ph.qd)
    pb = torch.tensor(m.point_body, dtype=torch.long, device=ph.q.device)
    rel, quat = kin.pos_rel[:, pb], kin.quat[:, pb]
    pos = ph.base_pos[:, None, :] + rel + maths.quat_apply(quat, m.point_offset.to(rel).expand_as(rel))
    return pos, m.point_radius.to(rel)[None, :]


def wall_contacts(env, state, plane):
    """(points in contact with a riser wall, points whose tread force a
    riser solid suppresses), (N, P) booleans, for the (N, P, 9) ground
    lanes ``plane`` at the contact points of ``state`` (the first substep's
    positions): the conditions of the ``local_plane_walls`` contact."""
    pos, r = point_positions(env, state)
    active = torch.zeros(pos.shape[:2], dtype=torch.bool, device=pos.device)
    inside = torch.zeros_like(active)
    for ax in range(2):
        wp, top, sign = plane[..., 3 + 3 * ax], plane[..., 4 + 3 * ax], plane[..., 5 + 3 * ax]
        below = pos[..., 2] < top
        d = sign * (pos[..., ax] - wp)
        active |= (sign != 0) & (d + r > 0) & below
        inside |= (sign != 0) & (d > 0) & below
    return active, inside


def planted_planes(env, state, walls: bool):
    """(N, P, 3) or, with ``walls``, (N, P, 9) ground lanes planted at each
    contact point of ``state`` (its position from the state's FK) so that
    every branch of the terrain contact runs: a tilted tread plane 4 mm
    above the point's bottom (in contact), and per axis, by point and env,
    no wall, a wall in contact, a wall whose solid holds the point's center
    (the tread force suppressed), or a wall whose top is below the point."""
    pos, r = point_positions(env, state)
    x, y, z = pos.unbind(-1)
    gx, gy = torch.full_like(x, 0.2), torch.full_like(x, -0.1)
    lanes = [z - r + 0.004 - gx * x - gy * y, gx, gy]
    if walls:
        n, p = x.shape
        kind = (torch.arange(p, device=x.device)[None, :] + torch.arange(n, device=x.device)[:, None]) % 4
        for ax, coord in enumerate((x, y)):
            k = (kind + ax) % 4
            sign = torch.where(k == 0, 0.0, torch.where(k == 2, -1.0, 1.0)).to(x.dtype)
            # 1: in contact from the -side; 2: the center inside the solid; 3: below the top
            wpos = torch.where(k == 1, coord + 0.5 * r, torch.where(k == 2, coord + 0.01, coord - 0.01))
            top = torch.where(k == 3, z - 0.1, z + 0.5)
            lanes += [wpos, top, sign]
    return torch.stack(lanes, dim=-1)


def planted_all_terms(env, state):
    """``state`` planted so that every reward term of ``all_terms_config``
    is non-zero in some env: every 4th env dropped to 0.35 m and pitched
    forward by 1.2 rad (its thigh and shank points touch the plane: the
    penalized groups); the next env of each four with every joint 0.1 rad
    past its soft upper limit (the position-limit terms); the next with
    friction 6 (a foot's horizontal force may then exceed 5 times its
    normal force: ``stumble``; below a friction of 5 the cone forbids it)."""
    ph, rand = state.physics, state.rand
    dev, n = ph.base_pos.device, ph.base_pos.shape[0]
    idx = torch.arange(n, device=dev) % 4
    pos, quat, q = ph.base_pos.clone(), ph.base_quat.clone(), ph.q.clone()
    low = idx == 0
    pos[low, 2] = 0.35
    quat[low] = torch.tensor([0.0, math.sin(0.6), 0.0, math.cos(0.6)], device=dev, dtype=quat.dtype)
    past = idx == 1
    q[past] = torch.as_tensor(env.dof_pos_soft_upper, dtype=q.dtype, device=dev) + 0.1
    friction = torch.where(idx == 2, torch.full_like(rand.friction, 6.0), rand.friction)
    return state.replace(physics=ph.replace(base_pos=pos, base_quat=quat, q=q),
                         rand=rand.replace(friction=friction))


def terrain_config(mesh_type, rows=None, cols=None):
    """A config change (``mutate``): ``mesh_type`` terrain with the
    curriculum on, as the reference bench sets it (``bench.py:95-97``), on
    the config's grid or on a ``rows`` x ``cols`` one."""
    def mutate(cfg):
        t = cfg.terrain
        t.mesh_type, t.curriculum = mesh_type, True
        if rows is not None:
            t.num_rows, t.num_cols, t.max_init_terrain_level = rows, cols, rows - 1
    mutate.__name__ = mesh_type if rows is None else f"{mesh_type}_{rows}x{cols}"
    return mutate


def heading_config(cfg):
    """A config change (``mutate``): heading commands (a 4th command, the
    heading target), on the plane."""
    cfg.commands.heading_command = True
    cfg.commands.num_commands = 4


# the scales config (a) gives the terms a task leaves at 0: legged_gym's
# defaults for its base terms, +-0.1 for the FFTAI terms (a reward of
# exp(sigma * err) gets +0.1, a penalty of 1 - exp(sigma * err) -0.1)
ALL_TERM_SCALES = {
    "tracking_lin_vel": 1.0, "tracking_ang_vel": 0.5, "lin_vel_z": -2.0, "ang_vel_xy": -0.05,
    "orientation": -1.0, "torques": -1e-5, "dof_vel": -1e-4, "dof_acc": -2.5e-7,
    "base_height": -1.0, "collision": -1.0, "action_rate": -0.01, "dof_pos_limits": -10.0,
    "dof_vel_limits": -1.0, "torque_limits": -1.0, "feet_contact_forces": -0.01, "stumble": -1.0,
    "cmd_diff_ang_vel_roll": 0.1, "cmd_diff_ang_vel_pitch": 0.1, "cmd_diff_forehead_orient": 0.1,
    "feet_speed_z_close_to_height_target": 0.1,
}


def all_terms_config(cfg):
    """A config change (``mutate``): every lane-form reward term of the
    fold at a non-zero scale (``ALL_TERM_SCALES`` where the task has 0, else
    -0.1), contacts penalized on the thighs and shanks, and the soft torque
    and joint-velocity limits lowered to 0.5 (at 1.0 ``torque_limits`` and
    ``limits_dof_tor`` are 0 by construction: the torques are clipped to
    their limits)."""
    scales = cfg.rewards.scales
    for name in REWARD_IDS:
        if not getattr(scales, name, 0.0):
            setattr(scales, name, ALL_TERM_SCALES.get(name, -0.1))
    cfg.asset.penalize_contacts_on = ["thigh", "shank"]
    cfg.rewards.soft_torque_limit = 0.5
    cfg.rewards.soft_dof_vel_limit = 0.5


def control_config(control_type, then=None):
    """A config change (``mutate``): the control law ``control_type`` ("P",
    "V" or "T"), after the change ``then`` if given."""
    def mutate(cfg):
        if then is not None:
            then(cfg)
        cfg.control.control_type = control_type
    mutate.__name__ = control_type if then is None else f"{control_type}_{then.__name__}"
    return mutate


def reachable_case(n, device, planted=False, plant_terms=False, **how):
    """(decimation op, packed (C_in, n) input, the wrapper's positional
    arguments, its keyword arguments) on :func:`reachable_state` (``how``:
    its ``steps``, ``task``, ``mutate``) with fresh random actions and delays
    (seed 1); ``planted``: the terrain modes' ground lanes from
    :func:`planted_planes` instead of the env's; ``plant_terms``: the
    states of :func:`planted_all_terms`."""
    env, state = reachable_state(n, device, **how)
    if planted:
        state = state.replace(ground_plane=planted_planes(env, state, env.riser_mode))
    if plant_terms:
        state = planted_all_terms(env, state)
    args, kw = decimation_inputs(env, state, torch.Generator(device=device).manual_seed(1))
    op = env.decimation_op
    return op, op._pack(*args, **kw), args, kw
