"""Legged-robot RL environment, PyTorch port.

Port of ``wiki_grx_gym_tpu/envs/legged_env.py`` with the P, V and T
control laws, on the flat plane or on a heightfield/trimesh terrain grid (``terrain/composer``),
with or without heading commands. One ``step(state, actions)`` does:

    clip actions (per-joint boxes)
    draw the step's ONE uniform block U (delay, obs noise, commands,
        resets, pushes are column slices of it; ``u=`` injects it)
    command resampling on schedule
    the decimation loop: delay gate -> PD torques -> 10 physics substeps,
        on the backend ``cfg.sim.use_pallas`` picks (:func:`physics_backend`):
        K1 (``sim/cuda_step.py``, with (post fold) rewards, termination and
        feet trackers), its lane program, or the batched engine
        (``sim/engine.physics_step``, :meth:`LeggedEnv._decimation_scan`)
    (no fold) the post stage here: heading yaw command, base-frame
        quantities, measured heights, feet trackers, termination, the
        reward terms of ``envs/rewards.py``
    episode sums, pushes, branchless resets (terrain curriculum), the next
        step's ground planes (terrain, K1 and lanes), observations

The post stage runs inside K1 or its lane program (the fold) on the plane
without heading commands, and here otherwise (``_post_fold``), as in the
JAX env; the engine path always runs it here.

State is a dataclass of (N, ...) tensors on the env's device; its ``rng`` is
a ``torch.Generator`` that ``step`` draws from in place. ``step`` reads no
device value on the host and copies nothing from the host (its constants
are made once, in ``__init__``; the terrain refresh phase is decided on the
device from ``common_step``, as JAX's ``lax.cond``), so a CUDA graph can
capture it: :meth:`LeggedEnv.step_graph` (the counterpart of JAX's
``step_jit``) replays one such graph per env and batch shape. In a data-parallel
run the env is one rank's shard of the envs (``shard``), and the command
curriculum's mean over resetting envs is the one collective of a step (an
all-reduce of a sum and a count, as JAX's global mean). Outside these paths
the env refuses with ``NotImplementedError`` naming the ROADMAP item: K1
with models of more than ``MAX_DOF`` (32) dofs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.device import resolve_device
from wiki_grx_gym_tpu_torch.envs.base_config import class_to_dict
from wiki_grx_gym_tpu_torch.envs.rewards import REWARDS, RewardContext
from wiki_grx_gym_tpu_torch.models.robot import RobotModel
from wiki_grx_gym_tpu_torch.sim.contact import ContactParams
from wiki_grx_gym_tpu_torch.sim.cuda_step import MAX_DOF
from wiki_grx_gym_tpu_torch.sim.engine import BodyRandomization, PhysicsState, flat_ground, physics_step
from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics
from wiki_grx_gym_tpu_torch.sim.scalarized import CONTROL_TYPES
from wiki_grx_gym_tpu_torch.utils import maths
from wiki_grx_gym_tpu_torch.utils.maths import _cross, _div


def physics_backend(use_pallas, device) -> str:
    """The physics backend that ``cfg.sim.use_pallas`` asks for on
    ``device`` (the counterpart of the JAX env's ``_pallas_mode``):

    - ``False`` / ``"off"``: ``"engine"``, the batched engine
      (``sim/engine.physics_step``), on either device;
    - ``"lanes"`` / ``"interpret"``: ``"lanes"``, K1's plain version (the
      lane program), on either device;
    - ``True`` / ``"on"``: ``"kernel"``, K1; on the CPU it raises (there is
      no kernel there, and nothing falls back);
    - ``"auto"``: ``"kernel"`` on CUDA, ``"lanes"`` on the CPU.

    Any other value raises. ``"auto"`` differs from the JAX package's on
    purpose: there it picks the Pallas kernel on a TPU and the engine
    elsewhere; the port's accelerator is the CUDA card, where K1 runs."""
    device = torch.device(device)
    if use_pallas is False or use_pallas == "off":
        return "engine"
    if use_pallas in ("lanes", "interpret"):
        return "lanes"
    if use_pallas is True or use_pallas == "on":
        if device.type != "cuda":
            raise ValueError(f"cfg.sim.use_pallas={use_pallas!r} asks for K1, which runs on a CUDA card, "
                             f"not on device {device}; use False (the engine) or 'lanes' there")
        return "kernel"
    if use_pallas == "auto":
        return "kernel" if device.type == "cuda" else "lanes"
    raise ValueError(f"unknown cfg.sim.use_pallas {use_pallas!r}: one of False/'off', 'lanes', "
                     "'interpret', True/'on', 'auto'")

@dataclasses.dataclass
class EnvState:
    """Batched (num_envs, ...) environment state."""

    physics: PhysicsState
    rng: torch.Generator             # drawn from in place by step/reset
    episode_length: torch.Tensor     # (N,) int32
    common_step: torch.Tensor        # () int32, push-interval counter
    commands: torch.Tensor           # (N, 3)
    actions: torch.Tensor            # (N, A) current clipped actions
    last_actions: torch.Tensor       # (N, A)
    last_last_actions: torch.Tensor  # (N, A)
    last_dof_vel: torch.Tensor       # (N, D)
    torques: torch.Tensor            # (N, D) last applied torques
    feet_air_time: torch.Tensor      # (N, F)
    feet_land_time: torch.Tensor     # (N, F)
    feet_contact_last: torch.Tensor  # (N, F) bool
    episode_sums: torch.Tensor       # (N, R) per-reward episode sums
    rand: BodyRandomization          # per-env scalars, (N,) leaves
    motor_strength: torch.Tensor     # (N, D)
    env_origins: torch.Tensor        # (N, 3)
    terrain_levels: torch.Tensor     # (N,) int32
    terrain_types: torch.Tensor      # (N,) int32
    cmd_lin_vel_x_range: torch.Tensor  # (2,) command-curriculum state
    # (N, P, 3) per-point ground planes (c, gx, gy), (N, P, 9) with the riser
    # walls on trimesh; None on the plane
    ground_plane: Optional[torch.Tensor] = None
    # (N, H) measured heights, carried between refreshes when
    # terrain.refresh_interval > 1; None otherwise
    measured_cache: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


class StepOutput(NamedTuple):
    obs: torch.Tensor
    pri_obs: torch.Tensor
    rew: torch.Tensor
    reset: torch.Tensor
    extras: Dict[str, Any]


class LeggedEnv:
    """Static env tables + step/reset functions on one device.

    Name-to-index resolution, reward selection, gain matching and layout
    checks happen here, once, on the host. Host constants are numpy float32
    arrays (as the JAX env's); their device copies carry a ``_t`` suffix."""

    spans = None   # the collection graph's marks while it is captured (learn/spans.py), else None

    def __init__(self, cfg, model: RobotModel, terrain=None, device="cuda", shard=None, dp=None):
        """``terrain``: a ``terrain.composer.Terrain`` on ``device`` (the
        registry builds it for mesh_type heightfield/trimesh), or None for
        the flat plane. ``shard``: ``(lo, hi)``, the envs of the
        ``cfg.env.num_envs`` this env holds (one rank's of a data-parallel
        run, ``parallel.sharding.shard_bounds``; default all): the plane's
        origin grid and the terrain types follow the global env index.
        ``dp``: the run's ``parallel.mesh.DataParallel``, over which the
        command curriculum's mean is taken."""
        self.device = resolve_device(device)
        if cfg.control.control_type not in CONTROL_TYPES:
            raise ValueError(f"unknown control_type {cfg.control.control_type!r}")
        # read once: the engine, K1's lane program, or K1
        self.backend = physics_backend(getattr(cfg.sim, "use_pallas", "auto"), self.device)
        if self.backend == "kernel" and model.num_dof > MAX_DOF:
            raise NotImplementedError(
                f"{model.num_dof}-DOF model: the decimation kernel K1 takes at most "
                f"{MAX_DOF} dofs (ROADMAP queue 2, K1)"
            )
        self.cfg = cfg
        if getattr(cfg.asset, "disable_gravity", False):
            model = model.replace(gravity_scale=0.0)
        self.model = model
        self.terrain = terrain

        c = cfg
        self.num_envs_global = int(c.env.num_envs)
        self.shard = (0, self.num_envs_global) if shard is None else (int(shard[0]), int(shard[1]))
        if not 0 <= self.shard[0] < self.shard[1] <= self.num_envs_global:
            raise ValueError(f"shard {self.shard} outside {self.num_envs_global} envs")
        if dp is not None and dp.device != self.device:
            raise ValueError(f"rank {dp.rank} runs on {dp.device}, the env on {self.device}")
        self.dp = dp
        self.num_envs = self.shard[1] - self.shard[0]
        self.num_actions = int(c.env.num_actions)
        self.num_dof = model.num_dof
        assert self.num_actions == self.num_dof, (
            f"num_actions {self.num_actions} != num_dof {self.num_dof}"
        )
        self.decimation = int(c.control.decimation)
        self.sim_dt = float(c.sim.dt)
        self.dt = self.sim_dt * self.decimation
        self.max_episode_length_s = float(c.env.episode_length_s)
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))
        self.resample_interval = int(c.commands.resampling_command_interval_s / self.dt)
        self.push_interval = int(np.ceil(c.domain_rand.push_interval_s / self.dt))

        # --- per-DOF constants ---
        dof_names = model.dof_names
        default_pos = np.zeros(self.num_dof, np.float32)
        p_gains = np.zeros(self.num_dof, np.float32)
        d_gains = np.zeros(self.num_dof, np.float32)
        for i, name in enumerate(dof_names):
            default_pos[i] = c.init_state.default_joint_angles[name]
            for key, kp in c.control.stiffness.items():
                if key in name:
                    p_gains[i] = kp
                    d_gains[i] = c.control.damping[key]
        self.default_dof_pos = default_pos
        self.p_gains = p_gains
        self.d_gains = d_gains
        self.torque_limits = model.dof_effort_limit.numpy()
        self.dof_vel_limits = model.dof_vel_limit.numpy()

        lo = model.dof_lower.numpy()
        hi = model.dof_upper.numpy()
        mid, rng_ = (lo + hi) / 2, hi - lo
        soft = c.rewards.soft_dof_pos_limit
        self.dof_pos_soft_lower = mid - 0.5 * rng_ * soft
        self.dof_pos_soft_upper = mid + 0.5 * rng_ * soft

        # --- action clip boxes ---
        amax = np.array(
            [self._match_by_name(c.normalization.actions_max, n) for n in dof_names],
            np.float32,
        )
        amin = np.array(
            [self._match_by_name(c.normalization.actions_min, n) for n in dof_names],
            np.float32,
        )
        if getattr(c.normalization, "clip_margin_mode", "span") == "deg30":
            margin = np.deg2rad(30.0) * np.ones_like(amax)
        else:
            margin = (np.abs(amax) + np.abs(amin)) * 0.01
        # the deg30 margin is float64: round the boxes once, as jnp.asarray does
        self.clip_actions_max = (amax + margin).astype(np.float32)
        self.clip_actions_min = (amin - margin).astype(np.float32)

        # --- named body/joint groups ---
        self.feet_links = model.find_links(c.asset.foot_name)
        assert len(self.feet_links) >= 1, "no feet found"
        self.num_feet = len(self.feet_links)
        self.feet_bodies = tuple(model.link_frame(l)[0] for l in self.feet_links)
        self.feet_offsets = torch.stack(
            [model.link_frame(l)[1] for l in self.feet_links]
        ).numpy()  # (F, 3)

        self.knee_dofs = model.find_dofs(c.asset.knee_name)
        self.hip_roll_dofs = model.find_dofs(c.asset.hip_roll_name)
        self.hip_yaw_dofs = model.find_dofs(c.asset.hip_yaw_name)
        self.ankle_dofs = model.find_dofs(c.asset.ankle_name)

        self.torso_frame = self._opt_frame(c.asset.torso_name + "_link")
        self.forehead_frame = self._opt_frame(getattr(c.asset, "forehead_name", "") + "_link")

        # --- contact groups: per-foot, termination links, penalized links ---
        def link_points(link):
            return tuple(
                p for p in range(model.num_points)
                if model.point_link[p] == model.link_names.index(link)
            )

        self.feet_point_groups = tuple(link_points(l) for l in self.feet_links)
        term_links = []
        for sub in c.asset.terminate_after_contacts_on:
            term_links.extend(model.find_links(sub))
        self.termination_links = tuple(
            l for l in dict.fromkeys(term_links) if link_points(l)
        )
        self.termination_groups = tuple(link_points(l) for l in self.termination_links)
        pen_links = []
        for sub in c.asset.penalize_contacts_on:
            pen_links.extend(model.find_links(sub))
        self.penalized_links = tuple(l for l in dict.fromkeys(pen_links) if link_points(l))
        self.penalized_groups = tuple(link_points(l) for l in self.penalized_links)

        # --- self-collision candidate pairs (self_collisions == 0 = enabled) ---
        if getattr(c.asset, "self_collisions", 0) == 0 and model.num_points:
            self.self_pairs = self._build_self_pairs()
        else:
            self.self_pairs = ((), ())

        # --- height measurement grid ---
        gx, gy = np.meshgrid(
            np.asarray(c.terrain.measured_points_x, np.float32),
            np.asarray(c.terrain.measured_points_y, np.float32),
            indexing="ij",
        )
        self.height_points = np.stack([gx.flatten(), gy.flatten()], axis=-1)  # (H, 2)
        # measure_heights gates the sampling and the privileged obs: with it
        # off the surround-heights segment is one zero column
        self.measure_heights = bool(getattr(c.terrain, "measure_heights", True))
        self.num_height_points = len(self.height_points) if self.measure_heights else 1
        # terrain-sample refresh period in policy steps: k > 1 resamples the
        # ground planes and the measured grid every k-th step and carries
        # them in between
        self.refresh_interval = int(getattr(c.terrain, "refresh_interval", 1) or 1)
        # trimesh: stair risers above the slope threshold are walls; the
        # contact points then read the 9-channel ground query
        self.riser_mode = terrain is not None and terrain.slope_threshold_raw is not None
        # the engine's ground: the plane or the terrain's whole-field lookups
        self.height_fn = flat_ground if terrain is None else terrain.height_fn
        self.ground_query = terrain.ground_query if self.riser_mode else None

        self.contact_params = ContactParams(
            stiffness=c.sim.contact_stiffness,
            damping_ratio=c.sim.contact_damping_ratio,
            point_mass=c.sim.contact_point_mass,
            slip_velocity=c.sim.slip_velocity,
            tangent_stiffness=getattr(c.sim, "contact_tangent_stiffness", 1.0e4),
            joint_limit_violation=getattr(c.sim, "joint_limit_violation", 0.05),
            self_collision_stiffness=getattr(c.sim, "contact_self_collision_stiffness", 1.0e5),
        )

        # --- reward selection: drop zero scales, multiply by dt ---
        raw_scales = class_to_dict(c.rewards.scales)
        self.reward_names: Tuple[str, ...] = tuple(
            n for n, s in raw_scales.items() if s != 0 and n != "termination"
        )
        self.reward_scales = {n: raw_scales[n] * self.dt for n in self.reward_names}
        self.termination_scale = (
            raw_scales.get("termination", 0.0) * self.dt if raw_scales.get("termination") else 0.0
        )
        self.all_reward_names = self.reward_names + (
            ("termination",) if "termination" in raw_scales and raw_scales["termination"] != 0 else ()
        )
        for n in self.reward_names:
            assert n in REWARDS, f"unknown reward {n!r}"

        # --- observation noise vector ---
        self.noise_scale_vec = self._build_noise_vec()
        self.commands_scale = np.asarray(
            [
                c.normalization.obs_scales.lin_vel,
                c.normalization.obs_scales.lin_vel,
                c.normalization.obs_scales.ang_vel,
            ],
            np.float32,
        )

        assert self.obs_dim == c.env.num_obs, (self.obs_dim, c.env.num_obs)
        if c.env.num_pri_obs is not None:
            assert self.pri_obs_dim == c.env.num_pri_obs, (self.pri_obs_dim, c.env.num_pri_obs)

        # --- env origins: sampled from the terrain grid at init, or a grid
        # on the plane ---
        self.custom_origins = terrain is not None
        n_all = self.num_envs_global
        cols = int(np.floor(np.sqrt(n_all)))
        rows = int(np.ceil(n_all / cols))
        xx, yy = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        spacing = c.env.env_spacing
        org = np.zeros((n_all, 3), np.float32)
        org[:, 0] = spacing * xx.flatten()[:n_all]
        org[:, 1] = spacing * yy.flatten()[:n_all]
        self._origins_np = org[self.shard[0]:self.shard[1]]

        # --- device copies of the constants the step reads ---
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self.default_dof_pos_t = t(self.default_dof_pos)
        self.clip_actions_min_t = t(self.clip_actions_min)
        self.clip_actions_max_t = t(self.clip_actions_max)
        self.noise_scale_vec_t = t(self.noise_scale_vec)
        self.commands_scale_t = t(self.commands_scale)
        self.init_pos_t = t(c.init_state.pos)
        self.init_rot_t = t(c.init_state.rot)
        self.dof_pos_soft_lower_t = t(self.dof_pos_soft_lower)
        self.dof_pos_soft_upper_t = t(self.dof_pos_soft_upper)
        self.dof_vel_limits_t = t(self.dof_vel_limits)
        self.p_gains_t = t(self.p_gains)
        self.d_gains_t = t(self.d_gains)
        self.torque_limits_t = t(self.torque_limits)
        self.height_points_t = t(self.height_points)
        self.feet_offsets_t = t(self.feet_offsets)
        # the step's small constant vectors: gravity's direction, the heading's
        # forward axis, the welded frames' quaternions
        self.down_t = t([0.0, 0.0, -1.0])
        self.forward_t = t([1.0, 0.0, 0.0])
        self.frame_qoff_t = {name: t(fr[1]) for name, fr in (("torso", self.torso_frame),
                                                             ("forehead", self.forehead_frame))
                             if fr is not None}
        self._step_graphs = {}   # step_graph's CUDA graphs, per batch shape
        self._index_cache = {}   # index_t's device index tensors

    # ------------------------------------------------------------------
    # build helpers
    # ------------------------------------------------------------------

    def index_t(self, idx) -> torch.Tensor:
        """A static index sequence (dofs, bodies, contact points) as an int64
        tensor on the env's device, made at its first use and kept: the
        step indexes with these, never with a Python list, whose host copy
        a CUDA graph's capture refuses."""
        key = tuple(int(i) for i in idx)
        t = self._index_cache.get(key)
        if t is None:
            t = self._index_cache[key] = torch.tensor(key, dtype=torch.long, device=self.device)
        return t

    @staticmethod
    def _match_by_name(table: dict, dof_name: str) -> float:
        for key, val in table.items():
            if key in dof_name:
                return float(val)
        raise KeyError(f"no action box for dof {dof_name!r}")

    def _opt_frame(self, link_name):
        try:
            body, pos, quat = self.model.link_frame(link_name)
            return (body, quat.numpy())
        except KeyError:
            return None

    @property
    def obs_dim(self) -> int:
        return 3 + 3 + 3 + 3 * self.num_dof

    @property
    def pri_obs_dim(self) -> int:
        return self.obs_dim + 3 + 1 + 2 * self.num_feet + self.num_height_points

    def _build_noise_vec(self) -> np.ndarray:
        c = self.cfg
        ns, level = c.noise.noise_scales, c.noise.noise_level
        os_ = c.normalization.obs_scales
        v = np.zeros(self.obs_dim, np.float32)
        v[0:3] = 0.0  # commands
        v[3:6] = ns.ang_vel * level * os_.ang_vel
        v[6:9] = ns.gravity * level * os_.gravity
        d = self.num_dof
        v[9: 9 + d] = ns.dof_pos * level * os_.dof_pos
        v[9 + d: 9 + 2 * d] = ns.dof_vel * level * os_.dof_vel
        v[9 + 2 * d: 9 + 3 * d] = ns.action * level * os_.action
        return v

    def _cross_limb_gaps(self):
        """(point_i, point_j, gap in m at the default pose) of every pair of
        proxy spheres on different limbs (different child subtrees of the
        base). The gaps are float32, as the JAX env's, so a gap near the
        pair threshold falls on the same side."""
        model = self.model

        def limb_root(body):
            while body > 0 and model.parent[body] != 0:
                body = model.parent[body]
            return body

        pos = self._default_point_rel.cpu().numpy()
        radius = model.point_radius.numpy()
        out = []
        for a in range(model.num_points):
            for b in range(a + 1, model.num_points):
                ba, bb = model.point_body[a], model.point_body[b]
                if ba == 0 or bb == 0 or limb_root(ba) == limb_root(bb):
                    continue
                out.append((a, b, np.linalg.norm(pos[a] - pos[b]) - (radius[a] + radius[b])))
        return out

    def _build_self_pairs(self):
        """Static self-collision pair list: the cross-limb pairs separated
        by more than 2 cm at the default pose."""
        pairs = [(a, b) for a, b, gap in self._cross_limb_gaps() if gap > 0.02]
        return (tuple(a for a, _ in pairs), tuple(b for _, b in pairs))

    def _pd_torques(self, q, qd, actions, motor_strength, last_qd=None):
        """The control law on (N, D) tensors: P, V or T. V's damping term
        takes the change of joint velocity since the previous policy step
        (``last_qd``) over the sim dt. K1 runs the same law in component
        form (``ScalarDecimation.torques``)."""
        c = self.cfg.control
        scaled = actions * c.action_scale
        p, d = self.p_gains_t.to(q), self.d_gains_t.to(q)
        if c.control_type == "P":
            tau = p * (scaled + self.default_dof_pos_t.to(q) - q) - d * qd
        elif c.control_type == "V":
            tau = p * (scaled - qd) - _div(d * (qd - last_qd), self.sim_dt)
        else:
            tau = scaled
        lim = self.torque_limits_t.to(q)
        return torch.clamp(tau * motor_strength, -lim, lim)

    @functools.cached_property
    def _implicit_damping_const(self):
        """(D,) actuator-damping coefficient solved implicitly by the physics
        (``-d tau / d qd`` of the control law), or None: the D gains for P,
        ``p + d / sim_dt`` for V, none for T (its torques do not depend on
        qd)."""
        if not getattr(self.cfg.sim, "implicit_pd_damping", True):
            return None
        ct = self.cfg.control.control_type
        if ct == "P":
            return np.asarray(self.d_gains)
        if ct == "V":
            return np.asarray(self.p_gains) + np.asarray(self.d_gains) / self.sim_dt
        return None

    @functools.cached_property
    def post_fk_bodies(self):
        """Bodies whose final-state FK the post stage consumes (feet +
        orientation-reward frames), in the order K1 emits them."""
        bodies = list(self.feet_bodies)
        for fr in (self.torso_frame, self.forehead_frame):
            if fr is not None and fr[0] not in bodies:
                bodies.append(fr[0])
        return tuple(bodies)

    @functools.cached_property
    def _post_slot(self):
        return {b: i for i, b in enumerate(self.post_fk_bodies)}

    @functools.cached_property
    def _post_fold(self) -> bool:
        """True when the post-physics stage runs inside K1 or its lane
        program (``envs/post_lanes.LanePost``): those backends, plane
        terrain (measured heights are zero there) and commands without
        heading (the heading yaw needs the post-physics base orientation
        before the rewards). The engine path runs it outside, as JAX's."""
        return (self.backend != "engine" and self.terrain is None
                and not self.cfg.commands.heading_command)

    @functools.cached_property
    def terrain_mode(self) -> str:
        """K1's ground: the plane, per-point planes (heightfield) or planes
        and riser walls (trimesh)."""
        if self.terrain is None:
            return "plane"
        return "local_plane_walls" if self.riser_mode else "local_plane"

    @functools.cached_property
    def decimation_op(self):
        """K1: the decimation kernel's wrapper (``sim/cuda_step.py``)."""
        from wiki_grx_gym_tpu_torch.envs.post_lanes import LanePost
        from wiki_grx_gym_tpu_torch.sim.cuda_step import CudaDecimation
        from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarDecimation, ScalarSubstep

        sub = ScalarSubstep(
            self.model, self.contact_params, self.sim_dt, self.self_pairs,
            terrain_mode=self.terrain_mode,
        )
        deci = ScalarDecimation(
            sub, self.decimation, self.cfg.control.control_type,
            self.cfg.control.action_scale, self.p_gains, self.d_gains,
            self.default_dof_pos, self.torque_limits, self.feet_bodies,
            self.feet_point_groups, post_bodies=self.post_fk_bodies,
            damping_coeff=self._implicit_damping_const,
            post=LanePost(self) if self._post_fold else None,
        )
        return CudaDecimation(deci)

    def self_pair_report(self):
        """Audit of the self-collision pair selection: (included, excluded)
        lists of (point_i, point_j, default_gap_m) over all cross-limb
        candidates. Excluded pairs lie inside the default-pose margin and
        are invisible to the contact model, so the list should be empty (it
        is for the GRx models)."""
        included_set = set(zip(*self.self_pairs))
        included, excluded = [], []
        for a, b, gap in self._cross_limb_gaps():
            (included if (a, b) in included_set else excluded).append((a, b, float(gap)))
        return included, excluded

    # ------------------------------------------------------------------
    # the decimation loop's backends
    # ------------------------------------------------------------------

    def _run_decimation(self, state: "EnvState", actions, delay, commands):
        """One policy step of physics on the env's backend; the return
        tuple of ``CudaDecimation.__call__`` (``post_kin``, ``point_pos``
        and ``post_out`` None on the engine path). ``commands``: the
        post-resample commands that the folded post stage reads."""
        if self.backend == "engine":
            return self._decimation_scan(state, actions, delay)
        op = self.decimation_op
        args = (state.physics, actions, state.last_actions, state.motor_strength, delay[:, 0], state.rand)
        kw = dict(last_qd=state.last_dof_vel, plane=state.ground_plane,
                  extra=self.post_extra(state, commands) if self._post_fold else None)
        spans = self.spans
        if spans is not None:
            spans("k1")
        out = op.plain(*args, **kw) if self.backend == "lanes" else op(*args, **kw)
        if spans is not None:
            spans("env")
        return out

    def _decimation_scan(self, state: "EnvState", actions, delay):
        """The engine's decimation loop (JAX's ``lax.scan`` of the vmapped
        ``physics_step``): each substep the delay gate and the control
        law's torques, one batched :func:`physics_step` (the implicit drive
        damping scaled by the motor strength, as the torque is), and the
        feet's force norms and linear and angular speeds summed."""
        n, f = self.num_envs, self.num_feet
        phys = state.physics
        like = phys.q
        damp = None if self._damping_t is None else self._damping_t.to(like) * state.motor_strength
        fb = self.index_t(self.feet_bodies)
        sum_force = like.new_zeros((n, f))
        sum_vxyz = like.new_zeros((n, f, 3))
        sum_vrpy = like.new_zeros((n, f, 3))
        torques, point_force = state.torques, like.new_zeros((n, self.model.num_points, 3))
        for i in range(self.decimation):
            use_act = torch.where(i < delay, state.last_actions, actions)
            tau = self._pd_torques(phys.q, phys.qd, use_act, state.motor_strength, last_qd=state.last_dof_vel)
            phys, out = physics_step(
                self.model, phys, tau, self.height_fn, self.contact_params, state.rand, self.sim_dt,
                self_pairs=self.self_pairs, joint_damping=damp, ground_query=self.ground_query,
            )
            foot_force = self._group_forces(out.point_force, self.feet_point_groups)
            sum_force = sum_force + torch.linalg.vector_norm(foot_force, dim=-1)
            # feet link velocities from the body twists (rigid_body_states 7:13)
            tw, rel = out.kin.twist[:, fb], out.kin.pos_rel[:, fb]
            sum_vxyz = sum_vxyz + torch.abs(tw[..., 3:] + _cross(tw[..., :3], rel))
            sum_vrpy = sum_vrpy + torch.abs(tw[..., :3])
            torques, point_force = tau, out.point_force
        return phys, sum_force, sum_vxyz, sum_vrpy, torques, point_force, None, None, None

    @functools.cached_property
    def _damping_t(self):
        """``_implicit_damping_const`` on the env's device, or None."""
        d = self._implicit_damping_const
        return None if d is None else torch.as_tensor(np.asarray(d, np.float32), device=self.device)

    def post_extra(self, state: "EnvState", commands) -> Dict[str, torch.Tensor]:
        """The folded post stage's extra inputs (``LanePost.extra_schema``)."""
        return {
            "commands": commands[:, :3],
            "last_last_actions": state.last_last_actions,
            "feet_air_time": state.feet_air_time,
            "feet_land_time": state.feet_land_time,
            "feet_contact_last": state.feet_contact_last.to(torch.float32),
        }

    # ------------------------------------------------------------------
    # terrain: ground planes and measured heights
    # ------------------------------------------------------------------

    @functools.cached_property
    def _default_point_rel(self) -> torch.Tensor:
        """(P, 3) base-frame contact-point positions at the default pose:
        where just-reset envs sample their ground planes."""
        m = self.model
        kin = forward_kinematics(
            m, torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.zeros(3), torch.zeros(3),
            torch.from_numpy(self.default_dof_pos), torch.zeros(m.num_dof),
        )
        pb = torch.tensor(m.point_body, dtype=torch.long)
        rel = kin.pos_rel[pb] + maths.quat_apply(kin.quat[pb], m.point_offset)
        return rel.to(self.device)

    def _sample_point_planes(self, pos: torch.Tensor, center_xy: torch.Tensor) -> torch.Tensor:
        """(N, P, 3) world point positions -> (N, P, 3) local ground planes
        (c, gx, gy), h(x, y) = c + gx x + gy y, the gradient by central
        differences of 5 cm; on trimesh the (N, P, 9) riser-aware channels.
        The lookups follow tiles cut at ``center_xy`` (terrain/composer)."""
        x, y = pos[..., 0], pos[..., 1]
        if self.riser_mode:
            return self.terrain.ground_channels(center_xy, x, y)
        eps = 0.05
        ep = torch.full_like(x, eps)
        xs = torch.cat([x, x + ep, x - ep, x, x], dim=1)
        ys = torch.cat([y, y, y, y + ep, y - ep], dim=1)
        h, hxp, hxm, hyp, hym = torch.chunk(self.terrain.height(center_xy, xs, ys), 5, dim=1)
        gx = _div(hxp - hxm, 2.0 * eps)
        gy = _div(hyp - hym, 2.0 * eps)
        return torch.stack([h - gx * x - gy * y, gx, gy], dim=-1)

    def _refresh_ground_plane(self, state: "EnvState", reset_mask, point_pos=None,
                              force: bool = False) -> "EnvState":
        """The ground planes of the next policy step (terrain, on K1 and its
        lane program; the engine reads the terrain itself). Envs
        not reset sample at K1's final-state point positions; just-reset
        envs at the default-pose offsets around their new root. With
        ``refresh_interval`` k > 1 the planes are sampled on every k-th
        step (the measured grid's phase) and carried in between, just-reset
        envs getting a flat plane at their spawn origin's height. The phase
        is decided on the device from ``state.common_step`` (already counted
        for this step), as JAX's ``lax.cond`` does: both branches are
        computed and ``torch.where`` keeps one, so no device value is read
        and a CUDA graph does not bake the phase in."""
        if self.terrain is None or self.backend == "engine":
            return state
        phys = state.physics
        n, p = self.num_envs, self.model.num_points
        pp = phys.base_pos[:, None, :] + maths.quat_apply(
            phys.base_quat[:, None, :].expand(n, p, 4), self._default_point_rel.expand(n, p, 3))
        if point_pos is not None:
            pp = torch.where(reset_mask[:, None, None], pp, point_pos)
        planes = self._sample_point_planes(pp, phys.base_pos[:, :2])
        k = self.refresh_interval
        if force or k <= 1 or state.ground_plane is None:
            return state.replace(ground_plane=planes)
        flat = torch.zeros_like(state.ground_plane[:, :1])
        flat[:, 0, 0] = state.env_origins[:, 2]
        carried = torch.where(reset_mask[:, None, None], flat, state.ground_plane)
        refresh = (state.common_step - 1) % k == 0
        return state.replace(ground_plane=torch.where(refresh, planes, carried))

    def _measured_heights(self, phys, base_quat) -> torch.Tensor:
        """(N, H) terrain heights at the yaw-rotated measurement grid around
        the base (legged_robot.py:1235-1274); zeros on the plane."""
        n = self.num_envs
        if self.terrain is None or not self.measure_heights:
            return torch.zeros((n, self.num_height_points), device=self.device)
        h = self.num_height_points
        pts = torch.cat([self.height_points_t, self.height_points_t.new_zeros((h, 1))], dim=-1)
        world = maths.quat_apply_yaw(base_quat[:, None, :].expand(n, h, 4), pts.expand(n, h, 3)) \
            + phys.base_pos[:, None, :]
        return self.terrain.measured(phys.base_pos[:, :2], world[..., 0], world[..., 1])

    # ------------------------------------------------------------------
    # init / reset
    # ------------------------------------------------------------------

    def make_generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g

    def init_state(self, generator) -> EnvState:
        """The initial (all-envs-reset) state, sampling the one-time per-env
        body randomizations. ``generator``: a ``torch.Generator`` on the
        env's device, or an int seed."""
        if not isinstance(generator, torch.Generator):
            generator = self.make_generator(generator)
        g, dev = generator, self.device
        c = self.cfg
        n, d = self.num_envs, self.num_dof
        dr = c.domain_rand
        sample = lambda rng_, shape, dist: maths.sample_distribution(g, rng_, shape, dist, dev)

        def bucketed(rng_, dist, num_buckets):
            if num_buckets:
                vals = sample(rng_, (int(num_buckets),), dist)
                ids = torch.randint(0, int(num_buckets), (n,), generator=g, device=dev)
                return vals[ids]
            return sample(rng_, (n,), dist)

        if dr.randomize_friction:
            friction = bucketed(
                dr.friction_range, getattr(dr, "friction_distribution", "uniform"),
                getattr(dr, "friction_buckets", 64),
            )
        else:
            friction = torch.ones(n, device=dev)
        # the DR sample is the foot material's coefficient; the ground's is
        # averaged in (IsaacGym's default friction combine mode)
        ground_mu = float(
            c.terrain.static_friction
            if self.contact_params.tangent_stiffness > 0.0
            else c.terrain.dynamic_friction
        )
        friction = 0.5 * (friction + ground_mu)
        if dr.randomize_restitution:
            restitution = bucketed(
                dr.restitution_range, getattr(dr, "restitution_distribution", "uniform"),
                getattr(dr, "restitution_buckets", 64),
            )
        else:
            restitution = torch.zeros(n, device=dev)
        mass_scale = (
            sample(dr.multiply_base_mass_range, (n,),
                   getattr(dr, "base_mass_distribution", "uniform"))
            if dr.randomize_base_mass else torch.ones(n, device=dev)
        )
        com_dist = getattr(dr, "base_com_distribution", "uniform")
        com_offset = (
            torch.stack(
                [
                    sample(dr.add_base_com_range_x, (n,), com_dist),
                    sample(dr.add_base_com_range_y, (n,), com_dist),
                    sample(dr.add_base_com_range_z, (n,), com_dist),
                ],
                dim=-1,
            )
            if dr.randomize_base_com else torch.zeros((n, 3), device=dev)
        )
        motor_strength = (
            sample(dr.multiply_motor_strength, (n, d),
                   getattr(dr, "motor_strength_distribution", "uniform"))
            if dr.randomize_motor_strength else torch.ones((n, d), device=dev)
        )

        if self.custom_origins:
            origins, levels, types = self.terrain.sample_origins(g, n, c.terrain, offset=self.shard[0],
                                                                 total=self.num_envs_global)
        else:
            origins = torch.as_tensor(self._origins_np, device=dev)
            levels = torch.zeros(n, dtype=torch.int32, device=dev)
            types = torch.zeros(n, dtype=torch.int32, device=dev)
        zeros = lambda *shape: torch.zeros(shape, device=dev)
        phys = PhysicsState(
            base_pos=self.init_pos_t.expand(n, 3) + origins,
            base_quat=self.init_rot_t.expand(n, 4).clone(),
            base_lin_vel=zeros(n, 3),
            base_ang_vel=zeros(n, 3),
            q=self.default_dof_pos_t.expand(n, d).clone(),
            qd=zeros(n, d),
            anchor=zeros(n, self.model.num_points, 3),
        )
        state = EnvState(
            physics=phys,
            rng=g,
            episode_length=torch.zeros(n, dtype=torch.int32, device=dev),
            common_step=torch.zeros((), dtype=torch.int32, device=dev),
            commands=zeros(n, max(3, c.commands.num_commands)),
            actions=zeros(n, self.num_actions),
            last_actions=zeros(n, self.num_actions),
            last_last_actions=zeros(n, self.num_actions),
            last_dof_vel=zeros(n, d),
            torques=zeros(n, d),
            feet_air_time=zeros(n, self.num_feet),
            feet_land_time=zeros(n, self.num_feet),
            feet_contact_last=torch.zeros((n, self.num_feet), dtype=torch.bool, device=dev),
            episode_sums=zeros(n, len(self.all_reward_names)),
            rand=BodyRandomization(
                friction=friction,
                restitution=restitution,
                base_mass_scale=mass_scale,
                base_com_offset=com_offset,
            ),
            motor_strength=motor_strength,
            env_origins=origins,
            terrain_levels=levels,
            terrain_types=types,
            cmd_lin_vel_x_range=torch.tensor(
                c.commands.ranges.lin_vel_x, dtype=torch.float32, device=dev
            ),
            measured_cache=(
                zeros(n, self.num_height_points)
                if (self.terrain is not None and self.refresh_interval > 1) else None
            ),
        )
        # force a full reset of every env; curricula do not advance here
        done = torch.ones(n, dtype=torch.bool, device=dev)
        state = self._reset_where(state, done, update_curriculum=False)
        return self._refresh_ground_plane(state, done, force=True)

    def reset(self, state: EnvState) -> Tuple[EnvState, StepOutput]:
        """Reset all envs, then step zero actions."""
        n = self.num_envs
        done = torch.ones(n, dtype=torch.bool, device=self.device)
        state = self._refresh_ground_plane(self._reset_where(state, done), done, force=True)
        return self.step(state, torch.zeros((n, self.num_actions), device=self.device))

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def clip_actions(self, actions: torch.Tensor) -> torch.Tensor:
        """Per-joint action boxes."""
        return torch.clamp(actions, self.clip_actions_min_t, self.clip_actions_max_t)

    @functools.cached_property
    def _step_u_cols(self):
        """Static column layout of the step's ONE U[0,1) block: every random
        quantity of the step (delay, obs noise, command resample, resets,
        pushes) is a slice of a single (n, K) uniform draw."""
        c = self.cfg
        widths = [
            ("delay", 1 if c.control.actuation_delay else 0),
            ("noise", self.obs_dim if c.noise.add_noise else 0),
            ("cmd", 3),
            ("reset", self._reset_u_width),
            ("push", 2 if c.domain_rand.push_robots else 0),
        ]
        cols, off = {}, 0
        for name, w in widths:
            cols[name] = (off, w)
            off += w
        return cols, off

    def step(self, state: EnvState, actions: torch.Tensor, u: torch.Tensor = None
             ) -> Tuple[EnvState, StepOutput]:
        """One policy step. ``u``: optional (n, K) U[0,1) block to use instead
        of drawing it from ``state.rng`` (K from ``_step_u_cols``)."""
        if self.spans is not None:
            self.spans("env")
        c = self.cfg
        n = self.num_envs
        cols, k_width = self._step_u_cols
        if u is None:
            u = torch.rand((n, k_width), generator=state.rng, device=self.device)

        def u_of(name):
            off, w = cols[name]
            return u[:, off: off + w]

        actions = self.clip_actions(actions)

        # ---- actuation delay in substeps: N(mean, std) by inverse erf ----
        if c.control.actuation_delay:
            un = torch.clamp(u_of("delay"), 1e-7, 1.0 - 1e-7)
            delay = c.control.actuation_delay_mean + c.control.actuation_delay_std * (
                math.sqrt(2.0) * torch.special.erfinv(2.0 * un - 1.0)
            )
            delay = torch.clamp(delay, min=0.0)
        else:
            delay = torch.zeros((n, 1), device=self.device)

        # command resampling on schedule, before the kernel (its folded post
        # stage reads the commands); the heading yaw is set after it
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1
        resample = (episode_length % self.resample_interval) == 0
        new_cmds = self._sample_commands(u_of("cmd"), n, state.cmd_lin_vel_x_range)
        commands = torch.where(resample[:, None], new_cmds, state.commands)

        phys, sum_force, sum_vxyz, _, torques, point_force, post_kin, point_pos, post_out = (
            self._run_decimation(state, actions, delay, commands)
        )
        commands = self._apply_heading_command(commands, phys.base_quat, n)

        time_out = episode_length > self.max_episode_length
        hscale = c.normalization.obs_scales.height_measurements
        target_h = c.rewards.base_height_target
        feet_force = self._group_forces(point_force, self.feet_point_groups)  # (N, F, 3)

        if post_out is not None:
            # ---- post-physics folded into K1: rewards, termination channels,
            # feet trackers and base-frame quantities arrive as kernel outputs ----
            base_lin_vel, base_ang_vel = post_out["blv"], post_out["bav"]
            projected_gravity = post_out["pg"]
            feet_contact = post_out["feet_contact"] > 0.5
            contact_filt = post_out["contact_filt"] > 0.5
            feet_air_time = post_out["feet_air_time_out"]
            feet_land_time = post_out["feet_land_time_out"]
            feet_height = post_out["feet_height"]
            base_heights_offset = post_out["bho"][:, 0]
            bad = post_out["bad"][:, 0] > 0.5
            reset_buf = (
                (post_out["term_contact"][:, 0] > 0.5)
                | (post_out["tilt"][:, 0] > 0.5)
                | time_out
                | bad
            )
            # plane terrain: measured heights are identically zero
            measured_heights = torch.zeros((n, self.num_height_points), device=self.device)
            surround_heights_offset = (
                torch.clamp(phys.base_pos[:, 2:3] - target_h, -1.0, 1.0) * hscale
            ).expand(n, self.num_height_points)
            term_stack = post_out["rew_terms"]  # (N, R) == reward_names
        else:
            # ---- the post stage outside K1 (terrain, heading commands, the engine) ----
            dof_acc = (phys.qd - state.last_dof_vel) / self.dt
            # the final-state FK of the consumed bodies: from K1 (or its lane
            # program), or recomputed here on the engine path
            if post_kin is None:
                kin = forward_kinematics(self.model, phys.base_quat, phys.base_ang_vel,
                                         phys.base_lin_vel, phys.q, phys.qd)
                fb = self.index_t(self.feet_bodies)
                feet_rel, feet_quat = kin.pos_rel[:, fb], kin.quat[:, fb]
                frame_quat = lambda body: kin.quat[:, body]
            else:
                post_rel, post_quat = post_kin
                slots = self.index_t([self._post_slot[b] for b in self.feet_bodies])
                feet_rel, feet_quat = post_rel[:, slots], post_quat[:, slots]
                frame_quat = lambda body: post_quat[:, self._post_slot[body]]

            base_quat = phys.base_quat
            base_lin_vel = maths.quat_rotate_inverse(base_quat, phys.base_lin_vel)
            base_ang_vel = maths.quat_rotate_inverse(base_quat, phys.base_ang_vel)
            projected_gravity = maths.quat_rotate_inverse(base_quat, self.down_t.expand(n, 3))

            # measured terrain heights around the base: every step, or on
            # every k-th step with the cache carried between (the phase
            # decided on the device, as JAX's lax.cond on common_step)
            measured_heights = self._measured_heights(phys, base_quat)
            if self.terrain is not None and self.refresh_interval > 1:
                measured_heights = torch.where(state.common_step % self.refresh_interval == 0,
                                               measured_heights, state.measured_cache)
            mean_heights = torch.mean(measured_heights, dim=1)
            rel_h = torch.clamp(phys.base_pos[:, 2:3] - target_h - measured_heights, -1.0, 1.0) * hscale
            base_heights_offset = torch.mean(rel_h, dim=1)
            surround_heights_offset = rel_h

            # feet quantities
            f = self.num_feet
            feet_pos = phys.base_pos[:, None, :] + feet_rel + maths.quat_apply(
                feet_quat, self.feet_offsets_t.expand(n, f, 3))
            feet_height = feet_pos[..., 2] - mean_heights[:, None]

            # air/land trackers
            feet_contact = feet_force[..., 2] > 1.0
            contact_filt = feet_contact | state.feet_contact_last
            feet_first_contact = (state.feet_air_time > 0) & contact_filt
            feet_air_time = state.feet_air_time + self.dt
            feet_land_time = (state.feet_land_time + self.dt) * feet_contact

            # termination: per-link contact force > 1 N, tilt, non-finite state
            if self.termination_links:
                term_force = self._group_forces(point_force, self.termination_groups)
                term_contact = torch.any(torch.linalg.vector_norm(term_force, dim=-1) > 1.0, dim=1)
            else:
                term_contact = torch.zeros(n, dtype=torch.bool, device=self.device)
            tilt = torch.abs(projected_gravity[:, 2]) < 0.33
            bad = ~(
                torch.all(torch.isfinite(phys.base_pos), dim=1)
                & torch.all(torch.isfinite(phys.base_quat), dim=1)
                & torch.all(torch.isfinite(phys.q), dim=1)
                & torch.all(torch.isfinite(phys.qd), dim=1)
            )
            reset_buf = term_contact | tilt | time_out | bad

            if self.penalized_links:
                pen_force = self._group_forces(point_force, self.penalized_groups)
                pen_count = torch.sum(
                    (torch.linalg.vector_norm(pen_force, dim=-1) > 0.1).to(phys.qd.dtype), dim=1)
            else:
                pen_count = torch.zeros(n, device=self.device)

            ctx = RewardContext(
                commands=commands,
                base_lin_vel=base_lin_vel,
                base_ang_vel=base_ang_vel,
                base_projected_gravity=projected_gravity,
                base_heights_offset=base_heights_offset,
                base_height=phys.base_pos[:, 2] - mean_heights,
                torso_projected_gravity=self._frame_projected_gravity(
                    "torso", self.torso_frame, frame_quat, n, projected_gravity),
                forehead_projected_gravity=self._frame_projected_gravity(
                    "forehead", self.forehead_frame, frame_quat, n, projected_gravity),
                dof_pos=phys.q,
                dof_vel=phys.qd,
                dof_acc=dof_acc,
                torques=torques,
                actions=actions,
                last_actions=state.last_actions,
                last_last_actions=state.last_last_actions,
                feet_contact=feet_contact,
                feet_first_contact=feet_first_contact.to(phys.qd.dtype),
                feet_air_time=feet_air_time,
                feet_land_time=feet_land_time,
                feet_height=feet_height,
                feet_contact_force=feet_force,
                avg_feet_contact_force=sum_force / self.decimation,
                avg_feet_speed_xyz=sum_vxyz / self.decimation,
                penalized_contact_count=pen_count,
                reset_buf=reset_buf,
                time_out_buf=time_out,
            )
            # an exploded (NaN) env's rewards must not propagate
            term_stack = torch.stack([
                torch.where(bad, 0.0, REWARDS[name](self, ctx) * self.reward_scales[name])
                for name in self.reward_names
            ], dim=1) if self.reward_names else phys.qd.new_zeros((n, 0))

        if self.termination_scale:
            term = (reset_buf & ~time_out).to(term_stack.dtype) * self.termination_scale
            term_stack = torch.cat([term_stack, term[:, None]], dim=1)
        episode_sums = state.episode_sums + term_stack
        rew_buf = torch.sum(term_stack[:, : len(self.reward_names)], dim=1)
        if c.rewards.only_positive_rewards:
            rew_buf = torch.clamp(rew_buf, min=0.0)
        if self.termination_scale:
            rew_buf = rew_buf + term_stack[:, len(self.reward_names)]

        # ---- episode logging before the sums are cleared ----
        done_f = reset_buf.to(torch.float32)
        cnt = torch.clamp(torch.sum(done_f), min=1.0)
        means = torch.sum(episode_sums * done_f[:, None], dim=0) / cnt / self.max_episode_length_s
        episode_metrics = {
            "rew_" + name: means[i] for i, name in enumerate(self.all_reward_names)
        }
        if self.custom_origins and c.terrain.curriculum:
            episode_metrics["terrain_level"] = torch.mean(state.terrain_levels.to(torch.float32))
        if c.commands.curriculum:
            episode_metrics["max_command_x"] = state.cmd_lin_vel_x_range[1]
        extras = {
            "time_outs": (
                time_out if getattr(c.env, "send_timeouts", True)
                else torch.zeros_like(time_out)
            ),
            "episode": episode_metrics,
            "done_count": torch.sum(done_f),
            # per-env raw metric channels, accumulated by the runner
            "episode_done_sums": episode_sums * done_f[:, None],   # (N, R)
            "ep_len_done": torch.where(reset_buf, episode_length, 0).to(torch.float32),
            # named eval channels (play's logger reads them)
            "base_lin_vel": base_lin_vel,
            "base_ang_vel": base_ang_vel,
            "feet_contact_force": feet_force,
        }

        # random pushes via the base velocity; visible from the next step on
        if c.domain_rand.push_robots:
            do_push = (common_step % self.push_interval) == 0
            mx = c.domain_rand.max_push_vel_xy
            push_vel = -mx + 2.0 * mx * u_of("push")
            pushed = torch.cat([push_vel, phys.base_lin_vel[:, 2:]], dim=1)
            phys = phys.replace(base_lin_vel=torch.where(do_push, pushed, phys.base_lin_vel))

        # ---- state writeback + branchless resets ----
        state = state.replace(
            physics=phys,
            episode_length=episode_length,
            common_step=common_step,
            commands=commands,
            actions=actions,
            torques=torques,
            episode_sums=episode_sums,
            feet_air_time=feet_air_time,
            feet_land_time=feet_land_time,
        )
        if state.measured_cache is not None:
            state = state.replace(measured_cache=measured_heights)
        state = self._reset_where(state, reset_buf, u=u_of("reset"), update_curriculum=True)
        state = self._refresh_ground_plane(state, reset_buf, point_pos=point_pos)

        # record "last" values; reset envs keep zeros from _reset_where
        not_done = ~reset_buf
        nd1 = not_done[:, None].to(torch.float32)
        state = state.replace(
            last_actions=state.actions * nd1,
            last_last_actions=state.actions * nd1,
            last_dof_vel=state.physics.qd * nd1,
            feet_air_time=state.feet_air_time * (~contact_filt) * nd1,
            feet_contact_last=feet_contact & not_done[:, None],
        )

        # ---- observations from the post-reset state ----
        obs, pri_obs = self._observations(
            state, u_of("noise"), commands=state.commands, measured_cache=(
                measured_heights, base_heights_offset, surround_heights_offset,
                feet_contact, feet_height, base_lin_vel, base_ang_vel, projected_gravity,
            ),
            reset_buf=reset_buf,
        )
        return state, StepOutput(obs=obs, pri_obs=pri_obs, rew=rew_buf, reset=reset_buf, extras=extras)

    @property
    def step_graph_reason(self) -> Optional[str]:
        """None where :meth:`step_graph` replays a CUDA graph, else why it
        runs :meth:`step`: a CUDA device, K1 or the engine as the physics
        backend, and under data parallelism a group whose collectives a
        CUDA graph captures (NCCL's: the command curriculum's all-reduce;
        across ranks what ``DataParallel.eager_reason`` admits) are
        needed. The lane program (K1's plain version) is not graphed."""
        if self.device.type != "cuda":
            return f"device {self.device}"
        if self.backend == "lanes":
            return "the physics backend is 'lanes' (K1's plain version), not K1 or the engine"
        if self.dp is not None:
            return self.dp.eager_reason(self.backend)
        return None

    def step_graph(self, state: EnvState, actions: torch.Tensor) -> Tuple[EnvState, StepOutput]:
        """One policy step as a CUDA graph (the counterpart of JAX's
        ``step_jit``): one graph per env and batch shape, made at its first
        call (``learn/graphs.StepGraph``: that call runs the step eagerly as
        the capture's warm-up, then captures it); each call copies ``state``
        (where it is not the graph's static state itself) and ``actions``
        in, replays, and returns (the static state, which the next call
        overwrites in place, and the step's outputs, likewise). Where
        :attr:`step_graph_reason` is not None it is :meth:`step`."""
        if self.step_graph_reason is not None:
            return self.step(state, actions)
        key = (tuple(actions.shape), actions.dtype)
        graph = self._step_graphs.get(key)
        if graph is None:
            from wiki_grx_gym_tpu_torch.learn.graphs import StepGraph

            graph = self._step_graphs[key] = StepGraph(self, state, actions)
        return graph(state, actions)

    # ------------------------------------------------------------------
    # helpers used by step
    # ------------------------------------------------------------------

    def _group_forces(self, point_force: torch.Tensor, groups) -> torch.Tensor:
        """(N, P, 3) point forces -> (N, G, 3) per-group sums."""
        cols = []
        for g in groups:
            if len(g) == 1:
                cols.append(point_force[:, g[0]])
            else:
                cols.append(torch.sum(point_force[:, self.index_t(g)], dim=1))
        if not cols:
            return point_force.new_zeros((point_force.shape[0], 0, 3))
        return torch.stack(cols, dim=1)

    def _frame_projected_gravity(self, name, frame, frame_quat, n, fallback):
        """Projected gravity in the named (possibly welded) link frame
        (``name``: "torso" or "forehead"); ``frame_quat`` maps a body index
        to its (N, 4) quaternion."""
        if frame is None:
            return fallback
        bq = frame_quat(frame[0])
        link_quat = maths.quat_mul(bq, self.frame_qoff_t[name].to(bq.dtype).expand(n, 4))
        return maths.quat_rotate_inverse(link_quat, self.down_t.to(bq.dtype).expand(n, 3))

    def _apply_heading_command(self, commands, base_quat, n):
        """Heading mode (legged_robot.py:321-326): the yaw command from the
        heading error of the base's forward vector."""
        if not self.cfg.commands.heading_command:
            return commands
        fwd = maths.quat_apply(base_quat, self.forward_t.to(base_quat.dtype).expand(n, 3))
        heading = torch.atan2(fwd[:, 1], fwd[:, 0])
        r = self.cfg.commands.ranges.ang_vel_yaw
        yaw_cmd = torch.clamp(0.5 * maths.wrap_to_pi(commands[:, 3] - heading), r[0], r[1])
        return torch.cat([commands[:, :2], yaw_cmd[:, None], commands[:, 3:]], dim=1)

    def _sample_commands(self, u3, n, x_range):
        """Uniform command resampling from a (n, 3) U[0,1) block; small
        commands snap to zero. ``x_range``: the (2,) lin_vel_x range, the
        command curriculum's state. In heading mode the 4th channel is the
        heading target and the yaw command is set each step from the
        heading error."""
        c = self.cfg.commands
        r = c.ranges
        cx = x_range[0] + u3[:, 0] * (x_range[1] - x_range[0])
        cy = r.lin_vel_y[0] + u3[:, 1] * (r.lin_vel_y[1] - r.lin_vel_y[0])
        if c.heading_command:
            heading = r.heading[0] + u3[:, 2] * (r.heading[1] - r.heading[0])
            cmds = torch.stack([cx, cy, torch.zeros_like(cx), heading], dim=-1)
        else:
            cyaw = r.ang_vel_yaw[0] + u3[:, 2] * (r.ang_vel_yaw[1] - r.ang_vel_yaw[0])
            cmds = torch.stack([cx, cy, cyaw], dim=-1)
        width = max(3, c.num_commands)
        if cmds.shape[1] < width:
            cmds = torch.cat([cmds, cmds.new_zeros((n, width - cmds.shape[1]))], dim=-1)
        keep = (torch.linalg.vector_norm(cmds[:, :2], dim=1) > 0.1)[:, None]
        return torch.cat([cmds[:, :2] * keep.to(torch.float32), cmds[:, 2:]], dim=1)

    @functools.cached_property
    def _reset_u_width(self) -> int:
        """Columns of the reset path's uniform block: q[d], xy[2], yaw[1],
        vel6[6], cmds[3], level[1]."""
        return self.num_dof + 13

    def _reset_where(self, state: EnvState, done: torch.Tensor, u=None,
                     update_curriculum: bool = False) -> EnvState:
        """Branchless reset of done envs. ``u``: optional
        (n, _reset_u_width) U[0,1) block; drawn from ``state.rng`` if None."""
        c = self.cfg
        n, d = self.num_envs, self.num_dof
        if u is None:
            u = torch.rand((n, self._reset_u_width), generator=state.rng, device=self.device)
        u_q = u[:, :d]
        u_xy = u[:, d: d + 2]
        u_yaw = u[:, d + 2]
        u_vel = u[:, d + 3: d + 9]
        u_cmd = u[:, d + 9: d + 12]
        u_level = u[:, d + 12]

        # terrain curriculum (legged_robot.py:799-826): up a level after
        # walking past half a cell, down after less than half the commanded
        # distance; past the top to a random level
        if update_curriculum and self.custom_origins and c.terrain.curriculum:
            dist = torch.linalg.vector_norm(
                state.physics.base_pos[:, :2] - state.env_origins[:, :2], dim=1)
            move_up = dist > self.terrain.env_length / 2
            move_down = (
                dist < torch.linalg.vector_norm(state.commands[:, :2], dim=1)
                * self.max_episode_length_s * 0.5
            ) & ~move_up
            levels = state.terrain_levels + move_up.to(torch.int32) - move_down.to(torch.int32)
            max_level = c.terrain.num_rows
            rand_level = torch.clamp((u_level * max_level).to(torch.int32), max=max_level - 1)
            levels = torch.where(levels >= max_level, rand_level, torch.clamp(levels, min=0))
            levels = torch.where(done, levels, state.terrain_levels)
            origins = self.terrain.terrain_origins[levels.long(), state.terrain_types.long()]
            state = state.replace(terrain_levels=levels, env_origins=origins.to(state.env_origins.dtype))

        # command curriculum: widen lin_vel_x when the tracking reward of the
        # resetting envs clears 80% of its max
        if (
            update_curriculum
            and c.commands.curriculum
            and "tracking_lin_vel" in self.reward_names
        ):
            i = self.reward_names.index("tracking_lin_vel")
            # the mean over the resetting envs of every rank (one all-reduce)
            sums = torch.stack([torch.sum(state.episode_sums[:, i] * done), torch.sum(done.to(torch.float32))])
            if self.dp is not None:
                sums = self.dp.all_reduce_sum(sums)
            cnt = torch.clamp(sums[1], min=1.0)
            mean_track = sums[0] / cnt / self.max_episode_length
            grow = mean_track > 0.8 * self.reward_scales["tracking_lin_vel"]
            lo, hi = state.cmd_lin_vel_x_range[0], state.cmd_lin_vel_x_range[1]
            mx = c.commands.max_curriculum
            new_range = torch.stack(
                [torch.clamp(lo - 0.5, -mx, 0.0), torch.clamp(hi + 0.5, 0.0, mx)]
            )
            state = state.replace(
                cmd_lin_vel_x_range=torch.where(grow, new_range, state.cmd_lin_vel_x_range)
            )

        # dof state
        if c.domain_rand.randomize_init_dof_pos:
            q_new = (0.5 + u_q) * self.default_dof_pos_t
        else:
            q_new = self.default_dof_pos_t.expand(n, d)

        # root state
        pos_new = self.init_pos_t + state.env_origins
        if self.custom_origins:
            pos_new = torch.cat([pos_new[:, :2] + (-1.0 + 2.0 * u_xy), pos_new[:, 2:]], dim=1)
        yaw = -2.0 * np.pi + 4.0 * np.pi * u_yaw
        zero = torch.zeros_like(yaw)
        quat_new = maths.quat_from_euler_xyz(zero, zero, yaw)
        if c.domain_rand.randomize_init_base_velocity:
            vel6 = -0.5 + u_vel
        else:
            vel6 = torch.zeros((n, 6), device=self.device)

        cmds_new = self._sample_commands(u_cmd, n, state.cmd_lin_vel_x_range)

        m = done
        m1 = m[:, None]

        def w(new, old):
            return torch.where(torch.reshape(m, m.shape + (1,) * (old.dim() - 1)), new, old)

        phys = state.physics
        phys = PhysicsState(
            base_pos=w(pos_new, phys.base_pos),
            base_quat=w(quat_new, phys.base_quat),
            base_lin_vel=w(vel6[:, :3], phys.base_lin_vel),
            base_ang_vel=w(vel6[:, 3:], phys.base_ang_vel),
            q=w(q_new, phys.q),
            qd=w(torch.zeros_like(phys.qd), phys.qd),
            anchor=w(torch.zeros_like(phys.anchor), phys.anchor),
        )
        return state.replace(
            physics=phys,
            commands=torch.where(m1, cmds_new, state.commands),
            last_actions=torch.where(m1, 0.0, state.last_actions),
            last_last_actions=torch.where(m1, 0.0, state.last_last_actions),
            last_dof_vel=torch.where(m1, 0.0, state.last_dof_vel),
            feet_air_time=torch.where(m1, 0.0, state.feet_air_time),
            feet_land_time=torch.where(m1, 0.0, state.feet_land_time),
            feet_contact_last=torch.where(m1, False, state.feet_contact_last),
            episode_length=torch.where(m, 0, state.episode_length),
            episode_sums=torch.where(m1, 0.0, state.episode_sums),
        )

    def _observations(self, state, u_noise, commands, measured_cache, reset_buf):
        """Observation profiles; recomputes base-frame quantities for envs
        that were just reset."""
        c = self.cfg
        n = self.num_envs
        (mh, bho, sho, feet_contact, feet_height, blv, bav, pg) = measured_cache

        phys = state.physics
        blv2 = maths.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
        bav2 = maths.quat_rotate_inverse(phys.base_quat, phys.base_ang_vel)
        pg2 = maths.quat_rotate_inverse(phys.base_quat, self.down_t.expand(n, 3))
        r1 = reset_buf[:, None]
        blv = torch.where(r1, blv2, blv)
        bav = torch.where(r1, bav2, bav)
        pg = torch.where(r1, pg2, pg)

        os_ = c.normalization.obs_scales
        dof_pos_offset = phys.q - self.default_dof_pos_t
        obs = torch.cat(
            [
                commands[:, :3] * self.commands_scale_t,
                bav * os_.ang_vel,
                pg * os_.gravity,
                dof_pos_offset * os_.dof_pos,
                phys.qd * os_.dof_vel,
                state.actions * os_.action,
            ],
            dim=-1,
        )
        pri_obs = torch.cat(
            [
                obs,
                blv * os_.lin_vel,
                bho[:, None] * os_.height_measurements,
                feet_contact.to(torch.float32),
                feet_height * os_.height_measurements,
                sho * os_.height_measurements,
            ],
            dim=-1,
        )
        if c.noise.add_noise:
            obs = obs + (2.0 * u_noise - 1.0) * self.noise_scale_vec_t
        clip = c.normalization.clip_observations
        # stale channels of a just-reset (exploded) env must not leak
        # non-finite values into the network
        obs = torch.nan_to_num(torch.clamp(obs, -clip, clip))
        pri_obs = torch.nan_to_num(torch.clamp(pri_obs, -clip, clip))
        return obs, pri_obs
