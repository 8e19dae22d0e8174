"""The env step in plain PyTorch: one policy step of the configuration's
task on the plane, from a state to the next observations, rewards and
resets.

legged_gym's step as the configuration states it: the per-joint action
boxes, the actuation delay drawn by inverse erf, command resampling, the
decimation loop with its post-physics tail (``lanes``, ``post_lanes``: the
program K1 computes per env), the rewards' sum with the termination term,
pushes, the branchless resets of done envs, the "last" values and the
actor's and critic's observations with their noise. Every random quantity
of the step is a column of one (N, K) block of uniform draws, laid out as
the configuration's switches give (:meth:`RefEnv.u_columns`).

It covers the plane without a command or terrain curriculum, where every
env steps on its own, so any sample of envs steps as the whole batch
would; anything else raises. Constants come from the configuration file's
``env_cfg`` and the robot spec, never from the program.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.lanes import ScalarDecimation, ScalarSubstep
from benchmark.reference.post_lanes import LanePost
from benchmark.reference.robot import ContactParams, body_poses, load_model, quat_apply, quat_from_euler_xyz, \
    quat_rotate_inverse

def namespace(d):
    """A nested dict as nested attribute namespaces (the config's shape)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    return d


def _match_by_name(table: dict, dof_name: str) -> float:
    for key, val in table.items():
        if key in dof_name:
            return float(val)
    raise KeyError(f"no entry for dof {dof_name!r}")


class RefEnv:
    """The configuration's env, its constants worked out from the
    configuration file (``env_cfg``) and the robot spec. ``num_envs``: the
    envs of the whole run (the plane's origin grid follows it).
    ``dtype``: the precision the step computes in (the control's is below
    the stated float32); ``friction_scale`` and ``substeps_less`` plant
    faults for the limits' readings."""

    def __init__(self, env_cfg: dict, num_envs: int, dtype=torch.float32, friction_scale: float = 1.0,
                 substeps_less: int = 0):
        c = self.cfg = namespace(env_cfg)
        if c.terrain.mesh_type not in ("plane", "none") or c.commands.curriculum or c.commands.heading_command:
            raise NotImplementedError("the reference env steps the plane without command curriculum or "
                                      "heading commands")
        if c.control.control_type != "P":
            raise NotImplementedError("the reference env runs the P control law")
        model = load_model(c.asset.file)
        if c.asset.disable_gravity:
            model = dataclasses.replace(model, gravity_scale=0.0)
        self.model, self.dtype = model, dtype
        self.friction_scale = float(friction_scale)
        self.num_envs = int(num_envs)
        self.num_dof = model.num_dof
        self.decimation = int(c.control.decimation)
        self.sim_dt = float(c.sim.dt)
        self.dt = self.sim_dt * self.decimation
        self.max_episode_length_s = float(c.env.episode_length_s)
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))
        self.resample_interval = int(c.commands.resampling_command_interval_s / self.dt)
        self.push_interval = int(np.ceil(c.domain_rand.push_interval_s / self.dt))

        d = self.num_dof
        default_pos, p_gains, d_gains = np.zeros(d, np.float32), np.zeros(d, np.float32), np.zeros(d, np.float32)
        for i, name in enumerate(model.dof_names):
            default_pos[i] = getattr(c.init_state.default_joint_angles, name)
            for key, kp in vars(c.control.stiffness).items():
                if key in name:
                    p_gains[i] = kp
                    d_gains[i] = getattr(c.control.damping, key)
        self.default_dof_pos, self.p_gains, self.d_gains = default_pos, p_gains, d_gains
        self.torque_limits = model.dof_effort_limit.numpy()
        self.dof_vel_limits = model.dof_vel_limit.numpy()
        lo, hi = model.dof_lower.numpy(), model.dof_upper.numpy()
        mid, span = (lo + hi) / 2, hi - lo
        soft = c.rewards.soft_dof_pos_limit
        self.dof_pos_soft_lower = mid - 0.5 * span * soft
        self.dof_pos_soft_upper = mid + 0.5 * span * soft

        amax = np.array([_match_by_name(vars(c.normalization.actions_max), n) for n in model.dof_names], np.float32)
        amin = np.array([_match_by_name(vars(c.normalization.actions_min), n) for n in model.dof_names], np.float32)
        if getattr(c.normalization, "clip_margin_mode", "span") == "deg30":
            margin = np.deg2rad(30.0) * np.ones_like(amax)
        else:
            margin = (np.abs(amax) + np.abs(amin)) * 0.01
        self.clip_max = (amax + margin).astype(np.float32)
        self.clip_min = (amin - margin).astype(np.float32)

        self.feet_links = model.find_links(c.asset.foot_name)
        self.num_feet = len(self.feet_links)
        self.feet_bodies = tuple(model.link_frame(l)[0] for l in self.feet_links)
        self.feet_offsets = torch.stack([model.link_frame(l)[1] for l in self.feet_links]).numpy()
        self.knee_dofs = model.find_dofs(c.asset.knee_name)
        self.hip_roll_dofs = model.find_dofs(c.asset.hip_roll_name)
        self.hip_yaw_dofs = model.find_dofs(c.asset.hip_yaw_name)
        self.ankle_dofs = model.find_dofs(c.asset.ankle_name)
        self.torso_frame = self._opt_frame(c.asset.torso_name + "_link")
        self.forehead_frame = self._opt_frame(getattr(c.asset, "forehead_name", "") + "_link")

        def link_points(link):
            return tuple(p for p in range(model.num_points) if model.point_link[p] == model.link_names.index(link))

        self.feet_point_groups = tuple(link_points(l) for l in self.feet_links)
        term = [l for sub in c.asset.terminate_after_contacts_on for l in model.find_links(sub)]
        self.termination_groups = tuple(link_points(l) for l in dict.fromkeys(term) if link_points(l))
        pen = [l for sub in c.asset.penalize_contacts_on for l in model.find_links(sub)]
        self.penalized_groups = tuple(link_points(l) for l in dict.fromkeys(pen) if link_points(l))
        self.self_pairs = self._self_pairs() if getattr(c.asset, "self_collisions", 0) == 0 and model.num_points \
            else ((), ())

        gx, gy = np.meshgrid(np.asarray(c.terrain.measured_points_x, np.float32),
                             np.asarray(c.terrain.measured_points_y, np.float32), indexing="ij")
        self.num_height_points = gx.size if getattr(c.terrain, "measure_heights", True) else 1

        sim = c.sim
        self.contact = ContactParams(
            stiffness=sim.contact_stiffness, damping_ratio=sim.contact_damping_ratio,
            point_mass=sim.contact_point_mass, slip_velocity=sim.slip_velocity,
            tangent_stiffness=getattr(sim, "contact_tangent_stiffness", 1.0e4),
            joint_limit_violation=getattr(sim, "joint_limit_violation", 0.05),
            self_collision_stiffness=getattr(sim, "contact_self_collision_stiffness", 1.0e5))

        scales = vars(c.rewards.scales)
        self.reward_names = tuple(n for n, s in scales.items() if s != 0 and n != "termination")
        self.reward_scales = {n: scales[n] * self.dt for n in self.reward_names}
        self.termination_scale = scales.get("termination", 0.0) * self.dt if scales.get("termination") else 0.0

        ns, level, os_ = c.noise.noise_scales, c.noise.noise_level, c.normalization.obs_scales
        self.obs_dim = 9 + 3 * d
        v = np.zeros(self.obs_dim, np.float32)
        v[3:6] = ns.ang_vel * level * os_.ang_vel
        v[6:9] = ns.gravity * level * os_.gravity
        v[9: 9 + d] = ns.dof_pos * level * os_.dof_pos
        v[9 + d: 9 + 2 * d] = ns.dof_vel * level * os_.dof_vel
        v[9 + 2 * d:] = ns.action * level * os_.action
        self.noise_vec = v
        self.commands_scale = np.asarray([os_.lin_vel, os_.lin_vel, os_.ang_vel], np.float32)

        cols = int(np.floor(np.sqrt(self.num_envs)))
        rows = int(np.ceil(self.num_envs / cols))
        xx, yy = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        org = np.zeros((self.num_envs, 3), np.float32)
        org[:, 0] = c.env.env_spacing * xx.flatten()[:self.num_envs]
        org[:, 1] = c.env.env_spacing * yy.flatten()[:self.num_envs]
        self.origins = org

        # the bodies whose final-state FK the post stage reads: feet, then the
        # orientation rewards' frames
        bodies = list(self.feet_bodies)
        for fr in (self.torso_frame, self.forehead_frame):
            if fr is not None and fr[0] not in bodies:
                bodies.append(fr[0])
        self.post_fk_bodies = tuple(bodies)
        self._post_slot = {b: i for i, b in enumerate(self.post_fk_bodies)}
        sub = ScalarSubstep(model, self.contact, self.sim_dt, self.self_pairs, terrain_mode="plane")
        damping = np.asarray(self.d_gains) if getattr(c.sim, "implicit_pd_damping", True) else None
        self.post = LanePost(self)
        self.deci = ScalarDecimation(
            sub, self.decimation - int(substeps_less), "P", c.control.action_scale, self.p_gains, self.d_gains,
            self.default_dof_pos, self.torque_limits, self.feet_bodies, self.feet_point_groups,
            post_bodies=self.post_fk_bodies, damping_coeff=damping, post=self.post)

    # -- build helpers -------------------------------------------------------

    def _opt_frame(self, link_name):
        try:
            body, _, quat = self.model.link_frame(link_name)
            return body, quat.numpy()
        except KeyError:
            return None

    def _self_pairs(self):
        """The cross-limb contact-sphere pairs more than 2 cm apart at the
        default pose (different child subtrees of the base)."""
        m = self.model

        def limb_root(body):
            while body > 0 and m.parent[body] != 0:
                body = m.parent[body]
            return body

        quats, rel = body_poses(m, torch.from_numpy(self.default_dof_pos))
        pb = torch.tensor(m.point_body, dtype=torch.long)
        pos = (rel[pb] + quat_apply(quats[pb], m.point_offset)).numpy()
        radius = m.point_radius.numpy()
        pairs = []
        for a in range(m.num_points):
            for b in range(a + 1, m.num_points):
                ba, bb = m.point_body[a], m.point_body[b]
                if ba == 0 or bb == 0 or limb_root(ba) == limb_root(bb):
                    continue
                if np.linalg.norm(pos[a] - pos[b]) - (radius[a] + radius[b]) > 0.02:
                    pairs.append((a, b))
        return tuple(a for a, _ in pairs), tuple(b for _, b in pairs)

    def u_columns(self) -> Dict[str, tuple]:
        """(offset, width) of each random quantity in the step's uniform block."""
        c = self.cfg
        widths = [("delay", 1 if c.control.actuation_delay else 0),
                  ("noise", self.obs_dim if c.noise.add_noise else 0), ("cmd", 3),
                  ("reset", self.num_dof + 13), ("push", 2 if c.domain_rand.push_robots else 0)]
        cols, off = {}, 0
        for name, w in widths:
            cols[name] = (off, w)
            off += w
        return cols

    # -- the step ------------------------------------------------------------

    def _sample_commands(self, u3, x_range):
        r = self.cfg.commands.ranges
        cx = x_range[0] + u3[:, 0] * (x_range[1] - x_range[0])
        cy = r.lin_vel_y[0] + u3[:, 1] * (r.lin_vel_y[1] - r.lin_vel_y[0])
        cyaw = r.ang_vel_yaw[0] + u3[:, 2] * (r.ang_vel_yaw[1] - r.ang_vel_yaw[0])
        cmds = torch.stack([cx, cy, cyaw], dim=-1)
        width = max(3, self.cfg.commands.num_commands)
        if width > 3:
            cmds = torch.cat([cmds, cmds.new_zeros((cmds.shape[0], width - 3))], dim=-1)
        keep = (torch.linalg.vector_norm(cmds[:, :2], dim=1) > 0.1)[:, None]
        return torch.cat([cmds[:, :2] * keep.to(cmds.dtype), cmds[:, 2:]], dim=1)

    def _decimation(self, s: dict, actions, delay, commands):
        """The decimation loop and its post stage on lanes: (new physics,
        torques, post outputs)."""
        col = lambda a: [a[..., i] for i in range(a.shape[-1])]
        n = actions.shape[0]
        lanes = {"pos": col(s["base_pos"]), "quat": col(s["base_quat"]), "lin": col(s["base_lin_vel"]),
                 "ang": col(s["base_ang_vel"]), "q": col(s["q"]), "qd": col(s["qd"]),
                 "anchor": [col(s["anchor"][:, p]) for p in range(s["anchor"].shape[-2])],
                 "friction": s["friction"] * self.friction_scale, "restitution": s["restitution"],
                 "mass_scale": s["base_mass_scale"], "com_offset": col(s["base_com_offset"])}
        extra = {"commands": col(commands[:, :3]), "last_last_actions": col(s["last_last_actions"]),
                 "feet_air_time": col(s["feet_air_time"]), "feet_land_time": col(s["feet_land_time"]),
                 "feet_contact_last": col(s["feet_contact_last"].to(self.dtype))}
        state, acc = self.deci.run(lanes, col(actions), col(s["last_actions"]), col(s["motor_strength"]), delay,
                                   col(s["last_dof_vel"]), extra=extra)
        stack = lambda ls: torch.stack([torch.broadcast_to(x, (n,)) for x in ls], dim=-1)
        phys = {"base_pos": stack(state["pos"]), "base_quat": stack(state["quat"]),
                "base_lin_vel": stack(state["lin"]), "base_ang_vel": stack(state["ang"]),
                "q": stack(state["q"]), "qd": stack(state["qd"]),
                "anchor": torch.stack([stack(a) for a in state["anchor"]], dim=-2)}
        post = {name: stack(acc["post"][name]) for name, _ in self.post.out_schema()}
        return phys, stack(acc["tau"]), post

    def step(self, s: Dict[str, torch.Tensor], actions: torch.Tensor, u: torch.Tensor,
             env_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One policy step of the envs in ``s`` (each (n, ...) field of the
        program's state layout; ``common_step`` 0-d, ``cmd_lin_vel_x_range``
        (2,)), with actions (n, A) and the step's uniform block (n, K).
        ``env_ids``: the envs' indices in the run (their origins). Returns
        the actor's and critic's observations, the reward, the reset and the
        time-out flags."""
        c, dt = self.cfg, self.dtype
        s = {k: (v.to(dt) if torch.is_floating_point(v) else v) for k, v in s.items()}
        actions, u = actions.to(dt), u.to(dt)
        n, d = actions.shape[0], self.num_dof
        cols = self.u_columns()
        u_of = lambda name: u[:, cols[name][0]: cols[name][0] + cols[name][1]]
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dt)

        actions = torch.clamp(actions, t(self.clip_min), t(self.clip_max))
        if c.control.actuation_delay:
            un = torch.clamp(u_of("delay"), 1e-7, 1.0 - 1e-7)
            delay = c.control.actuation_delay_mean + c.control.actuation_delay_std * (
                math.sqrt(2.0) * torch.special.erfinv(2.0 * un - 1.0))
            delay = torch.clamp(delay, min=0.0)
        else:
            delay = torch.zeros((n, 1), dtype=dt)
        episode_length = s["episode_length"] + 1
        common_step = s["common_step"] + 1
        resample = (episode_length % self.resample_interval) == 0
        x_range = s["cmd_lin_vel_x_range"]
        commands = torch.where(resample[:, None], self._sample_commands(u_of("cmd"), x_range), s["commands"])

        phys, torques, po = self._decimation(s, actions, delay[:, 0], commands)
        time_out = episode_length > self.max_episode_length
        hscale = c.normalization.obs_scales.height_measurements
        target_h = c.rewards.base_height_target
        blv, bav, pg = po["blv"], po["bav"], po["pg"]
        feet_height, bho = po["feet_height"], po["bho"][:, 0]
        bad = po["bad"][:, 0] > 0.5
        reset = (po["term_contact"][:, 0] > 0.5) | (po["tilt"][:, 0] > 0.5) | time_out | bad
        sho = (torch.clamp(phys["base_pos"][:, 2:3] - target_h, -1.0, 1.0) * hscale).expand(n, self.num_height_points)
        terms = po["rew_terms"]
        rew = torch.sum(terms[:, : len(self.reward_names)], dim=1)
        if c.rewards.only_positive_rewards:
            rew = torch.clamp(rew, min=0.0)
        if self.termination_scale:
            rew = rew + (reset & ~time_out).to(dt) * self.termination_scale

        if c.domain_rand.push_robots:
            do_push = (common_step % self.push_interval) == 0
            mx = c.domain_rand.max_push_vel_xy
            pushed = torch.cat([-mx + 2.0 * mx * u_of("push"), phys["base_lin_vel"][:, 2:]], dim=1)
            phys["base_lin_vel"] = torch.where(do_push, pushed, phys["base_lin_vel"])

        # resets of the done envs (legged_robot.py reset_idx, branchless)
        ur = u_of("reset")
        u_q, u_yaw, u_vel, u_cmd = ur[:, :d], ur[:, d + 2], ur[:, d + 3: d + 9], ur[:, d + 9: d + 12]
        default = t(self.default_dof_pos)
        q_new = (0.5 + u_q) * default if c.domain_rand.randomize_init_dof_pos else default.expand(n, d)
        ids = torch.arange(n) if env_ids is None else env_ids
        pos_new = t(c.init_state.pos) + torch.as_tensor(self.origins)[ids].to(dt)
        zero = torch.zeros_like(u_yaw)
        quat_new = quat_from_euler_xyz(zero, zero, -2.0 * np.pi + 4.0 * np.pi * u_yaw)
        vel6 = -0.5 + u_vel if c.domain_rand.randomize_init_base_velocity else torch.zeros((n, 6), dtype=dt)
        m1 = reset[:, None]
        w = lambda new, old: torch.where(reset.reshape(n, *([1] * (old.dim() - 1))), new, old)
        phys = {"base_pos": w(pos_new, phys["base_pos"]), "base_quat": w(quat_new, phys["base_quat"]),
                "base_lin_vel": w(vel6[:, :3], phys["base_lin_vel"]),
                "base_ang_vel": w(vel6[:, 3:], phys["base_ang_vel"]), "q": w(q_new, phys["q"]),
                "qd": w(torch.zeros_like(phys["qd"]), phys["qd"])}
        commands = torch.where(m1, self._sample_commands(u_cmd, x_range), commands)

        # observations from the post-reset state; a reset env's base-frame
        # quantities are recomputed
        quat = phys["base_quat"]
        down = t([0.0, 0.0, -1.0]).expand(n, 3)
        blv = torch.where(m1, quat_rotate_inverse(quat, phys["base_lin_vel"]), blv)
        bav = torch.where(m1, quat_rotate_inverse(quat, phys["base_ang_vel"]), bav)
        pg = torch.where(m1, quat_rotate_inverse(quat, down), pg)
        os_ = c.normalization.obs_scales
        obs = torch.cat([commands[:, :3] * t(self.commands_scale), bav * os_.ang_vel, pg * os_.gravity,
                         (phys["q"] - default) * os_.dof_pos, phys["qd"] * os_.dof_vel, actions * os_.action], dim=-1)
        pri = torch.cat([obs, blv * os_.lin_vel, bho[:, None] * hscale, (po["feet_contact"] > 0.5).to(dt),
                         feet_height * hscale, sho * hscale], dim=-1)
        if c.noise.add_noise:
            obs = obs + (2.0 * u_of("noise") - 1.0) * t(self.noise_vec)
        clip = c.normalization.clip_observations
        obs = torch.nan_to_num(torch.clamp(obs, -clip, clip))
        pri = torch.nan_to_num(torch.clamp(pri, -clip, clip))
        f32 = lambda x: x.to(torch.float32)
        return {"obs": f32(obs), "critic_obs": f32(pri), "rew": f32(rew), "reset": reset, "time_out": time_out}

