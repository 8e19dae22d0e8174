"""K1's post-physics tail, frozen: a copy of the port's lane-form
post-physics program (``LanePost``): the reward terms, termination and the
feet trackers after the decimation loop on the plane, which K1 computes in
its post fold. Measured heights are identically zero on the plane, so
``feet_height`` is the world foot z and ``base_height`` the world base z.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.lanes import (
    _clip,
    _div,
    _dot,
    _maximum,
    _minimum,
    _qapply,
    _qmul,
)


def _qrotinv(q, v):
    """maths.quat_rotate_inverse in lane form."""
    return _qapply([-q[0], -q[1], -q[2], q[3]], v)


def _norm2(x, y):
    return torch.sqrt(x * x + y * y)


def _norm3(v):
    return torch.sqrt(_maximum(_dot(v, v), 0.0))


class LanePost:
    """Static spec + lane program for the post-physics stage.

    Built by ``env.RefEnv`` (which owns every constant); consumed by
    ``ScalarDecimation.run`` after the decimation loop."""

    def __init__(self, env):
        c = env.cfg
        self.nd = env.num_dof
        self.nf = env.num_feet
        self.dt = float(env.dt)
        self.decimation = int(env.decimation)
        self.action_scale = float(c.control.action_scale)
        self.default_dof_pos = np.asarray(env.default_dof_pos, np.float64)
        self.dof_pos_soft_lower = np.asarray(env.dof_pos_soft_lower, np.float64)
        self.dof_pos_soft_upper = np.asarray(env.dof_pos_soft_upper, np.float64)
        self.dof_vel_limits = np.asarray(env.dof_vel_limits, np.float64)
        self.torque_limits = np.asarray(env.torque_limits, np.float64)
        self.rw = c.rewards           # sigmas + targets namespace
        self.hscale = float(c.normalization.obs_scales.height_measurements)
        self.target_h = float(c.rewards.base_height_target)

        self.knee_dofs = tuple(env.knee_dofs)
        self.hip_roll_dofs = tuple(env.hip_roll_dofs)
        self.hip_yaw_dofs = tuple(env.hip_yaw_dofs)
        self.ankle_dofs = tuple(env.ankle_dofs)

        # post-FK slots (the decimation program emits post_quat/post_rel
        # for env.post_fk_bodies in that order)
        self.feet_slots = tuple(env._post_slot[b] for b in env.feet_bodies)
        self.feet_offsets = np.asarray(env.feet_offsets, np.float64)  # (F, 3)
        self.torso = (
            None if env.torso_frame is None
            else (env._post_slot[env.torso_frame[0]],
                  np.asarray(env.torso_frame[1], np.float64))
        )
        self.forehead = (
            None if env.forehead_frame is None
            else (env._post_slot[env.forehead_frame[0]],
                  np.asarray(env.forehead_frame[1], np.float64))
        )

        self.feet_point_groups = tuple(tuple(g) for g in env.feet_point_groups)
        self.termination_groups = tuple(tuple(g) for g in env.termination_groups)
        self.penalized_groups = tuple(tuple(g) for g in env.penalized_groups)

        self.reward_names = tuple(env.reward_names)  # excl. termination
        self.scales = dict(env.reward_scales)        # already x dt
        missing = [n for n in self.reward_names if not hasattr(self, "_rw_" + n)]
        assert not missing, f"no lane-form implementation for rewards {missing}"

    # ------------------------------------------------------------------
    # decimation-program I/O schemas
    # ------------------------------------------------------------------

    def extra_schema(self):
        """(name, count) of the extra input lanes the post stage consumes.
        ``last_dof_vel`` is shared with the PD input ``last_qd``."""
        return [
            ("commands", 3),
            ("last_last_actions", self.nd),
            ("feet_air_time", self.nf),
            ("feet_land_time", self.nf),
            ("feet_contact_last", self.nf),
        ]

    def out_schema(self):
        return [
            ("rew_terms", len(self.reward_names)),
            ("blv", 3), ("bav", 3), ("pg", 3),
            ("term_contact", 1), ("tilt", 1), ("bad", 1),
            ("feet_contact", self.nf), ("contact_filt", self.nf),
            ("first_contact", self.nf),
            ("feet_air_time_out", self.nf), ("feet_land_time_out", self.nf),
            ("feet_height", self.nf), ("bho", 1),
        ]

    # ------------------------------------------------------------------
    # the program
    # ------------------------------------------------------------------

    def run(self, state, acc, actions, last_actions, extra, last_dof_vel) -> Dict:
        """All lanes in, post lanes out (see :meth:`out_schema`)."""
        quat = state["quat"]
        blv = _qrotinv(quat, state["lin"])
        bav = _qrotinv(quat, state["ang"])
        one = torch.ones_like(state["pos"][2])
        pg = _qrotinv(quat, [0.0 * one, 0.0 * one, -1.0 * one])

        def frame_pg(frame):
            if frame is None:
                return pg
            slot, qoff = frame
            fq = _qmul(acc["post_quat"][slot], [float(x) for x in qoff])
            return _qrotinv(fq, [0.0 * one, 0.0 * one, -1.0 * one])

        torso_pg = frame_pg(self.torso)
        forehead_pg = frame_pg(self.forehead)

        # feet world heights (plane: measured heights == 0)
        feet_height = []
        for f in range(self.nf):
            s = self.feet_slots[f]
            off = [float(x) for x in self.feet_offsets[f]]
            pz = (
                state["pos"][2]
                + acc["post_rel"][s][2]
                + _qapply(acc["post_quat"][s], off)[2]
            )
            feet_height.append(pz)

        # per-group net contact forces
        def group_force(groups):
            out = []
            for grp in groups:
                fx = sum(acc["point_force"][p][0] for p in grp)
                fy = sum(acc["point_force"][p][1] for p in grp)
                fz = sum(acc["point_force"][p][2] for p in grp)
                out.append([fx, fy, fz])
            return out

        feet_force = group_force(self.feet_point_groups)

        # air/land trackers
        fc_last = extra["feet_contact_last"]
        feet_contact = [feet_force[f][2] > 1.0 for f in range(self.nf)]
        contact_filt = [feet_contact[f] | (fc_last[f] > 0.5) for f in range(self.nf)]
        fat_in = extra["feet_air_time"]
        first_contact = [
            ((fat_in[f] > 0.0) & contact_filt[f]).to(one.dtype)
            for f in range(self.nf)
        ]
        feet_air_time = [fat_in[f] + self.dt for f in range(self.nf)]
        feet_land_time = [
            (extra["feet_land_time"][f] + self.dt)
            * feet_contact[f].to(one.dtype)
            for f in range(self.nf)
        ]

        # termination channels
        term = torch.zeros_like(one, dtype=torch.bool)
        for gf in group_force(self.termination_groups):
            term = term | (_norm3(gf) > 1.0)
        tilt = torch.abs(pg[2]) < 0.33
        fin = torch.isfinite(sum(state["pos"]) + sum(state["quat"]))
        for i in range(self.nd):
            fin = fin & torch.isfinite(state["q"][i]) & torch.isfinite(state["qd"][i])
        bad = ~fin

        pen_count = sum(
            (_norm3(gf) > 0.1).to(one.dtype)
            for gf in group_force(self.penalized_groups)
        ) if self.penalized_groups else torch.zeros_like(one)

        bho = _clip(state["pos"][2] - self.target_h, -1.0, 1.0) * self.hscale

        ctx = dict(
            commands=extra["commands"],
            blv=blv, bav=bav, pg=pg, torso_pg=torso_pg, forehead_pg=forehead_pg,
            q=state["q"], qd=state["qd"],
            dof_acc=[_div(state["qd"][i] - last_dof_vel[i], self.dt)
                     for i in range(self.nd)],
            tau=acc["tau"],
            actions=actions, last_actions=last_actions,
            last_last_actions=extra["last_last_actions"],
            feet_contact=feet_contact,
            first_contact=first_contact,
            feet_air_time=feet_air_time,
            feet_land_time=feet_land_time,
            feet_height=feet_height,
            feet_force=feet_force,
            avg_force=[_div(acc["force_sum"][f], self.decimation) for f in range(self.nf)],
            avg_vxyz=[[_div(acc["vxyz_sum"][f][k], self.decimation) for k in range(3)]
                      for f in range(self.nf)],
            pen_count=pen_count,
            bho=bho,
            base_height=state["pos"][2],
            cmd_active=(_norm2(extra["commands"][0], extra["commands"][1]) > 0.1
                        ).to(one.dtype),
        )

        # a NaN env earns 0 reward: select (not multiply, NaN * 0 == NaN)
        zero = torch.zeros_like(one)
        terms = [
            torch.where(fin, self.scales[name] * getattr(self, "_rw_" + name)(ctx), zero)
            for name in self.reward_names
        ]

        b = lambda m: m.to(one.dtype)
        return {
            "rew_terms": terms,
            "blv": blv, "bav": bav, "pg": pg,
            "term_contact": [b(term)], "tilt": [b(tilt)], "bad": [b(bad)],
            "feet_contact": [b(x) for x in feet_contact],
            "contact_filt": [b(x) for x in contact_filt],
            "first_contact": first_contact,
            "feet_air_time_out": feet_air_time,
            "feet_land_time_out": feet_land_time,
            "feet_height": feet_height,
            "bho": [bho],
        }

    # ------------------------------------------------------------------
    # reward terms, lane form (one per registry name)
    # ------------------------------------------------------------------

    def _sum_abs(self, xs, idx=None):
        idx = range(len(xs)) if idx is None else idx
        return sum(torch.abs(xs[i]) for i in idx)

    def _rw_collision(self, ctx):
        return 1.0 - torch.exp(self.rw.sigma_collision * ctx["pen_count"])

    def _rw_stand_still(self, ctx):
        err = sum(
            torch.abs(ctx["q"][i] - float(self.default_dof_pos[i]))
            for i in range(self.nd)
        )
        sel = 1.0 - ctx["cmd_active"]
        return torch.exp(self.rw.sigma_stand_still * err) * sel

    def _rw_cmd_diff_lin_vel_x(self, ctx):
        err = torch.abs(ctx["commands"][0] - ctx["blv"][0])
        return torch.exp(self.rw.sigma_cmd_diff_lin_vel_x * err)

    def _rw_cmd_diff_lin_vel_y(self, ctx):
        err = torch.abs(ctx["commands"][1] - ctx["blv"][1])
        return torch.exp(self.rw.sigma_cmd_diff_lin_vel_y * err)

    def _rw_cmd_diff_lin_vel_z(self, ctx):
        return torch.exp(self.rw.sigma_cmd_diff_lin_vel_z * torch.abs(ctx["blv"][2]))

    def _rw_cmd_diff_ang_vel_roll(self, ctx):
        return torch.exp(self.rw.sigma_cmd_diff_ang_vel_roll * torch.abs(ctx["bav"][0]))

    def _rw_cmd_diff_ang_vel_pitch(self, ctx):
        return torch.exp(self.rw.sigma_cmd_diff_ang_vel_pitch * torch.abs(ctx["bav"][1]))

    def _rw_cmd_diff_ang_vel_yaw(self, ctx):
        err = torch.abs(ctx["commands"][2] - ctx["bav"][2])
        return torch.exp(self.rw.sigma_cmd_diff_ang_vel_yaw * err)

    def _rw_cmd_diff_base_height(self, ctx):
        err = torch.abs(ctx["bho"]) * (ctx["bho"] < 0)
        return torch.exp(self.rw.sigma_cmd_diff_base_height * err)

    def _rw_cmd_diff_base_orient(self, ctx):
        err = torch.abs(ctx["pg"][0]) + torch.abs(ctx["pg"][1])
        return torch.exp(self.rw.sigma_cmd_diff_base_orient * err)

    def _rw_cmd_diff_torso_orient(self, ctx):
        err = torch.abs(ctx["torso_pg"][0]) + torch.abs(ctx["torso_pg"][1])
        return torch.exp(self.rw.sigma_cmd_diff_torso_orient * err)

    def _rw_cmd_diff_forehead_orient(self, ctx):
        err = torch.abs(ctx["forehead_pg"][0]) + torch.abs(ctx["forehead_pg"][1])
        return torch.exp(self.rw.sigma_cmd_diff_forehead_orient * err)

    def _rw_action_diff(self, ctx):
        err = sum(
            torch.abs((ctx["last_actions"][i] - ctx["actions"][i]) * self.action_scale)
            for i in range(self.nd)
        )
        return 1.0 - torch.exp(self.rw.sigma_action_diff * err)

    def _rw_action_diff_diff(self, ctx):
        err = sum(
            torch.abs(
                (ctx["last_actions"][i] - ctx["actions"][i]) * self.action_scale
                - (ctx["last_last_actions"][i] - ctx["last_actions"][i])
                * self.action_scale
            )
            for i in range(self.nd)
        )
        return 1.0 - torch.exp(self.rw.sigma_action_diff_diff * err)

    def _rw_action_diff_knee(self, ctx):
        err = sum(
            torch.abs((ctx["actions"][i] - ctx["last_actions"][i]) * self.action_scale)
            for i in self.knee_dofs
        )
        return 1.0 - torch.exp(self.rw.sigma_action_diff_knee * err)

    def _rw_dof_vel_new(self, ctx):
        return 1.0 - torch.exp(self.rw.sigma_dof_vel_new * self._sum_abs(ctx["qd"]))

    def _rw_dof_vel_new_knee(self, ctx):
        err = self._sum_abs(ctx["qd"], self.knee_dofs)
        return 1.0 - torch.exp(self.rw.sigma_dof_vel_new_knee * err)

    def _rw_dof_acc_new(self, ctx):
        return 1.0 - torch.exp(self.rw.sigma_dof_acc_new * self._sum_abs(ctx["dof_acc"]))

    def _rw_dof_tor_new(self, ctx):
        return 1.0 - torch.exp(self.rw.sigma_dof_tor_new * self._sum_abs(ctx["tau"]))

    def _rw_dof_tor_new_hip_roll(self, ctx):
        err = self._sum_abs(ctx["tau"], self.hip_roll_dofs)
        return 1.0 - torch.exp(self.rw.sigma_dof_tor_new_hip_roll * err)

    def _rw_pose_offset(self, ctx):
        err = sum(
            torch.abs(ctx["q"][i] - float(self.default_dof_pos[i]))
            for i in range(self.nd)
        )
        return torch.exp(self.rw.sigma_pose_offset * err)

    def _rw_pose_offset_hip_yaw(self, ctx):
        err = sum(
            torch.abs(ctx["q"][i] - float(self.default_dof_pos[i]))
            for i in self.hip_yaw_dofs
        )
        return 1.0 - torch.exp(self.rw.sigma_pose_offset_hip_yaw * err)

    def _rw_limits_dof_pos(self, ctx):
        err = 0.0
        for i in range(self.nd):
            lo = -_minimum(ctx["q"][i] - float(self.dof_pos_soft_lower[i]), 0.0)
            hi = _maximum(ctx["q"][i] - float(self.dof_pos_soft_upper[i]), 0.0)
            err = err + torch.abs(lo + hi)
        return 1.0 - torch.exp(self.rw.sigma_limits_dof_pos * err)

    def _rw_limits_dof_vel(self, ctx):
        soft = self.rw.soft_dof_vel_limit
        err = sum(
            _clip(torch.abs(ctx["qd"][i]) - float(self.dof_vel_limits[i]) * soft, 0.0, 1.0)
            for i in range(self.nd)
        )
        return 1.0 - torch.exp(self.rw.sigma_limits_dof_vel * err)

    def _rw_limits_dof_tor(self, ctx):
        soft = self.rw.soft_torque_limit
        err = sum(
            _maximum(torch.abs(ctx["tau"][i]) - float(self.torque_limits[i]) * soft, 0.0)
            for i in range(self.nd)
        )
        return 1.0 - torch.exp(self.rw.sigma_limits_dof_tor * err)

    def _rw_dof_tor_ankle_feet_lift_up(self, ctx):
        sig = self.rw.sigma_dof_tor_ankle_feet_lift_up
        target = self.rw.swing_feet_height_target
        half = len(self.ankle_dofs) // 2
        left, right = self.ankle_dofs[:half], self.ankle_dofs[half:]
        lh, rh = ctx["feet_height"][0], ctx["feet_height"][1]
        err_l = self._sum_abs(ctx["tau"], left) * torch.abs(lh) * (lh > target / 2)
        err_r = self._sum_abs(ctx["tau"], right) * torch.abs(rh) * (rh > target / 2)
        return 1.0 - torch.exp(sig * (err_l + err_r))

    def _rw_feet_speed_xy_close_to_ground(self, ctx):
        sig = self.rw.sigma_feet_speed_xy_close_to_ground
        quarter = self.rw.swing_feet_height_target / 4
        err = 0.0
        for f in range(self.nf):
            h = ctx["feet_height"][f]
            closeness = _div(torch.abs(h - quarter) * (h < quarter), quarter)
            v = ctx["avg_vxyz"][f]
            err = err + _norm2(v[0], v[1]) * closeness
        return torch.exp(sig * err)

    def _rw_feet_speed_z_close_to_height_target(self, ctx):
        sig = self.rw.sigma_feet_speed_z_close_to_height_target
        target = self.rw.swing_feet_height_target
        err = 0.0
        for f in range(self.nf):
            h = ctx["feet_height"][f]
            closeness = _div(torch.abs(h - target * 3 / 4) * (h > target * 3 / 4), target / 4)
            err = err + torch.abs(ctx["avg_vxyz"][f][2]) * closeness
        return torch.exp(sig * err)

    def _rw_feet_air_time(self, ctx):
        sig = self.rw.sigma_feet_air_time
        target = self.rw.feet_air_time_target
        rew = sum(
            torch.exp(sig * torch.abs(ctx["feet_air_time"][f] - target))
            * ctx["first_contact"][f]
            for f in range(self.nf)
        )
        return rew * ctx["cmd_active"]

    def _rw_feet_air_height(self, ctx):
        sig = self.rw.sigma_feet_air_height
        target = self.rw.swing_feet_height_target
        min_h = ctx["feet_height"][0]
        for f in range(1, self.nf):
            min_h = _minimum(min_h, ctx["feet_height"][f])
        err = 0.0
        for f in range(self.nf):
            err_h = torch.abs(ctx["feet_height"][f] - min_h - target)
            mid = torch.abs(ctx["feet_air_time"][f] - self.rw.feet_air_time_target / 2)
            err = err + mid * err_h
        return torch.exp(sig * err) * ctx["cmd_active"]

    def _rw_feet_air_force(self, ctx):
        sig = self.rw.sigma_feet_air_force
        err = sum(
            torch.abs(ctx["feet_air_time"][f] - self.rw.feet_air_time_target / 2)
            * ctx["avg_force"][f]
            for f in range(self.nf)
        )
        return torch.exp(sig * err) * ctx["cmd_active"]

    def _rw_feet_land_time(self, ctx):
        sig = self.rw.sigma_feet_land_time
        mx = self.rw.feet_land_time_max
        rew = sum(
            1.0 - torch.exp(
                sig * (ctx["feet_land_time"][f] - mx) * (ctx["feet_land_time"][f] > mx)
            )
            for f in range(self.nf)
        )
        return rew * ctx["cmd_active"]

    def _rw_on_the_air(self, ctx):
        n_contact = sum(c.to(torch.float32) for c in ctx["feet_contact"])
        return (n_contact == 0).to(torch.float32)

    def _rw_feet_stumble(self, ctx):
        sig = self.rw.sigma_feet_stumble
        ratio = self.rw.feet_stumble_ratio
        rew = 0.0
        for f in range(self.nf):
            fo = ctx["feet_force"][f]
            err = _maximum(_norm2(fo[0], fo[1]) - ratio * torch.abs(fo[2]), 0.0)
            rew = rew + (1.0 - torch.exp(sig * err))
        return rew

    # ETH base terms

    def _rw_lin_vel_z(self, ctx):
        return torch.square(ctx["blv"][2])

    def _rw_ang_vel_xy(self, ctx):
        return torch.square(ctx["bav"][0]) + torch.square(ctx["bav"][1])

    def _rw_orientation(self, ctx):
        return torch.square(ctx["pg"][0]) + torch.square(ctx["pg"][1])

    def _rw_torques(self, ctx):
        return sum(torch.square(t) for t in ctx["tau"])

    def _rw_dof_vel(self, ctx):
        return sum(torch.square(x) for x in ctx["qd"])

    def _rw_dof_acc(self, ctx):
        return sum(torch.square(x) for x in ctx["dof_acc"])

    def _rw_action_rate(self, ctx):
        return sum(
            torch.square(ctx["last_actions"][i] - ctx["actions"][i])
            for i in range(self.nd)
        )

    def _rw_tracking_lin_vel(self, ctx):
        err = torch.square(ctx["commands"][0] - ctx["blv"][0]) + torch.square(
            ctx["commands"][1] - ctx["blv"][1]
        )
        return torch.exp(_div(-err, self.rw.tracking_sigma))

    def _rw_tracking_ang_vel(self, ctx):
        err = torch.square(ctx["commands"][2] - ctx["bav"][2])
        return torch.exp(_div(-err, self.rw.tracking_sigma))

    def _rw_feet_contact_forces(self, ctx):
        mx = self.rw.max_contact_force
        return sum(
            _maximum(_norm3(ctx["feet_force"][f]) - mx, 0.0)
            for f in range(self.nf)
        )

    def _rw_base_height(self, ctx):
        return torch.square(ctx["base_height"] - self.target_h)

    def _rw_dof_pos_limits(self, ctx):
        err = 0.0
        for i in range(self.nd):
            under = _minimum(ctx["q"][i] - float(self.dof_pos_soft_lower[i]), 0.0)
            over = _maximum(ctx["q"][i] - float(self.dof_pos_soft_upper[i]), 0.0)
            err = err + (over - under)
        return err

    def _rw_dof_vel_limits(self, ctx):
        soft = self.rw.soft_dof_vel_limit
        return sum(
            _clip(torch.abs(ctx["qd"][i]) - float(self.dof_vel_limits[i]) * soft, 0.0, 1.0)
            for i in range(self.nd)
        )

    def _rw_torque_limits(self, ctx):
        soft = self.rw.soft_torque_limit
        return sum(
            _maximum(torch.abs(ctx["tau"][i]) - float(self.torque_limits[i]) * soft, 0.0)
            for i in range(self.nd)
        )

    def _rw_limits_actions(self, ctx):
        err = 0.0
        for i in range(self.nd):
            scaled = ctx["actions"][i] * self.action_scale
            under = _minimum(scaled - float(self.dof_pos_soft_lower[i]), 0.0)
            over = _maximum(scaled - float(self.dof_pos_soft_upper[i]), 0.0)
            err = err + torch.square(over - under)
        return 1.0 - torch.exp(self.rw.sigma_limits_actions * err)

    def _rw_stumble(self, ctx):
        any_st = torch.zeros_like(ctx["base_height"], dtype=torch.bool)
        for f in range(self.nf):
            fo = ctx["feet_force"][f]
            any_st = any_st | (_norm2(fo[0], fo[1]) > 5.0 * torch.abs(fo[2]))
        return any_st.to(torch.float32)
