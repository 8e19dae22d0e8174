"""Eval-time state/reward logger (port of ``wiki_grx_gym_tpu/utils/logger.py``).

Collects per-step scalars of one robot and renders the reference's 3x3
dashboard (joint tracking, base velocity against the command, contact
forces) to a file with matplotlib's Agg backend. The logger holds host
values only (Python floats and numpy rows); the caller moves them off the
device. It keeps the JAX version's bookkeeping: ``log_rewards`` stores each
value times the number of episodes that ended at that step, and
``print_rewards`` divides their sum by ``max(num_episodes, 1)``.

matplotlib is imported by :meth:`EvalLogger.save_plots` alone, so the
logger works without it; ``save_plots`` raises ImportError then.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class EvalLogger:
    def __init__(self, dt: float):
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.dt = dt
        self.num_episodes = 0

    def log_state(self, key, value):
        self.state_log[key].append(value)

    def log_states(self, d):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d, num_episodes: int):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(v * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")

    def save_plots(self, path: str):
        """The 3x3 dashboard, panel for panel the JAX version's: base
        velocity x/y/yaw against the command, DOF position and velocity
        against the target, base velocity z, vertical contact forces per
        foot, the torque/velocity scatter, and torque over time."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        log = self.state_log
        n = max((len(v) for v in log.values()), default=1)
        time = np.linspace(0, n * self.dt, n)
        fig, axs = plt.subplots(3, 3, figsize=(15, 10))

        def series(key):
            return np.asarray(log[key], dtype=float) if log.get(key) else None

        def plot(ax, pairs, title, xlabel, ylabel):
            for key, label in pairs:
                y = series(key)
                if y is not None:
                    ax.plot(time[: len(y)], y, label=label)
            ax.set(title=title, xlabel=xlabel, ylabel=ylabel)
            if ax.get_legend_handles_labels()[0]:
                ax.legend(fontsize="x-small")

        plot(axs[0, 0], [("base_vel_x", "measured"), ("command_x", "commanded")],
             "Base velocity x", "time [s]", "base lin vel [m/s]")
        plot(axs[0, 1], [("base_vel_y", "measured"), ("command_y", "commanded")],
             "Base velocity y", "time [s]", "base lin vel [m/s]")
        plot(axs[0, 2], [("base_vel_yaw", "measured"), ("command_yaw", "commanded")],
             "Base velocity yaw", "time [s]", "base ang vel [rad/s]")
        plot(axs[1, 0], [("dof_pos", "measured"), ("dof_pos_target", "target")],
             "DOF Position", "time [s]", "Position [rad]")
        plot(axs[1, 1], [("dof_vel", "measured"), ("dof_vel_target", "target")],
             "Joint Velocity", "time [s]", "Velocity [rad/s]")
        plot(axs[1, 2], [("base_vel_z", "measured")],
             "Base velocity z", "time [s]", "base lin vel [m/s]")
        # vertical contact forces, one line per foot
        a = axs[2, 0]
        if log.get("contact_forces_z"):
            forces = np.stack(log["contact_forces_z"])
            for i in range(forces.shape[1]):
                a.plot(time[: forces.shape[0]], forces[:, i], label=f"force {i}")
        a.set(title="Vertical Contact forces", xlabel="time [s]", ylabel="Forces z [N]")
        if a.get_legend_handles_labels()[0]:
            a.legend(fontsize="x-small")
        # torque/velocity scatter
        a = axs[2, 1]
        tv, tq = series("dof_vel"), series("dof_torque")
        if tv is not None and tq is not None:
            m = min(len(tv), len(tq))
            a.plot(tv[:m], tq[:m], "x", label="measured")
        a.set(title="Torque/velocity curves", xlabel="Joint vel [rad/s]",
              ylabel="Joint Torque [Nm]")
        if a.get_legend_handles_labels()[0]:
            a.legend(fontsize="x-small")
        plot(axs[2, 2], [("dof_torque", "measured")],
             "Torque", "time [s]", "Joint Torque [Nm]")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        print(f"Saved eval dashboard to {path}")
