"""Offline trajectory visualizer (port of ``tools/visualize.py``).

Two modes, each split into what runs on the env's device and what draws:

- ``--replay traj.npz`` (a ``play --record`` file): :func:`replay_frames`
  runs forward kinematics over the recorded (base_pos, base_quat, q) on the
  device and returns every body's world position per frame;
  :func:`render_replay` draws them as an animated 3D line skeleton (GIF).
- otherwise: :func:`rollout` steps a policy (a ``policy.npz``, or zero
  actions) in a clean one-env eval env and returns the base, feet, joint,
  torque, contact and body series; :func:`render_rollout` draws the
  multi-panel figure (side and top base paths, feet heights with contact
  shading, joint positions and torques, a stick-figure strip).

The drawing needs matplotlib (and Pillow for the GIF) and raises
ImportError naming what is missing.

    python -m wiki_grx_gym_tpu_torch.tools.visualize --task GR1T1 [--policy policy.npz] [--steps 300] [--out traj.png]
    python -m wiki_grx_gym_tpu_torch.tools.visualize --replay logs/GR1T1/traj.npz [--out replay.gif]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.scripts.play import no_randomization
from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing needs matplotlib, which is not installed; the frames and series "
                          "are computed without it (replay_frames, rollout)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _one_env(task: str, device):
    """One env of ``task`` with randomization off, on ``device``."""
    env_cfg, _ = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = 1
    return task_registry.make_env(task, env_cfg=no_randomization(env_cfg), device=device)[0]


@torch.no_grad()
def replay_frames(path: str, device="cuda", max_frames: int = 120, dtype=torch.float32):
    """Every ``stride``-th pose of a ``traj.npz`` (``stride`` = T //
    ``max_frames``, at least 1) through the task's forward kinematics on
    ``device`` in ``dtype``. Returns (frames (F, B, 3) float64 numpy: each
    body's world position, the env's robot model, the task, dt, stride)."""
    data = np.load(path, allow_pickle=False)
    task = str(data["task"])
    model = _one_env(task, device).model
    t_steps = data["q"].shape[0]
    stride = max(1, t_steps // max_frames)
    idxs = np.arange(0, t_steps, stride)
    as_t = lambda a: torch.as_tensor(np.asarray(a)[idxs], dtype=dtype, device=device)
    quat, q, base = as_t(data["base_quat"]), as_t(data["q"]), as_t(data["base_pos"])
    zeros3 = torch.zeros_like(base)
    kin = forward_kinematics(model, quat, zeros3, zeros3, q, torch.zeros_like(q))
    frames = (base[:, None, :] + kin.pos_rel).cpu().to(torch.float64).numpy()
    dt = float(data["dt"]) if "dt" in data else 0.02
    return frames, model, task, dt, stride


def render_replay(frames, model, task: str, dt: float, stride: int, out: str) -> str:
    """Draw ``replay_frames``' skeletons as a GIF at ``out`` (its suffix
    made ``.gif``); returns the path written."""
    plt = _pyplot()
    from matplotlib import animation

    try:
        import PIL  # noqa: F401  (animation.PillowWriter)
    except ImportError as e:
        raise ImportError("the replay GIF needs Pillow, which is not installed") from e
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    bones = [(model.parent[i], i) for i in range(1, model.num_bodies)]
    lines = [ax.plot([], [], [], "o-", lw=2, ms=2.5, color="tab:blue")[0] for _ in bones]
    path, = ax.plot([], [], [], "-", lw=0.8, color="tab:gray")
    lo = frames.min(axis=(0, 1)) - 0.2
    hi = frames.max(axis=(0, 1)) + 0.2
    mid, span = (lo + hi) / 2, float(np.max(hi - lo)) / 2
    ax.set_xlim(mid[0] - span, mid[0] + span)
    ax.set_ylim(mid[1] - span, mid[1] + span)
    ax.set_zlim(0.0, 2 * span)
    ax.set(xlabel="x [m]", ylabel="y [m]", zlabel="z [m]", title=f"{task} pose replay")
    # the initial camera from the task's viewer config (pos looking at lookat)
    v = task_registry.get_cfgs(task)[0].viewer
    d = np.asarray(v.lookat, float) - np.asarray(v.pos, float)
    ax.view_init(elev=float(np.degrees(np.arctan2(-d[2], np.hypot(d[0], d[1])))),
                 azim=float(np.degrees(np.arctan2(d[1], d[0]))))

    def draw(f):
        pts = frames[f]
        for ln, (p, i) in zip(lines, bones):
            ln.set_data([pts[p, 0], pts[i, 0]], [pts[p, 1], pts[i, 1]])
            ln.set_3d_properties([pts[p, 2], pts[i, 2]])
        path.set_data(frames[: f + 1, 0, 0], frames[: f + 1, 0, 1])
        path.set_3d_properties(frames[: f + 1, 0, 2])
        return lines + [path]

    ani = animation.FuncAnimation(fig, draw, frames=len(frames), blit=True)
    out = out if out.endswith(".gif") else out.rsplit(".", 1)[0] + ".gif"
    ani.save(out, writer=animation.PillowWriter(fps=max(1, int(round(1.0 / (dt * stride))))))
    plt.close(fig)
    print(f"saved {out} ({len(frames)} frames)")
    return out


@torch.no_grad()
def rollout(task: str, policy_path=None, steps: int = 300, command=(0.5, 0.0, 0.0), device="cuda"):
    """Step one env with randomization off under a fixed ``command`` for
    ``steps`` policy steps, the actions from the ``policy.npz`` at
    ``policy_path`` (``utils/helpers.py:load_policy_npz``, on the host) or
    zero. Returns the env and numpy series: ``base`` (T, 3), ``feet`` (T,
    F, 3), ``q`` and ``tau`` (T, D), ``contact`` (T, F), ``bodies`` (T, B,
    3) and ``t`` (T,)."""
    env = _one_env(task, device)
    if policy_path:
        from wiki_grx_gym_tpu_torch.utils.helpers import load_policy_npz

        policy = load_policy_npz(policy_path)
    else:
        policy = lambda obs: np.zeros((obs.shape[0], env.num_actions), np.float32)
    state = env.init_state(env.make_generator(0))
    state, out = env.step(state, torch.zeros((1, env.num_actions), device=env.device))
    cmd = torch.tensor([command], dtype=torch.float32, device=env.device)
    fb = list(env.feet_bodies)
    cols = slice(env.obs_dim + 4, env.obs_dim + 4 + env.num_feet)
    log = {k: [] for k in ("base", "q", "tau", "contact", "bodies")}
    for _ in range(steps):
        state = state.replace(commands=cmd.expand_as(state.commands).clone())
        a = policy(out.obs.cpu().numpy())
        state, out = env.step(state, torch.as_tensor(a, dtype=torch.float32, device=env.device))
        ph = state.physics
        kin = forward_kinematics(env.model, ph.base_quat[0], ph.base_ang_vel[0], ph.base_lin_vel[0],
                                 ph.q[0], ph.qd[0])
        for key, t in (("base", ph.base_pos[0]), ("q", ph.q[0]), ("tau", state.torques[0]),
                       ("contact", out.pri_obs[0, cols]), ("bodies", ph.base_pos[0] + kin.pos_rel)):
            log[key].append(t)
    series = {k: torch.stack(v).cpu().numpy() for k, v in log.items()}
    series["feet"] = series["bodies"][:, fb]
    series["t"] = np.arange(steps) * env.dt
    return env, series


def render_rollout(env, s, out: str) -> None:
    """Draw :func:`rollout`'s series as the 2 x 3 figure at ``out``."""
    plt = _pyplot()
    base, feet, t, contact = s["base"], s["feet"], s["t"], s["contact"]
    fig, axs = plt.subplots(2, 3, figsize=(16, 9))
    axs[0, 0].plot(base[:, 0], base[:, 2], label="base")
    for f in range(feet.shape[1]):
        axs[0, 0].plot(feet[:, f, 0], feet[:, f, 2], lw=0.8, label=f"foot {f}")
    axs[0, 0].set(title="Side view (x-z)", xlabel="x [m]", ylabel="z [m]")
    axs[0, 0].legend(fontsize="x-small")

    axs[0, 1].plot(base[:, 0], base[:, 1])
    axs[0, 1].set(title="Top view (x-y)", xlabel="x [m]", ylabel="y [m]")
    axs[0, 1].axis("equal")

    for f in range(feet.shape[1]):
        axs[0, 2].plot(t, feet[:, f, 2], label=f"foot {f}")
        axs[0, 2].fill_between(t, 0, 0.02, where=contact[:, f] > 0.5, alpha=0.25)
    axs[0, 2].set(title="Feet height + contact", xlabel="t [s]", ylabel="z [m]")
    axs[0, 2].legend(fontsize="x-small")

    axs[1, 0].plot(t, s["q"])
    axs[1, 0].set(title="Joint positions", xlabel="t [s]", ylabel="rad")
    axs[1, 1].plot(t, s["tau"])
    axs[1, 1].set(title="Joint torques", xlabel="t [s]", ylabel="Nm")

    # stick-figure strip: the bodies at regular intervals
    ax = axs[1, 2]
    bodies = s["bodies"]
    for k in np.linspace(0, len(bodies) - 1, 8).astype(int):
        pts = bodies[k]
        ax.scatter(pts[:, 0], pts[:, 2], s=6)
        for i in range(1, env.model.num_bodies):
            p = env.model.parent[i]
            ax.plot([pts[p, 0], pts[i, 0]], [pts[p, 2], pts[i, 2]], "k-", lw=0.6, alpha=0.6)
    ax.set(title="Pose strip (x-z)", xlabel="x [m]", ylabel="z [m]")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"saved {out}; walked {base[-1, 0] - base[0, 0]:.2f} m in {t[-1]:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="GR1T1")
    ap.add_argument("--policy", default=None, help=".npz actor export; zero actions if omitted")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="trajectory.png")
    ap.add_argument("--command", type=float, nargs=3, default=[0.5, 0.0, 0.0])
    ap.add_argument("--replay", default=None,
                    help="a play --record traj.npz: render an animated 3D skeleton GIF instead of "
                         "the trajectory panels")
    ap.add_argument("--frames", type=int, default=120, help="max GIF frames for --replay")
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' runs the plain lane program")
    args = ap.parse_args(argv)
    if args.replay:
        out = "replay.gif" if args.out == "trajectory.png" else args.out
        return render_replay(*replay_frames(args.replay, args.device, args.frames), out=out)
    env, series = rollout(args.task, args.policy, args.steps, tuple(args.command), args.device)
    render_rollout(env, series, args.out)


if __name__ == "__main__":
    main()
