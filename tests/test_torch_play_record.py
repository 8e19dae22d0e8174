"""The port's play loop and ``--record`` against the JAX package's play
(``wiki_grx_gym_tpu/scripts/play.py:87-134``, written out here with JAX
calls).

- The loop: the JAX env (``use_pallas="lanes"``, the folded decimation
  program as plain XLA) and the port's env at the GR1T1 config with play's
  overrides (noise, domain randomization and pushes off) at 4 envs, the
  logged robot set to env 2 (``viewer.ref_env``), start from the same
  converted JAX state and run the same actor (JAX params placed in the
  port's net) for 5 policy steps. Each step's uniform block U is rebuilt
  from the JAX state's key and injected into the port's env, as
  tests/test_torch_env.py does. Two envs, the logged one among them,
  start near the episode's end and time out inside the 5 steps, so the
  stored rewards (the reward times the episodes ended that step) are
  compared where they are not zero. The recorded ``base_pos``, ``base_quat``
  and ``q``, every logged channel, the stored rewards and the episode
  count must agree within tests/test_torch_env.py's tolerance (rtol 1e-4,
  atol 1e-5) plus 3x the port's float32 noise floor on each (the port's
  loop run again in float64 from the same state and draws).
- ``play --record`` on the CPU from a saved port checkpoint writes
  ``traj.npz`` with JAX's keys, shapes and dtypes, beside the exports
  (``policy.npz``, ``policy.grxpolicy``) and the dashboard.
- Replay: ``tools/visualize.replay_frames`` of that file against JAX's
  ``forward_kinematics`` over the same poses, within 1e-5 m.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.sim.kinematics import forward_kinematics as jax_fk
from wiki_grx_gym_tpu.utils.logger import EvalLogger as JaxEvalLogger
from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.convert import actor_critic_from_numpy, env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.scripts.play import no_randomization, play, play_loop
from wiki_grx_gym_tpu_torch.tools.visualize import replay_frames
from wiki_grx_gym_tpu_torch.utils.helpers import get_args

from test_torch_env import as_float64, assert_close_widened, jax_state_to_numpy, step_block

N, STEPS, ROBOT = 4, 5, 2
RTOL, ATOL = 1e-4, 1e-5
FRAME_TOL = 1e-5
TRAJ = {"base_pos": (3,), "base_quat": (4,), "q": (10,)}


def jax_play_config():
    """JAX play's overrides (``scripts/play.py:46-56``), written out."""
    cfg, _ = jax_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    cfg.terrain.num_rows = cfg.terrain.num_cols = 5
    cfg.terrain.curriculum = False
    cfg.noise.add_noise = False
    dr = cfg.domain_rand
    dr.randomize_friction = dr.randomize_restitution = False
    dr.randomize_base_mass = dr.randomize_base_com = False
    dr.randomize_motor_strength = dr.push_robots = False
    dr.randomize_init_dof_pos = dr.randomize_init_base_velocity = False
    cfg.viewer.ref_env = ROBOT
    cfg.sim.use_pallas = "lanes"
    return cfg


class InjectedDraws:
    """The port's env with each step's U block taken from ``blocks`` in turn."""

    def __init__(self, env, blocks, dtype):
        self._env, self._blocks, self._dtype = env, iter(blocks), dtype

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, actions):
        return self._env.step(state, actions, u=torch.from_numpy(next(self._blocks)).to(self._dtype))

    # play steps through step_graph, which on the CPU is the eager step
    step_graph = step


@pytest.fixture(scope="module")
def loops():
    """(JAX logger, JAX trajectory), (port logger, port trajectory), and the
    port's float64 run."""
    jcfg = jax_play_config()
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jcfg)
    tcfg, train_cfg = torch_registry.get_cfgs("GR1T1")
    tcfg.env.num_envs = N
    tcfg.terrain.num_rows = tcfg.terrain.num_cols = 5
    tcfg.terrain.curriculum = False
    no_randomization(tcfg)
    tcfg.viewer.ref_env = ROBOT
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tcfg, device="cpu")

    jnet = JaxActorCritic(39, 168, 10, train_cfg.policy)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(5))
    tnet = actor_critic_from_numpy(ActorCritic(39, 168, 10, train_cfg.policy),
                                   jax.tree.map(np.asarray, params))
    tnet64 = copy.deepcopy(tnet).double()
    jpolicy = jax.jit(lambda o: jnet.act_inference(params, o))

    step = jax.jit(jenv.step)
    js, jo = step(jax.jit(jenv.init_state)(jax.random.PRNGKey(0)), jnp.zeros((N, 10)))
    # planted timeouts: env 1 ends its episode at step 2, the logged env 2 at step 4
    m = jenv.max_episode_length
    js = js.replace(episode_length=js.episode_length.at[1].set(m - 1).at[2].set(m - 3))
    start = jax_state_to_numpy(js)
    obs0 = np.asarray(jo.obs)

    # JAX play's loop (play.py:87-117) over the jitted step, its U blocks kept
    logger = JaxEvalLogger(jenv.dt)
    knees = [i for i, nm in enumerate(jenv.model.dof_names) if "knee" in nm]
    joint = knees[0] if knees else min(1, jenv.num_dof - 1)
    r = min(int(jcfg.viewer.ref_env), N - 1)
    traj = {k: [] for k in TRAJ}
    blocks, obs = [], jnp.asarray(obs0)
    for _ in range(STEPS):
        actions = jpolicy(obs)
        blocks.append(step_block(jenv, js))
        js, out = step(js, actions)
        obs = out.obs
        for k in TRAJ:
            traj[k].append(np.asarray(getattr(js.physics, k)[r]))
        logger.log_states({
            "dof_pos_target": float(actions[r, joint]) * jenv.cfg.control.action_scale,
            "dof_pos": float(js.physics.q[r, joint]),
            "dof_vel": float(js.physics.qd[r, joint]),
            "dof_torque": float(js.torques[r, joint]),
            "command_x": float(js.commands[r, 0]),
            "command_y": float(js.commands[r, 1]),
            "command_yaw": float(js.commands[r, 2]),
            "base_vel_x": float(out.extras["base_lin_vel"][r, 0]),
            "base_vel_y": float(out.extras["base_lin_vel"][r, 1]),
            "base_vel_z": float(out.extras["base_lin_vel"][r, 2]),
            "base_vel_yaw": float(out.extras["base_ang_vel"][r, 2]),
            "contact_forces_z": np.asarray(out.extras["feet_contact_force"][r, :, 2]),
        })
        logger.log_rewards({"rew_total": float(out.rew[r])}, int(out.reset.sum()))
    want = (logger, {k: np.stack(v) for k, v in traj.items()})

    runs = []
    for net, conv, dtype in ((tnet, lambda d: d, torch.float32), (tnet64, as_float64, torch.float64)):
        env = InjectedDraws(tenv, blocks, dtype)
        with torch.no_grad():
            runs.append(play_loop(env, net.act_inference, env_state_from_numpy(conv(start)),
                                  torch.from_numpy(obs0).to(dtype), STEPS, record=True))
    return want, runs[0], runs[1]


def test_logged_channels_match(loops):
    (jlog, _), (tlog, _), (tlog64, _) = loops
    assert list(tlog.state_log) == list(jlog.state_log)
    for k, want in jlog.state_log.items():
        assert len(tlog.state_log[k]) == STEPS, k
        assert_close_widened(np.stack(tlog.state_log[k]), np.stack(want), np.stack(tlog64.state_log[k]),
                             rtol=RTOL, atol=ATOL, err_msg=k)
    forces = np.stack(tlog.state_log["contact_forces_z"])
    assert forces.dtype == np.float32 and forces.shape == (STEPS, 2)
    assert forces.max() > 0   # the feet land within the 5 steps: the channel is not empty


def test_rewards_and_episodes_match(loops):
    (jlog, _), (tlog, _), (tlog64, _) = loops
    assert jlog.num_episodes == 2 and tlog.num_episodes == jlog.num_episodes
    stored = np.asarray(jlog.rew_log["rew_total"])
    assert np.flatnonzero(stored).tolist() == [1, 3]   # the reward slot is compared where it is not zero
    assert list(tlog.rew_log) == list(jlog.rew_log) == ["rew_total"]
    assert_close_widened(np.asarray(tlog.rew_log["rew_total"]), np.asarray(jlog.rew_log["rew_total"]),
                         np.asarray(tlog64.rew_log["rew_total"]), rtol=RTOL, atol=ATOL, err_msg="rew_total")


@pytest.mark.parametrize("key", list(TRAJ))
def test_recorded_trajectory_matches(loops, key):
    (_, jtraj), (_, ttraj), (_, ttraj64) = loops
    got = ttraj[key]
    assert got.dtype == np.float32 and got.shape == (STEPS,) + TRAJ[key]
    assert_close_widened(got, jtraj[key], ttraj64[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_loop_without_record_returns_no_trajectory():
    """Only ``record`` keeps the poses (and the logger is filled either way)."""
    cfg, _ = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=no_randomization(cfg), device="cpu")
    st = tenv.init_state(tenv.make_generator(0))
    st, out = tenv.step(st, torch.zeros((2, 10)))
    logger, traj = play_loop(tenv, lambda o: torch.zeros((o.shape[0], 10)), st, out.obs, 2)
    assert traj is None and len(logger.state_log["dof_pos"]) == 2


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A port checkpoint (no training: the runner's initial params) saved
    under a log root, then ``play --record`` on the CPU from it."""
    root = str(tmp_path_factory.mktemp("logs"))
    cfg, train_cfg = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    env, _ = torch_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner, _ = torch_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=root)
    os.makedirs(runner.log_dir)
    runner.save(os.path.join(runner.log_dir, "model_0.pt"), runner.init_state())
    before = dict(LAUNCHES)
    logger = play(get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", str(N), "--record"]),
                  num_steps=STEPS, log_root=root)
    assert LAUNCHES == before   # CPU tensors launch no kernel
    return root, logger


def test_play_record_writes_jax_keys_and_dtypes(recorded):
    root, logger = recorded
    data = np.load(os.path.join(root, "traj.npz"), allow_pickle=False)
    assert sorted(data.files) == ["base_pos", "base_quat", "dt", "q", "task"]
    for k, shape in TRAJ.items():
        assert data[k].dtype == np.float32 and data[k].shape == (STEPS,) + shape, k
        assert np.isfinite(data[k]).all(), k
    assert data["dt"].dtype == np.float32 and data["dt"].shape == () and float(data["dt"]) == np.float32(0.02)
    assert data["task"].dtype.kind == "U" and str(data["task"]) == "GR1T1"
    # the last recorded q is the logged robot's at the last step
    assert np.float32(logger.state_log["dof_pos"][-1]) in data["q"][-1]
    for name in ("exported/policies/policy.npz", "exported/policies/policy.grxpolicy", "eval_plots.png"):
        assert os.path.isfile(os.path.join(root, name)), name


def test_replay_frames_match_jax_forward_kinematics(recorded):
    root, _ = recorded
    path = os.path.join(root, "traj.npz")
    frames, model, task, dt, stride = replay_frames(path, "cpu", max_frames=2)
    assert (task, stride) == ("GR1T1", 2) and frames.shape == (3, model.num_bodies, 3)
    data = np.load(path)
    jcfg, _ = jax_registry.get_cfgs("GR1T1")
    jcfg.env.num_envs = 1
    jmodel = jax_registry.make_env("GR1T1", env_cfg=jcfg)[0].model
    fk = jax.jit(lambda quat, q: jax_fk(jmodel, quat, jnp.zeros(3), jnp.zeros(3), q, jnp.zeros(10)).pos_rel)
    want = np.stack([data["base_pos"][k] + np.asarray(fk(data["base_quat"][k], data["q"][k]))
                     for k in range(0, STEPS, stride)])
    np.testing.assert_allclose(frames, want, rtol=0, atol=FRAME_TOL)
    assert np.ptp(frames[0][:, 2]) > 0.5   # a standing robot, head to feet
