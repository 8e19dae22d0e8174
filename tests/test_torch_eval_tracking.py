"""The port's ``tools/eval_tracking.track`` against JAX's command-tracking
loop (``tools/eval_tracking.py:66-91``, written out here with JAX calls).

The JAX env (``use_pallas="lanes"``, the folded decimation program as plain
XLA) and the port's env at GR1T1's evaluation config (noise, domain
randomization and pushes off, commands pinned, no heading command) at 4
envs start from the same converted JAX state and run the same actor (JAX
params placed in the port's net) through the six commands, each for a
transient of 2 and a window of 3 policy steps. The JAX loop resets all envs
before each command (``LeggedEnv.reset``: the reset block drawn from a key
split off the state's, then one zero-action step), writes the command into
the state before each step and keeps the uniform blocks it drew. The port's
env is given the same reset and step blocks, as tests/test_torch_env.py
does. Both configs shorten the episode to 3 policy steps, so every env
times out at the window's first step: survival is 0 in both, and the
window's last two steps measure envs just respawned, which the command
written before each step reaches (the reset resamples it).

Each row's label and target must be equal, survival exactly equal, and
``measured`` within tests/test_torch_env.py's tolerance (rtol 1e-4, atol
1e-5) plus 3x the port's float32 noise floor on it (``track`` run again in
float64 from the same state and draws).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu_torch.convert import actor_critic_from_numpy, env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.tools import eval_tracking

from test_torch_env import as_float64, assert_close_widened, jax_state_to_numpy, step_block

N, TRANSIENT, WINDOW = 4, 2, 3
EPISODE_S = 0.06   # 3 policy steps of 0.02 s: the timeout falls at the window's first step
RTOL, ATOL = 1e-4, 1e-5


def jax_eval_config():
    """JAX eval_tracking's overrides (``tools/eval_tracking.py:44-55``), written out."""
    cfg, _ = jax_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    cfg.env.episode_length_s = EPISODE_S
    cfg.noise.add_noise = False
    cfg.commands.resampling_command_interval_s = 1.0e6
    cfg.commands.heading_command = False
    dr = cfg.domain_rand
    dr.randomize_friction = dr.randomize_restitution = False
    dr.randomize_base_mass = dr.randomize_base_com = False
    dr.randomize_motor_strength = dr.push_robots = False
    dr.randomize_init_dof_pos = dr.randomize_init_base_velocity = False
    cfg.sim.use_pallas = "lanes"
    return cfg


class InjectedDraws:
    """The port's env with each reset's and each step's uniform block taken
    in turn from the JAX loop's draws. ``reset`` is ``LeggedEnv.reset`` with
    the reset block given."""

    def __init__(self, env, resets, blocks, dtype):
        self._env, self._resets, self._blocks, self._dtype = env, iter(resets), iter(blocks), dtype

    def __getattr__(self, name):
        return getattr(self._env, name)

    def reset(self, state):
        env = self._env
        done = torch.ones(env.num_envs, dtype=torch.bool)
        u = torch.from_numpy(next(self._resets)).to(self._dtype)
        state = env._refresh_ground_plane(env._reset_where(state, done, u=u), done, force=True)
        return self.step(state, torch.zeros((env.num_envs, env.num_actions), dtype=self._dtype))

    def step(self, state, actions):
        return self._env.step(state, actions, u=torch.from_numpy(next(self._blocks)).to(self._dtype))

    # track() steps through step_graph, which on the CPU is the eager step
    step_graph = step


@pytest.fixture(scope="module")
def rows():
    """JAX's rows, the port's rows in float32 and in float64."""
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jax_eval_config())
    tcfg, train_cfg = eval_tracking.evaluation_config("GR1T1", N)
    tcfg.env.episode_length_s = EPISODE_S
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tcfg, device="cpu")
    assert jenv.max_episode_length == tenv.max_episode_length == 3

    jnet = JaxActorCritic(39, 168, 10, train_cfg.policy)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7))
    tnet = actor_critic_from_numpy(ActorCritic(39, 168, 10, train_cfg.policy),
                                   jax.tree.map(np.asarray, params))
    tnet64 = copy.deepcopy(tnet).double()
    policy = jax.jit(lambda o: jnet.act_inference(params, o))

    step = jax.jit(jenv.step)
    done = jnp.ones(N, bool)
    reset_where = jax.jit(lambda s, k: jenv._refresh_ground_plane(
        jenv._reset_where(s, done, key=k), done, force=True))
    start, _ = step(jax.jit(jenv.init_state)(jax.random.PRNGKey(1)), jnp.zeros((N, 10)))

    # JAX's loop (tools/eval_tracking.py:66-91) over the jitted step, its draws kept
    want, resets, blocks = [], [], []
    for label, vx, vy, wz, idx in eval_tracking.COMMANDS:
        key, k_reset = jax.random.split(start.rng)   # LeggedEnv.reset
        resets.append(np.asarray(jax.random.uniform(k_reset, (N, jenv._reset_u_width))))
        env_state = reset_where(start.replace(rng=key), k_reset)
        blocks.append(step_block(jenv, env_state))
        env_state, out = step(env_state, jnp.zeros((N, 10)))
        obs = out.obs
        cmd = jnp.broadcast_to(jnp.asarray([vx, vy, wz]), (N, 3))
        meas, alive_mask = [], jnp.ones(N, bool)
        for t in range(TRANSIENT + WINDOW):
            env_state = env_state.replace(commands=cmd)
            actions = policy(obs)
            blocks.append(step_block(jenv, env_state))
            env_state, out = step(env_state, actions)
            obs = out.obs
            alive_mask = alive_mask & ~out.reset
            if t >= TRANSIENT:
                v = jnp.concatenate([out.extras["base_lin_vel"][:, :2], out.extras["base_ang_vel"][:, 2:3]], axis=1)
                meas.append(v[:, idx])
        measured = float(jnp.mean(jnp.stack(meas)))
        survival = float(jnp.mean(alive_mask.astype(jnp.float32)))
        target = (vx, vy, wz)[idx]
        track = measured / target * 100.0 if abs(target) > 1e-6 else float("nan")
        want.append((label, target, measured, track, survival))

    got = []
    state = jax_state_to_numpy(start)
    for net, conv, dtype in ((tnet, lambda d: d, torch.float32), (tnet64, as_float64, torch.float64)):
        env = InjectedDraws(tenv, resets, blocks, dtype)
        got.append(eval_tracking.track(env, net.act_inference, env_state_from_numpy(conv(state)),
                                       TRANSIENT, WINDOW))
    return want, got[0], got[1]


def test_rows_match_jax(rows):
    want, got, got64 = rows
    assert len(got) == len(want) == 6
    for (label, target, measured, track, survival), g, g64 in zip(want, got, got64):
        assert g[:2] == (label, target), label
        assert g[4] == survival == 0.0, label   # every env timed out inside the window
        assert_close_widened(g[2], measured, g64[2], rtol=RTOL, atol=ATOL, err_msg=label)
        if abs(target) > 1e-6:
            assert_close_widened(g[3], track, g64[3], rtol=RTOL, atol=ATOL * 100.0 / abs(target), err_msg=label)
        else:
            assert np.isnan(g[3]) and np.isnan(track), label


def test_commands_move_the_robot_apart(rows):
    """The six rows are not one number: the pinned command reaches the
    policy's observation, so the measured velocities differ."""
    want, got, _ = rows
    assert len({round(r[2], 6) for r in want}) == 6
    assert len({round(r[2], 6) for r in got}) == 6
