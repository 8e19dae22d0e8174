"""Port parity for the slice's env: the JAX env with ``use_pallas="lanes"``
(the folded decimation program as plain XLA) against the port's env on the
CPU, at the GR1T1 training config (decimation 10, its own spawn pose), 4
envs, both started from the same converted JAX ``EnvState``, stepped 4
policy steps with the same actions and the same per-step uniform block U
(rebuilt on the test side from the JAX state's key, exactly as
``LeggedEnv.step`` draws it). Noise, delay, command resampling, resets and
pushes stay on; the feet reach the ground from the second step on.

Tolerances: rtol 1e-4, atol 1e-5 (tests/test_golden.py:26-31), episode
counters and booleans exact. Ten stiff substeps per policy step amplify the
last-bit rounding differences of XLA and PyTorch (see
tests/test_torch_decimation.py) to ~1e-4 rad/s in joint velocity, as much as
each float32 program differs from float64. So, as in
tests/test_torch_decimation.py, every float comparison is widened by 3x the
port's own float32 noise floor at that step: the largest difference, over
the compared field, between the port stepped in float32 and the port
stepped in float64 from the same state with the same actions and U
(:func:`assert_close_widened`). A porting fault moves an output by far
more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry

N, STEPS = 4, 4
PHYS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")
RAND = ("friction", "restitution", "base_mass_scale", "base_com_offset")
RTOL, ATOL = 1e-4, 1e-5


def jax_state_to_numpy(s):
    """A JAX EnvState as the nested numpy dict ``env_state_from_numpy`` takes."""
    d = {k: np.asarray(getattr(s, k)) for k in (
        "episode_length", "common_step", "commands", "actions", "last_actions",
        "last_last_actions", "last_dof_vel", "torques", "feet_air_time", "feet_land_time",
        "feet_contact_last", "episode_sums", "motor_strength", "env_origins",
        "terrain_levels", "terrain_types", "cmd_lin_vel_x_range")}
    d["physics"] = {k: np.asarray(getattr(s.physics, k)) for k in PHYS}
    d["rand"] = {k: np.asarray(getattr(s.rand, k)) for k in RAND}
    return d


def as_float64(d):
    """The nested numpy dict with every float32 array cast to float64."""
    if isinstance(d, dict):
        return {k: as_float64(v) for k, v in d.items()}
    return d.astype(np.float64) if d.dtype == np.float32 else d


def step_block(jenv, state):
    """The (n, K) uniform block JAX ``LeggedEnv.step`` draws from ``state.rng``."""
    _, k_block = jax.random.split(state.rng)
    return np.asarray(jax.random.uniform(k_block, (jenv.num_envs, jenv._step_u_cols[1])))


def assert_close_widened(got, want, got64, rtol=RTOL, atol=ATOL, err_msg=""):
    """|got - want| <= atol + rtol |want| + 3 floor, element-wise, where
    floor = max |got - got64| is the port's float32 noise floor on this
    field (tests/test_torch_decimation.py:check_group)."""
    got, want, got64 = (np.asarray(x, np.float64) for x in (got, want, got64))
    assert got.shape == want.shape == got64.shape, err_msg
    floor = float(np.max(np.abs(got - got64)))
    err = np.abs(got - want)
    over = err > atol + rtol * np.abs(want) + 3.0 * floor
    assert not over.any(), (
        f"{err_msg}: {int(over.sum())} elements over the bound; max |port - jax| "
        f"{err.max():.3e}, float32 noise floor {floor:.3e}")


def make_envs(num_envs=N):
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = num_envs
    jc.sim.use_pallas = "lanes"
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = num_envs
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    assert jenv.decimation == tenv.decimation == 10
    return jenv, tenv


@pytest.fixture(scope="module")
def trajectories():
    """[(JAX state, JAX out)], [(port state, port out)], [(port float64
    state, port float64 out)] after each of the STEPS steps."""
    jenv, tenv = make_envs()
    assert jenv._post_fold
    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    ts = env_state_from_numpy(jax_state_to_numpy(js))
    ts64 = env_state_from_numpy(as_float64(jax_state_to_numpy(js)))
    rng = np.random.RandomState(0)
    step = jax.jit(jenv.step)
    jout, tout, tout64 = [], [], []
    for _ in range(STEPS):
        a = (rng.randn(N, jenv.num_actions) * 0.5).astype(np.float32)
        u = step_block(jenv, js)
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
        ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
        jout.append((jax_state_to_numpy(js), jax.device_get(jo)))
        tout.append((ts, to))
        tout64.append((ts64, to64))
    return jout, tout, tout64


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("field", ["obs", "pri_obs", "rew"])
def test_outputs_match(trajectories, t, field):
    (_, jo), (_, to), (_, to64) = (tr[t] for tr in trajectories)
    assert getattr(to64, field).dtype == torch.float64
    assert_close_widened(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                         getattr(to64, field).numpy(), err_msg=f"{field} step {t}")


@pytest.mark.parametrize("t", range(STEPS))
def test_resets_match(trajectories, t):
    (_, jo), (_, to) = trajectories[0][t], trajectories[1][t]
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.extras["time_outs"].numpy(), np.asarray(jo.extras["time_outs"]))


@pytest.mark.parametrize("field", [
    "feet_air_time", "feet_land_time", "episode_sums", "commands", "actions", "last_actions",
    "last_dof_vel", "torques", "feet_contact_last", "episode_length", "common_step",
])
def test_env_state_matches(trajectories, field):
    for t in range(STEPS):
        js, ts, ts64 = (tr[t][0] for tr in trajectories)
        got, want = getattr(ts, field).numpy(), js[field]
        if got.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(got, want, err_msg=f"{field} step {t}")
        else:
            assert_close_widened(got, want, getattr(ts64, field).numpy(),
                                 err_msg=f"{field} step {t}")


@pytest.mark.parametrize("field", PHYS)
def test_physics_state_matches(trajectories, field):
    for t in range(STEPS):
        js, ts, ts64 = (tr[t][0] for tr in trajectories)
        assert_close_widened(getattr(ts.physics, field).numpy(), js["physics"][field],
                             getattr(ts64.physics, field).numpy(), err_msg=f"{field} step {t}")


def test_trajectory_exercises_contacts(trajectories):
    """The compared steps include feet on the ground and pushes/resets stay
    wired (the U block is consumed on both sides)."""
    contact = sum(float(to.pri_obs[:, 43:45].sum()) for _, to in trajectories[1])
    assert contact > 0   # pri_obs 43:45 = feet_contact (after obs 39, blv 3, bho 1)
    assert all(torch.isfinite(to.obs).all() for _, to in trajectories[1])


def test_reset_steps_zero_actions(trajectories):
    """``reset`` resets every env and steps zero actions (BaseTask.reset)."""
    _, tenv = make_envs()
    ts = trajectories[1][-1][0]
    ts, out = tenv.reset(ts)
    assert out.obs.shape == (N, 39) and out.pri_obs.shape == (N, 168)
    assert torch.isfinite(out.obs).all() and torch.isfinite(out.rew).all()
    assert (ts.episode_length == 1).all() and (ts.actions == 0).all()
