"""Port parity for the full-body env: the JAX env with ``use_pallas="lanes"``
against the port's env on the CPU, ``GR1T1_full`` (32 dofs, obs 105, critic
obs 234), 4 envs, decimation 2, both started from the same converted JAX
``EnvState`` and stepped 2 policy steps with the same actions and the same
per-step uniform block U (tests/test_torch_env.py's scheme). Noise, delay,
command resampling, resets and pushes stay on.

The JAX side runs eagerly (``jax.disable_jit()``): XLA on the CPU takes more
than 30 minutes to compile the 32-DOF program. Tolerances are
tests/test_torch_env.py's: rtol 1e-4, atol 1e-5, widened by 3x the port's
float32 noise floor at that step (the port stepped in float64 from the same
state), episode counters and booleans exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import PHYS, as_float64, assert_close_widened, jax_state_to_numpy, step_block
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry

TASK = "GR1T1_full"
N, STEPS, DECIMATION = 4, 2, 2


@pytest.fixture(scope="module")
def trajectories():
    """[(JAX state, JAX out)], [(port state, port out)], [(port float64
    state, port float64 out)] after each of the STEPS steps."""
    jc, _ = jax_registry.get_cfgs(TASK)
    jc.env.num_envs = N
    jc.sim.use_pallas = "lanes"
    jc.control.decimation = DECIMATION
    tc, _ = torch_registry.get_cfgs(TASK)
    tc.env.num_envs = N
    tc.control.decimation = DECIMATION
    tenv, _ = torch_registry.make_env(TASK, env_cfg=tc, device="cpu")
    rng = np.random.RandomState(0)
    jout, tout, tout64 = [], [], []
    with jax.disable_jit():
        jenv, _ = jax_registry.make_env(TASK, env_cfg=jc)
        assert jenv._post_fold and jenv.num_dof == tenv.num_dof == 32
        js = jenv.init_state(jax.random.PRNGKey(0))
        ts = env_state_from_numpy(jax_state_to_numpy(js))
        ts64 = env_state_from_numpy(as_float64(jax_state_to_numpy(js)))
        for _ in range(STEPS):
            a = (rng.randn(N, jenv.num_actions) * 0.5).astype(np.float32)
            u = step_block(jenv, js)
            js, jo = jenv.step(js, jnp.asarray(a))
            ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
            ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
            jout.append((jax_state_to_numpy(js), jax.device_get(jo)))
            tout.append((ts, to))
            tout64.append((ts64, to64))
    return jout, tout, tout64


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("field", ["obs", "pri_obs", "rew"])
def test_full_body_outputs_match(trajectories, t, field):
    (_, jo), (_, to), (_, to64) = (tr[t] for tr in trajectories)
    assert getattr(to, field).shape == np.asarray(getattr(jo, field)).shape
    assert_close_widened(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                         getattr(to64, field).numpy(), err_msg=f"{field} step {t}")


@pytest.mark.parametrize("t", range(STEPS))
def test_full_body_resets_match(trajectories, t):
    (_, jo), (_, to) = trajectories[0][t], trajectories[1][t]
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    np.testing.assert_array_equal(to.extras["time_outs"].numpy(), np.asarray(jo.extras["time_outs"]))


@pytest.mark.parametrize("field", [
    "feet_air_time", "feet_land_time", "episode_sums", "commands", "actions", "last_actions",
    "last_dof_vel", "torques", "feet_contact_last", "episode_length", "common_step",
])
def test_full_body_env_state_matches(trajectories, field):
    for t in range(STEPS):
        js, ts, ts64 = (tr[t][0] for tr in trajectories)
        got, want = getattr(ts, field).numpy(), js[field]
        if got.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(got, want, err_msg=f"{field} step {t}")
        else:
            assert_close_widened(got, want, getattr(ts64, field).numpy(), err_msg=f"{field} step {t}")


@pytest.mark.parametrize("field", PHYS)
def test_full_body_physics_state_matches(trajectories, field):
    for t in range(STEPS):
        js, ts, ts64 = (tr[t][0] for tr in trajectories)
        assert_close_widened(getattr(ts.physics, field).numpy(), js["physics"][field],
                             getattr(ts64.physics, field).numpy(), err_msg=f"{field} step {t}")


def test_full_body_shapes(trajectories):
    _, to = trajectories[1][-1]
    assert to.obs.shape == (N, 105) and to.pri_obs.shape == (N, 234)
    assert torch.isfinite(to.obs).all() and torch.isfinite(to.rew).all()
