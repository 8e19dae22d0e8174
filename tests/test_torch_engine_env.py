"""Port parity for the env on the engine path (``cfg.sim.use_pallas =
False``): the port's env against JAX's env with ``use_pallas=False`` (its
vmapped ``physics_step`` under ``lax.scan``), on the CPU, and the table of
the backend chooser (``envs/legged_env.physics_backend``).

GR1T1 at 4 envs and decimation 2, both envs from the same converted JAX
``EnvState``, 3 policy steps with the same actions and the same per-step
uniform block U (tests/test_torch_env.py's scheme), in four
configurations: the plane, heightfield and trimesh terrain (a 3 x 3
curriculum grid, ``refresh_interval`` 2: the measured heights refreshed at
steps 0 and 2 and carried at step 1) and the plane with heading commands.
Env 0 times out at step 0 and env 1 at step 1. On the engine path the post
stage runs outside the physics (no fold) and the ground is the terrain's
whole field (``Terrain.height_fn``, ``Terrain.ground_query``), so no ground
planes are carried.

Every robot starts lowered until its lowest contact sphere is 4 mm in the
ground, so the steps run the contact. The JAX step runs under jit (the
engine step compiles in ~8 s on the CPU). Tolerances are
tests/test_torch_env.py's: rtol 1e-4, atol 1e-5, widened by 3x the port's
float32 noise floor at that step (the port run in float64 from the same
state); counters, levels and booleans exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import PHYS, as_float64, assert_close_widened, step_block
from test_torch_terrain_env import state_to_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.envs.legged_env import physics_backend
from wiki_grx_gym_tpu_torch.sim import cuda_step

N, STEPS, DECIMATION = 4, 3, 2
CONFIGS = ("plane", "heightfield", "trimesh", "heading")


def configure(cfg, which, n=N):
    cfg.env.num_envs = n
    cfg.control.decimation = DECIMATION
    cfg.sim.use_pallas = False
    if which == "heading":
        cuda_step.heading_config(cfg)
    elif which != "plane":
        cuda_step.terrain_config(which, 3, 3)(cfg)
    return cfg


def make_envs(which):
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=configure(jc, which))
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=configure(tc, which), device="cpu")
    assert jenv._pallas_mode() is None and tenv.backend == "engine"
    assert not jenv._post_fold and not tenv._post_fold
    return jenv, tenv


@pytest.fixture(scope="module", params=CONFIGS)
def trajectories(request):
    """(config, [(JAX state, JAX out)], [(port state, port out)], [(port
    float64 state, port float64 out)]) after each of the STEPS steps."""
    which = request.param
    jenv, tenv = make_envs(which)
    rng = np.random.RandomState(0)
    jout, tout, tout64 = [], [], []
    if jenv.terrain is not None:
        jenv.terrain._block_pyramid   # host cache, made outside the trace
    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    ml = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray([ml, ml - 1, 3, 7], jnp.int32))
    # every robot lowered until its lowest contact sphere is 4 mm in the
    # ground, so that the three steps run the contact (from the spawn
    # height the feet land only after ~0.1 s)
    pos, r = cuda_step.point_positions(tenv, env_state_from_numpy(state_to_numpy(js)))
    gap = (pos[..., 2] - r - tenv.height_fn(pos[..., 0], pos[..., 1])).amin(dim=1)
    js = js.replace(physics=js.physics.replace(
        base_pos=js.physics.base_pos.at[:, 2].add(-jnp.asarray(gap.numpy()) - 0.004)))
    ts = env_state_from_numpy(state_to_numpy(js))
    ts64 = env_state_from_numpy(as_float64(state_to_numpy(js)))
    step = jax.jit(jenv.step)
    for _ in range(STEPS):
        a = (rng.randn(N, jenv.num_actions) * 0.5).astype(np.float32)
        u = np.array(step_block(jenv, js))
        js, jo = step(js, jnp.asarray(a))
        ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
        ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
        jout.append((state_to_numpy(js), jax.device_get(jo)))
        tout.append((ts, to))
        tout64.append((ts64, to64))
    return which, jout, tout, tout64


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("field", ["obs", "pri_obs", "rew"])
def test_outputs_match(trajectories, t, field):
    which, *tr = trajectories
    (_, jo), (_, to), (_, to64) = (x[t] for x in tr)
    assert getattr(to, field).shape == np.asarray(getattr(jo, field)).shape
    assert_close_widened(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                         getattr(to64, field).numpy(), err_msg=f"{which} {field} step {t}")


def test_resets_and_counters_match(trajectories):
    which, jout, tout, _ = trajectories
    for t in range(STEPS):
        (js, jo), (ts, to) = jout[t], tout[t]
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
        np.testing.assert_array_equal(to.extras["time_outs"].numpy(), np.asarray(jo.extras["time_outs"]))
        for k in ("terrain_levels", "terrain_types", "episode_length", "common_step"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), js[k], err_msg=f"{which} {k} step {t}")
    resets = [np.asarray(jo.reset) for _, jo in jout]
    assert resets[0][0] and resets[1][1]   # the planted timeouts


@pytest.mark.parametrize("field", [
    "feet_air_time", "feet_land_time", "episode_sums", "commands", "actions", "last_actions",
    "last_dof_vel", "torques", "feet_contact_last", "env_origins",
])
def test_env_state_matches(trajectories, field):
    which, jout, tout, tout64 = trajectories
    for t in range(STEPS):
        js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
        got, want = getattr(ts, field).numpy(), js[field]
        if got.dtype == np.bool_:
            np.testing.assert_array_equal(got, want, err_msg=f"{which} {field} step {t}")
        else:
            assert_close_widened(got, want, getattr(ts64, field).numpy(), err_msg=f"{which} {field} step {t}")


@pytest.mark.parametrize("field", PHYS)
def test_physics_state_matches(trajectories, field):
    which, jout, tout, tout64 = trajectories
    for t in range(STEPS):
        js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
        assert_close_widened(getattr(ts.physics, field).numpy(), js["physics"][field],
                             getattr(ts64.physics, field).numpy(), err_msg=f"{which} {field} step {t}")


def test_engine_path_carries_no_ground_planes(trajectories):
    """No ground planes on the engine path (the contact reads the terrain
    itself); the measured heights are refreshed and carried as on the
    kernel path, equal to JAX's; the feet touch the ground."""
    which, jout, tout, tout64 = trajectories
    assert all(ts.ground_plane is None for ts, _ in tout)
    assert all("ground_plane" not in js for js, _ in jout)
    if which in ("heightfield", "trimesh"):
        for t in range(STEPS):
            js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
            assert_close_widened(ts.measured_cache.numpy(), js["measured_cache"],
                                 ts64.measured_cache.numpy(), err_msg=f"{which} measured step {t}")
        assert torch.equal(tout[1][0].measured_cache, tout[0][0].measured_cache)
    contact = sum(float(to.pri_obs[:, 43:45].sum()) for _, to in tout)
    assert contact > 0   # pri_obs 43:45: feet_contact
    assert all(torch.isfinite(to.obs).all() and torch.isfinite(to.rew).all() for _, to in tout)


@pytest.mark.parametrize("value,device,want", [
    (False, "cpu", "engine"), ("off", "cpu", "engine"), (False, "cuda", "engine"), ("off", "cuda", "engine"),
    ("lanes", "cpu", "lanes"), ("interpret", "cpu", "lanes"), ("lanes", "cuda", "lanes"),
    ("interpret", "cuda", "lanes"), (True, "cuda", "kernel"), ("on", "cuda", "kernel"),
    ("auto", "cuda", "kernel"), ("auto", "cpu", "lanes"),
])
def test_backend_chooser(value, device, want):
    assert physics_backend(value, device) == want


@pytest.mark.parametrize("value", [True, "on"])
def test_kernel_backend_raises_on_the_cpu(value):
    with pytest.raises(ValueError, match="CUDA"):
        physics_backend(value, "cpu")
    cfg, _ = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    cfg.sim.use_pallas = value
    with pytest.raises(ValueError, match="CUDA"):
        torch_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")


@pytest.mark.parametrize("value", ["fast", "yes", 1, None])
def test_unknown_backend_raises(value):
    with pytest.raises(ValueError, match="use_pallas"):
        physics_backend(value, "cpu")


@pytest.mark.parametrize("value,fold", [(False, False), ("lanes", True), ("auto", True)])
def test_env_reads_use_pallas(value, fold):
    """The env reads the key once: the engine runs its post stage outside
    (no fold), the lane program folds it on the plane; the engine's ground
    is the plane's height function."""
    cfg, _ = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    cfg.sim.use_pallas = value
    env, _ = torch_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    assert env.backend == physics_backend(value, "cpu") and env._post_fold == fold
    assert env.ground_query is None and float(env.height_fn(torch.ones(3), torch.ones(3)).abs().sum()) == 0.0
    s = env.init_state(0)
    s, out = env.step(s, torch.zeros(2, env.num_actions))
    assert torch.isfinite(out.obs).all() and s.ground_plane is None
