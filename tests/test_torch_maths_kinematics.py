"""Port parity: quaternion maths, forward kinematics and the env's static
contact tables (self-collision pairs, feet/termination groups, post-FK
bodies). Same inputs, made with numpy from a seed, through both packages;
rtol 1e-5, atol 1e-6 for the float functions, exact for the tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim.kinematics import forward_kinematics as jax_fk
from wiki_grx_gym_tpu.utils import maths as jm
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.models.serialize import RESOURCES, load_robot
from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics as torch_fk
from wiki_grx_gym_tpu_torch.utils import maths as tm

TOL = dict(rtol=1e-5, atol=1e-6)


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_apply", "quat_rotate_inverse", "quat_conjugate",
    "quat_from_angle_axis", "quat_from_euler_xyz", "get_euler_xyz", "quat_apply_yaw",
    "wrap_to_pi", "quat_to_rotmat", "quat_integrate", "normalize",
])
def test_maths_matches_jax(name):
    rng = np.random.RandomState(0)
    n = 64
    qa, qb = _quats(rng, n), _quats(rng, n)
    v = rng.randn(n, 3).astype(np.float32)
    ang = (rng.randn(n) * 3).astype(np.float32)
    args = {
        "quat_mul": (qa, qb), "quat_apply": (qa, v), "quat_rotate_inverse": (qa, v),
        "quat_conjugate": (qa,), "quat_from_angle_axis": (ang, v),
        "quat_from_euler_xyz": (ang, ang[::-1].copy(), 0.5 * ang),
        "get_euler_xyz": (qa,), "quat_apply_yaw": (qa, v), "wrap_to_pi": (4 * ang,),
        "quat_to_rotmat": (qa,), "quat_integrate": (qa, v, 0.01), "normalize": (v,),
    }[name]
    j = getattr(jm, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    t = getattr(tm, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    if isinstance(j, tuple):
        for a, b in zip(j, t):
            _close(a, b)
    else:
        _close(j, t)


def test_sample_distribution_ranges():
    g = torch.Generator().manual_seed(0)
    u = tm.sample_distribution(g, (0.9, 1.1), (4096,), "uniform")
    assert u.dtype == torch.float32 and 0.9 <= u.min() and u.max() < 1.1
    lu = tm.sample_distribution(g, (0.5, 2.0), (4096,), "loguniform")
    assert 0.5 <= lu.min() and lu.max() < 2.0
    ga = tm.sample_distribution(g, (1.0, 0.04), (20000,), "gaussian")
    assert abs(float(ga.mean()) - 1.0) < 0.01 and abs(float(ga.std()) - 0.2) < 0.01
    with pytest.raises(ValueError):
        tm.sample_distribution(g, (0.0, 1.0), (4,), "cauchy")


@pytest.mark.parametrize("spec", ["gr1t1_lower_limb", "gr1t1"])
def test_forward_kinematics_matches_jax(spec):
    from wiki_grx_gym_tpu.models.serialize import load_robot as jax_load

    tmod = load_robot(f"{RESOURCES}/{spec}.json")
    jmod = jax_load(f"{RESOURCES}/{spec}.json")
    rng = np.random.RandomState(1)
    n, d = 16, tmod.num_dof
    quat = _quats(rng, n)
    w, vlin = rng.randn(n, 3).astype(np.float32), rng.randn(n, 3).astype(np.float32)
    q, qd = (rng.randn(n, d) * 0.5).astype(np.float32), rng.randn(n, d).astype(np.float32)
    jk = jax.vmap(jax_fk, in_axes=(None, 0, 0, 0, 0, 0))(
        jmod, *(jnp.asarray(a) for a in (quat, w, vlin, q, qd)))
    tk = torch_fk(tmod, *(torch.from_numpy(a) for a in (quat, w, vlin, q, qd)))
    for f in ("quat", "pos_rel", "axis_w", "subspace", "twist"):
        np.testing.assert_allclose(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def envs():
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = 4
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = 4
    je, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    te, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    return je, te


@pytest.mark.parametrize("attr", [
    "self_pairs", "feet_point_groups", "termination_groups", "penalized_groups",
    "post_fk_bodies", "feet_bodies", "reward_names", "all_reward_names", "knee_dofs",
    "ankle_dofs", "termination_links",
])
def test_env_tables_equal(envs, attr):
    je, te = envs
    assert getattr(te, attr) == getattr(je, attr)


def test_self_pairs_are_the_64_cross_limb_pairs(envs):
    je, te = envs
    assert len(te.self_pairs[0]) == 64
    assert te.self_pairs == je.self_pairs


@pytest.mark.parametrize("attr", [
    "default_dof_pos", "p_gains", "d_gains", "torque_limits", "dof_vel_limits",
    "dof_pos_soft_lower", "dof_pos_soft_upper", "clip_actions_min", "clip_actions_max",
    "feet_offsets", "noise_scale_vec", "commands_scale",
])
def test_env_constants_equal(envs, attr):
    je, te = envs
    np.testing.assert_array_equal(np.asarray(getattr(te, attr)), np.asarray(getattr(je, attr)))


def test_env_scalars_equal(envs):
    je, te = envs
    for attr in ("num_envs", "num_dof", "decimation", "sim_dt", "dt", "max_episode_length",
                 "resample_interval", "push_interval", "obs_dim", "pri_obs_dim",
                 "num_height_points", "termination_scale"):
        assert getattr(te, attr) == getattr(je, attr), attr
    assert te.reward_scales == je.reward_scales
    assert te._step_u_cols == je._step_u_cols
    assert te.torso_frame[0] == je.torso_frame[0]
    np.testing.assert_array_equal(te.torso_frame[1], np.asarray(je.torso_frame[1]))
    np.testing.assert_array_equal(te._origins_np, je._origins_np)
