"""Port parity for the reward library: each of the 51 terms of
``wiki_grx_gym_tpu/envs/rewards.py:REWARDS`` against the port's
``envs/rewards.py`` on one random ``RewardContext`` of 64 envs (the same
numpy values on both sides), with the GR1T1 env's constants (sigmas,
targets, soft limits, the knee, hip and ankle dof groups).

The context holds values on both sides of every threshold (commands near
the 0.1 snap, feet heights around the swing targets, air and land times
around theirs, dofs beyond the soft limits, forces below and above the
stumble ratio). Tolerance rtol 1e-5, atol 1e-6: the terms are a few
float32 operations each, sums over at most 10 dofs taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import rewards as jax_rewards
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu_torch.envs import rewards
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry

N = 64


@pytest.fixture(scope="module")
def case():
    jenv, _ = jax_registry.make_env("GR1T1")
    tenv, _ = torch_registry.make_env("GR1T1", device="cpu")
    rng = np.random.RandomState(0)
    f = lambda *shape, lo=-1.0, hi=1.0: rng.uniform(lo, hi, shape).astype(np.float32)
    d, nf = tenv.num_dof, tenv.num_feet
    soft_lo, soft_hi = tenv.dof_pos_soft_lower, tenv.dof_pos_soft_upper
    ctx = dict(
        commands=f(N, 3, lo=-0.15, hi=0.15) * rng.choice([1.0, 6.0], (N, 1)).astype(np.float32),
        base_lin_vel=f(N, 3), base_ang_vel=f(N, 3), base_projected_gravity=f(N, 3),
        base_heights_offset=f(N, lo=-0.5, hi=0.5), base_height=f(N, lo=0.5, hi=1.2),
        torso_projected_gravity=f(N, 3), forehead_projected_gravity=f(N, 3),
        dof_pos=(soft_lo + (soft_hi - soft_lo) * f(N, d, lo=-0.2, hi=1.2)).astype(np.float32),
        dof_vel=f(N, d, lo=-25.0, hi=25.0), dof_acc=f(N, d, lo=-500.0, hi=500.0),
        torques=f(N, d, lo=-400.0, hi=400.0), actions=f(N, d), last_actions=f(N, d),
        last_last_actions=f(N, d), feet_contact=rng.rand(N, nf) > 0.5,
        feet_first_contact=(rng.rand(N, nf) > 0.5).astype(np.float32),
        feet_air_time=f(N, nf, lo=0.0, hi=1.0), feet_land_time=f(N, nf, lo=0.0, hi=2.0),
        feet_height=f(N, nf, lo=-0.05, hi=0.3), feet_contact_force=f(N, nf, 3, lo=-600.0, hi=600.0),
        avg_feet_contact_force=f(N, nf, lo=0.0, hi=800.0), avg_feet_speed_xyz=f(N, nf, 3, lo=0.0, hi=2.0),
        penalized_contact_count=rng.randint(0, 3, N).astype(np.float32),
        reset_buf=rng.rand(N) > 0.7, time_out_buf=rng.rand(N) > 0.7,
    )
    jctx = jax_rewards.RewardContext(**{k: jnp.asarray(v) for k, v in ctx.items()})
    tctx = rewards.RewardContext(**{k: torch.from_numpy(v) for k, v in ctx.items()})
    return jenv, tenv, jctx, tctx


def test_registry_has_every_term():
    assert list(rewards.REWARDS) == list(jax_rewards.REWARDS) and len(rewards.REWARDS) == 51


@pytest.mark.parametrize("name", list(jax_rewards.REWARDS))
def test_term_matches(case, name):
    jenv, tenv, jctx, tctx = case
    want = np.asarray(jax_rewards.REWARDS[name](jenv, jctx), np.float64)
    got = rewards.REWARDS[name](tenv, tctx).to(torch.float64).numpy()
    assert got.shape == want.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
