"""Port parity for the folded post stage's reward terms, term by term: the
port's ``LanePost._rw_<name>`` against the JAX ``LanePost._rw_<name>`` on
the same random lane context, for every one of the 50 lane-form terms, and
the penalized-contact count through ``LanePost.run``.

The config is GR1T1 with every term at a non-zero scale and contacts
penalized on the thighs and shanks (``cuda_step.all_terms_config``): both
``LanePost`` objects are built from it, so they hold the same sigmas,
limits, dof sets and frames. The context is 256 lanes drawn from a seed
with numpy and spread across each term's branches (joints on both sides of
their soft limits, feet above and below the swing thresholds, contact and no
contact). Both sides compute in float32 on the CPU; XLA's and PyTorch's
``exp`` may differ in the last bit, so the tolerance is rtol 1e-5 / atol
1e-6. ``envs/rewards.py`` (the post stage outside K1) is the second
reference: every term of the fold equals its tensor form there within the
same tolerance on the same context."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.envs.post_lanes import LanePost as JaxLanePost
from wiki_grx_gym_tpu_torch.envs.post_lanes import LanePost
from wiki_grx_gym_tpu_torch.envs.rewards import REWARDS, RewardContext
from wiki_grx_gym_tpu_torch.sim import cuda_step

N = 256
RTOL, ATOL = 1e-5, 1e-6
TERMS = sorted(cuda_step.REWARD_IDS)


@pytest.fixture(scope="module")
def posts():
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = 4
    cuda_step.all_terms_config(jc)
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    tenv = cuda_step.task_env("GR1T1", 4, "cpu", cuda_step.all_terms_config)
    jp, tp = JaxLanePost(jenv), LanePost(tenv)
    assert jp.reward_names == tp.reward_names and len(tp.reward_names) == 50
    assert jp.penalized_groups == tp.penalized_groups and len(tp.penalized_groups) == 4
    assert jp.extra_schema() == tp.extra_schema() and jp.out_schema() == tp.out_schema()
    return jp, tp, tenv, context(tp)


def context(post):
    """A random lane context (numpy float32) with the keys the terms read."""
    rng = np.random.RandomState(0)
    nd, nf = post.nd, post.nf
    f = lambda *shape, lo=-1.0, hi=1.0: rng.uniform(lo, hi, shape).astype(np.float32)
    lo, hi = post.dof_pos_soft_lower, post.dof_pos_soft_upper
    span = (hi - lo)[:, None]
    q = (lo[:, None] + span * f(nd, N, lo=-0.2, hi=1.2)).astype(np.float32)   # past both limits
    vel = post.dof_vel_limits[:, None] * post.rw.soft_dof_vel_limit
    target = post.rw.swing_feet_height_target
    ctx = dict(
        commands=f(3, N), blv=f(3, N), bav=f(3, N), pg=f(3, N), torso_pg=f(3, N),
        forehead_pg=f(3, N), q=q, qd=(vel * f(nd, N, lo=-1.3, hi=1.3)).astype(np.float32),
        dof_acc=f(nd, N, lo=-300, hi=300), actions=f(nd, N, lo=-2.0, hi=2.0),
        tau=(post.torque_limits[:, None] * post.rw.soft_torque_limit
             * f(nd, N, lo=-1.5, hi=1.5)).astype(np.float32),
        last_actions=f(nd, N, lo=-2.0, hi=2.0), last_last_actions=f(nd, N, lo=-2.0, hi=2.0),
        feet_contact=rng.rand(nf, N) > 0.5, first_contact=(rng.rand(nf, N) > 0.5).astype(np.float32),
        feet_air_time=f(nf, N, lo=0.0, hi=1.0), feet_land_time=f(nf, N, lo=0.0, hi=3.0),
        feet_height=f(nf, N, lo=-0.02, hi=1.5 * target),
        feet_force=f(nf, 3, N, lo=-400, hi=400), avg_force=f(nf, N, lo=0.0, hi=600.0),
        avg_vxyz=f(nf, 3, N, lo=-2.0, hi=2.0), pen_count=rng.randint(0, 5, (N,)).astype(np.float32),
        bho=f(N, lo=-5.0, hi=5.0), base_height=f(N, lo=0.3, hi=1.2),
    )
    ctx["cmd_active"] = (np.hypot(ctx["commands"][0], ctx["commands"][1]) > 0.1).astype(np.float32)
    return ctx


def lanes(ctx, conv):
    """The context as lists of lanes (the programs' form) through ``conv``."""
    out = {}
    for k, v in ctx.items():
        if v.ndim == 1:
            out[k] = conv(v)
        elif v.ndim == 2:
            out[k] = [conv(x) for x in v]
        else:
            out[k] = [[conv(y) for y in x] for x in v]
    return out


@pytest.mark.parametrize("name", TERMS)
def test_fold_term_matches_jax(posts, name):
    jp, tp, _, ctx = posts
    want = np.asarray(getattr(jp, "_rw_" + name)(lanes(ctx, jnp.asarray)), np.float64)
    got = getattr(tp, "_rw_" + name)(lanes(ctx, torch.from_numpy))
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.ptp(want) > 0.0, f"{name} is constant on the context: a branch is not reached"


def test_pen_count_matches_jax(posts):
    """The penalized-contact count, through ``LanePost.run`` on a random
    final state and point forces (each penalized group's force planted
    above or below the 0.1 N threshold): the ``collision`` term (1 -
    exp(sigma x count)) of both, and the count itself, recovered from it,
    spread over 0 ... 4 groups."""
    jp, tp, _, _ = posts
    rng = np.random.RandomState(1)
    f = lambda *shape: rng.uniform(-1, 1, shape).astype(np.float32)
    nd, nf, npost, np_ = tp.nd, tp.nf, 3, 29
    quat = f(4, N)
    quat /= np.linalg.norm(quat, axis=0)
    pq = f(npost, 4, N)
    pq /= np.linalg.norm(pq, axis=1, keepdims=True)
    force = f(np_, 3, N) * 50.0
    for g, grp in enumerate(tp.penalized_groups):
        on = rng.rand(N) > 0.5
        for p in grp:   # in touch: ~N; not: below 0.1 N in all (or exactly 0)
            force[p] *= np.where(on, 1.0, 0.0004 * (g % 2)).astype(np.float32)
    state = dict(pos=f(3, N), quat=quat, lin=f(3, N), ang=f(3, N), q=f(nd, N), qd=f(nd, N))
    acc = dict(tau=f(nd, N), point_force=force, post_quat=pq, post_rel=f(npost, 3, N),
               force_sum=f(nf, N), vxyz_sum=f(nf, 3, N))
    extra = dict(commands=f(3, N), last_last_actions=f(nd, N), feet_air_time=f(nf, N),
                 feet_land_time=f(nf, N), feet_contact_last=(rng.rand(nf, N) > 0.5).astype(np.float32))
    actions, last_actions, last_dof_vel = f(nd, N), f(nd, N), f(nd, N)
    args = (state, acc, actions, last_actions, extra, last_dof_vel)
    want = jp.run(*[lanes(a, jnp.asarray) if isinstance(a, dict) else [jnp.asarray(x) for x in a]
                    for a in args])
    got = tp.run(*[lanes(a, torch.from_numpy) if isinstance(a, dict) else [torch.from_numpy(x) for x in a]
                   for a in args])
    r = tp.reward_names.index("collision")
    w, g = np.asarray(want["rew_terms"][r], np.float64), got["rew_terms"][r].double().numpy()
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    scale, sigma = tp.scales["collision"], tp.rw.sigma_collision
    count = np.log(1.0 - g / scale) / sigma
    np.testing.assert_allclose(count, np.round(count), atol=0.01)   # float32 through log
    assert set(np.round(count).astype(int)) == {0, 1, 2, 3, 4}
    for name in ("term_contact", "feet_contact", "rew_terms"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a.double().numpy(), np.asarray(b, np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", TERMS)
def test_fold_term_matches_the_tensor_form(posts, name):
    """The second reference: the term of ``envs/rewards.py`` (the post stage
    outside K1) on the same context, as (N, ...) tensors."""
    _, tp, env, ctx = posts
    t = lambda k: torch.from_numpy(np.ascontiguousarray(np.moveaxis(ctx[k], -1, 0)))
    rc = RewardContext(
        commands=t("commands"), base_lin_vel=t("blv"), base_ang_vel=t("bav"),
        base_projected_gravity=t("pg"), base_heights_offset=t("bho"),
        base_height=t("base_height"), torso_projected_gravity=t("torso_pg"),
        forehead_projected_gravity=t("forehead_pg"), dof_pos=t("q"), dof_vel=t("qd"),
        dof_acc=t("dof_acc"), torques=t("tau"), actions=t("actions"),
        last_actions=t("last_actions"), last_last_actions=t("last_last_actions"),
        feet_contact=t("feet_contact"), feet_first_contact=t("first_contact"),
        feet_air_time=t("feet_air_time"), feet_land_time=t("feet_land_time"),
        feet_height=t("feet_height"), feet_contact_force=t("feet_force"),
        avg_feet_contact_force=t("avg_force"), avg_feet_speed_xyz=t("avg_vxyz"),
        penalized_contact_count=t("pen_count"), reset_buf=torch.zeros(N, dtype=torch.bool),
        time_out_buf=torch.zeros(N, dtype=torch.bool),
    )
    want = REWARDS[name](env, rc)
    got = getattr(tp, "_rw_" + name)(lanes(ctx, torch.from_numpy))
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=name)
