"""Port parity for K1's plain version: the port's ``ScalarDecimation.run``
with ``LanePost``, through the ``cuda_step`` wrapper on CPU tensors, against
the JAX ``PallasDecimation(..., lanes=True)`` under jit, GR1T1 lower limb,
8 envs, delay on.

The states are reachable ones (the port's env after a few steps from
``init_state``, feet on the ground) plus random actions, delays and post
inputs, all as numpy and fed to both sides. This file runs 2 substeps per
policy step, as tests/test_pallas.py does for its element-wise checks;
tests/test_torch_decimation_full.py runs the full 10.

Tolerances follow tests/test_pallas.py: state rtol 1e-5 / atol 1e-5, point
forces atol 1e-4 (newtons), reward lanes rtol 1e-4 / atol 1e-5. XLA and
PyTorch round sin, cos and exp differently in the last bit, and the stiff
contact springs and the ill-conditioned (6+D)^2 mass matrix amplify such
differences, so the two float32 programs can differ by as much as each
differs from float64. Each bound is therefore widened by 3x the measured
float32 noise floor of the port on the same input (its float32 result
against its float64 result). A porting fault moves an output by far more.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim.engine import BodyRandomization as JRand
from wiki_grx_gym_tpu.sim.engine import PhysicsState as JPhys
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step

N = 8
PHYS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")
RAND = ("friction", "restitution", "base_mass_scale", "base_com_offset")


def build_case(decimation, mutate=None):
    """(JAX output, port output, port wrapper, port inputs) on one set of
    reachable inputs at ``decimation`` substeps per policy step; ``mutate``
    changes both configs first."""
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = N
    jc.sim.use_pallas = "lanes"
    jc.control.decimation = decimation
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = N
    if mutate is not None:
        mutate(jc)
        mutate(tc)
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")

    # reachable states: the port's env a few steps after init
    g = torch.Generator().manual_seed(0)
    s = tenv.init_state(g)
    for _ in range(6):
        s, _ = tenv.step(s, 0.3 * torch.randn(N, tenv.num_actions, generator=g))
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    phys = {k: getattr(s.physics, k).numpy().copy() for k in PHYS}
    rand = {k: getattr(s.rand, k).numpy().copy() for k in RAND}
    inputs = dict(
        actions=f32(np.clip(rng.randn(N, 10) * 0.3, tenv.clip_actions_min, tenv.clip_actions_max)),
        last_actions=s.last_actions.numpy().copy(),
        motor=s.motor_strength.numpy().copy(),
        delay=f32(rng.rand(N) * 3.0),
        last_qd=s.last_dof_vel.numpy().copy(),
    )
    extra = dict(
        commands=f32(rng.uniform(-1, 1, (N, 3))),
        last_last_actions=f32(rng.randn(N, 10) * 0.3),
        feet_air_time=f32(rng.rand(N, 2) * 0.6),
        feet_land_time=f32(rng.rand(N, 2) * 1.2),
        feet_contact_last=f32(rng.rand(N, 2) > 0.5),
    )

    pall = jenv._pallas_decimation
    assert pall.lanes and pall.post is not None

    @jax.jit
    def jax_call(phys, rand, inputs, extra):
        return pall(JPhys(**phys), inputs["actions"], inputs["last_actions"], inputs["motor"],
                    inputs["delay"], JRand(**rand), last_qd=inputs["last_qd"], extra=extra)

    jt = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    want = jax.device_get(jax_call(jt(phys), jt(rand), jt(inputs), jt(extra)))

    tc.control.decimation = decimation
    op = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")[0].decimation_op
    assert op.deci.decimation == pall.deci.decimation == decimation
    port_inputs = (phys, rand, inputs, extra)
    cuda_step.reset_launch_counts()
    got = run_port(op, port_inputs, torch.float32)
    assert cuda_step.LAUNCHES["k1"] == 0   # CPU tensors never launch the kernel
    return want, got, op, port_inputs


def run_port(op, port_inputs, dtype):
    from wiki_grx_gym_tpu_torch.sim.engine import BodyRandomization, PhysicsState

    phys, rand, inputs, extra = port_inputs
    tt = lambda d: {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}
    ti = tt(inputs)
    return op(PhysicsState(**tt(phys)), ti["actions"], ti["last_actions"], ti["motor"],
              ti["delay"], BodyRandomization(**tt(rand)), last_qd=ti["last_qd"],
              extra=tt(extra))


PHYS_GROUPS = list(PHYS) + ["force_sum", "vxyz_sum", "vrpy_sum", "tau", "point_force",
                           "post_rel", "post_quat"]
POST = ("rew_terms", "blv", "bav", "pg", "term_contact", "tilt", "bad", "feet_contact",
        "contact_filt", "first_contact", "feet_air_time_out", "feet_land_time_out",
        "feet_height", "bho")
BOOL = {"post/" + k for k in ("term_contact", "tilt", "bad", "feet_contact",
                              "contact_filt", "first_contact")}
# (rtol, atol) per group: state 1e-5/1e-5, point forces atol 1e-4 N, post
# lanes (rewards) 1e-4/1e-5 -- tests/test_pallas.py's tolerances
TOL = {**{g: (1e-5, 1e-5) for g in PHYS_GROUPS}, "point_force": (1e-5, 1e-4),
       "force_sum": (1e-5, 1e-4), **{"post/" + k: (1e-4, 1e-5) for k in POST}}


def groups(res):
    """Every output group of the wrapper's return tuple, as float64 numpy."""
    arr = lambda x: x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
    g = {f: arr(getattr(res[0], f)) for f in PHYS}
    g.update(force_sum=arr(res[1]), vxyz_sum=arr(res[2]), vrpy_sum=arr(res[3]),
             tau=arr(res[4]), point_force=arr(res[5]), post_rel=arr(res[6][0]),
             post_quat=arr(res[6][1]))
    g.update({"post/" + k: arr(v) for k, v in res[8].items()})
    return g


def check_group(case, name):
    """Port vs JAX for one output group: element-wise within the group's
    tolerance, widened by 3x the measured float32 noise floor of this input
    (the largest difference between the port run in float32 and in float64).
    Boolean lanes must agree exactly."""
    want, got, got64 = case
    j, p, p64 = groups(want)[name], groups(got)[name], groups(got64)[name]
    if name in BOOL:
        np.testing.assert_array_equal(p, j, err_msg=name)
        return
    rtol, atol = TOL[name]
    floor = float(np.max(np.abs(p - p64)))
    err = np.abs(p - j)
    assert np.all(err <= 3.0 * floor + atol + rtol * np.abs(j)), (
        f"{name}: max |port - jax| {err.max():.3e}, float32 noise floor {floor:.3e}")


def case_with_floor(decimation, mutate=None):
    want, got, op, port_inputs = build_case(decimation, mutate)
    return want, got, run_port(op, port_inputs, torch.float64), op


@pytest.fixture(scope="module")
def case():
    return case_with_floor(2)


def test_reachable_states_have_feet_in_contact(case):
    fc = case[1][8]["feet_contact"].numpy()
    assert fc.sum() >= N // 2


@pytest.mark.parametrize("name", PHYS_GROUPS + ["post/" + k for k in POST])
def test_output_group_matches(case, name):
    check_group(case[:3], name)


def test_noise_floor_is_small_at_two_substeps(case):
    """At 2 substeps the float32 noise floor itself stays near the stated
    tolerances (so the widening above is small)."""
    want, got, got64, _ = case
    g, g64 = groups(got), groups(got64)
    assert np.max(np.abs(g["q"] - g64["q"])) < 1e-5
    assert np.max(np.abs(g["point_force"] - g64["point_force"])) < 1e-2


def test_schema_matches_pallas_layout(case):
    op = case[3]
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = N
    jc.sim.use_pallas = "lanes"
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    pall = jenv._pallas_decimation
    assert op.in_schema == pall.in_schema and op.out_schema == pall.out_schema
    assert (op.c_in, op.c_out) == (pall.c_in, pall.c_out) == (186, 301)
    assert op.kernel_support_error() is None


def test_fold_nan_env_emits_zero_reward():
    """A numerically exploded env earns exactly 0 reward and is reset; the
    others keep earning (port of tests/test_pallas.py:315)."""
    cfg, _ = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N
    cfg.control.decimation = 2
    env, _ = torch_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    s = env.init_state(0)
    qd = s.physics.qd.clone()
    qd[3] = float("nan")
    pos = s.physics.base_pos.clone()
    pos[3] = float("nan")
    s = s.replace(physics=s.physics.replace(qd=qd, base_pos=pos))
    _, out = env.step(s, torch.zeros(N, env.num_actions))
    rew = out.rew.numpy()
    assert np.all(np.isfinite(rew)), f"non-finite rewards leaked: {rew}"
    assert rew[3] == 0.0
    assert bool(out.reset[3])
    assert np.any(rew[np.arange(N) != 3] != 0.0)
    assert np.all(np.isfinite(out.obs.numpy()))
