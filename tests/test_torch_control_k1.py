"""Port parity for K1's new programs (plain version): the all-terms fold with
penalized contacts, and the V and T control laws, each one policy step of
the port's ``cuda_step`` wrapper on CPU tensors against the JAX
``PallasDecimation`` lanes program on the same inputs; then one env step
with V and with T against the JAX env.

Programs (GR1T1, 8 envs, 2 substeps a policy step, delay on):

- ``all_terms``: the plane with the post fold, every one of the 50
  lane-form reward terms at a non-zero scale and contacts penalized on the
  thighs and shanks (``cuda_step.all_terms_config``; 4 groups of 2 points);
- ``V``, ``T``: the GR1T1 fold with the V and with the T control law;
- ``V_heading``: V with heading commands, a program without the fold that
  still reads ``last_qd`` (V's damping term).

The states are reachable ones (the port's env a few steps after
``init_state`` with the program's config) plus random actions, delays and
post inputs, as tests/test_torch_decimation.py makes them; some envs are
dropped to the ground and tilted so that thigh and shank points touch it.
The JAX program runs eagerly (``jax.disable_jit()``): a jit of each program
would cost more than the step. Tolerances are tests/test_torch_decimation.py's
(state rtol 1e-5 / atol 1e-5, point forces atol 1e-4 N, post lanes rtol
1e-4 / atol 1e-5), each widened by 3x the port's float32 noise floor on the
same input (the port run in float64); boolean lanes exact.

The env steps (GR1T1 with V and with T, 4 envs, decimation 2, one step from
the same converted JAX state with the same actions and U block, the JAX
step eager)
hold tests/test_torch_env.py's tolerances: rtol 1e-4 / atol 1e-5 widened by
3x the port's float32 floor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decimation import BOOL, PHYS, TOL, run_port
from test_torch_env import as_float64, assert_close_widened, jax_state_to_numpy, step_block
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim.engine import BodyRandomization as JRand
from wiki_grx_gym_tpu.sim.engine import PhysicsState as JPhys
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step

N, DECIMATION = 8, 2
PROGRAMS = {
    "all_terms": (cuda_step.all_terms_config, dict(CTRL=0, FOLD=1, NR=50, NPEN=4, NPENP=8)),
    "V": (cuda_step.control_config("V"), dict(CTRL=1, FOLD=1, NR=24, NPEN=0)),
    "T": (cuda_step.control_config("T"), dict(CTRL=2, FOLD=1, NR=24, NPEN=0)),
    "V_heading": (cuda_step.control_config("V", cuda_step.heading_config), dict(CTRL=1, FOLD=0, NR=0)),
}


def configs(mutate, n):
    jc, _ = jax_registry.get_cfgs("GR1T1")
    tc, _ = torch_registry.get_cfgs("GR1T1")
    for c in (jc, tc):
        c.env.num_envs = n
        c.control.decimation = DECIMATION
        mutate(c)
    jc.sim.use_pallas = "lanes"
    return jc, tc


def groups(res):
    """Every output group of the wrapper's return tuple, as float64 numpy."""
    arr = lambda x: x.double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
    g = {f: arr(getattr(res[0], f)) for f in PHYS}
    g.update(force_sum=arr(res[1]), vxyz_sum=arr(res[2]), vrpy_sum=arr(res[3]),
             tau=arr(res[4]), point_force=arr(res[5]), post_rel=arr(res[6][0]),
             post_quat=arr(res[6][1]))
    if res[8] is not None:
        g.update({"post/" + k: arr(v) for k, v in res[8].items()})
    return g


@pytest.fixture(scope="module", params=list(PROGRAMS))
def program(request):
    name = request.param
    mutate, sizes = PROGRAMS[name]
    jc, tc = configs(mutate, N)
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    g = torch.Generator().manual_seed(0)
    s = tenv.init_state(g)
    for _ in range(6):
        s, _ = tenv.step(s, 0.3 * torch.randn(N, tenv.num_actions, generator=g))
    rng = np.random.RandomState(0)
    f32 = lambda a: np.asarray(a, np.float32)
    phys = {k: getattr(s.physics, k).numpy().copy() for k in PHYS}
    # envs 0-2 dropped to the ground and pitched forward: knees and thighs touch it
    phys["base_pos"][:3, 2] = 0.35
    phys["base_quat"][:3] = f32([0.0, np.sin(0.6), 0.0, np.cos(0.6)])
    rand = {k: getattr(s.rand, k).numpy().copy() for k in ("friction", "restitution",
                                                          "base_mass_scale", "base_com_offset")}
    inputs = dict(
        actions=f32(np.clip(rng.randn(N, 10) * 0.3, tenv.clip_actions_min, tenv.clip_actions_max)),
        last_actions=s.last_actions.numpy().copy(), motor=s.motor_strength.numpy().copy(),
        delay=f32(rng.rand(N) * 3.0), last_qd=f32(s.last_dof_vel.numpy() + rng.randn(N, 10)),
    )
    op = tenv.decimation_op
    extra = None
    if op.post is not None:
        extra = dict(
            commands=f32(rng.uniform(-1, 1, (N, 3))), last_last_actions=f32(rng.randn(N, 10) * 0.3),
            feet_air_time=f32(rng.rand(N, 2) * 0.6), feet_land_time=f32(rng.rand(N, 2) * 1.2),
            feet_contact_last=f32(rng.rand(N, 2) > 0.5),
        )
    with jax.disable_jit():
        jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
        pall = jenv._pallas_decimation
        jt = lambda d: None if d is None else {k: jnp.asarray(v) for k, v in d.items()}
        ji = jt(inputs)
        want = jax.device_get(pall(JPhys(**jt(phys)), ji["actions"], ji["last_actions"], ji["motor"],
                                   ji["delay"], JRand(**jt(rand)), last_qd=ji["last_qd"],
                                   extra=jt(extra)))
    port_inputs = (phys, rand, inputs, extra if extra is not None else {})
    cuda_step.reset_launch_counts()
    got = run_port(op, port_inputs, torch.float32)
    got64 = run_port(op, port_inputs, torch.float64)
    assert cuda_step.LAUNCHES["k1"] == 0   # CPU tensors never launch the kernel
    return name, sizes, op, pall, (want, got, got64)


def test_program_matches_jax_lanes(program):
    name, _, _, _, (want, got, got64) = program
    j, p, p64 = groups(want), groups(got), groups(got64)
    assert set(j) == set(p)
    for g in j:
        if g in BOOL:
            np.testing.assert_array_equal(p[g], j[g], err_msg=f"{name} {g}")
            continue
        rtol, atol = TOL[g]
        floor = float(np.max(np.abs(p[g] - p64[g])))
        err = np.abs(p[g] - j[g])
        assert np.all(err <= 3.0 * floor + atol + rtol * np.abs(j[g])), (
            f"{name} {g}: max |port - jax| {err.max():.3e}, float32 noise floor {floor:.3e}")
    if name == "all_terms":   # the planted envs put penalized groups in contact
        r = program[2].post.reward_names.index("collision")
        assert (p["post/rew_terms"][:, r] != 0).any(), "no penalized group in contact"


def test_program_layout_and_sizes(program):
    """The wrapper's schemas equal the JAX kernel's; ``last_qd`` is an input
    wherever V runs or the fold reads it; the sizes name the control law,
    the fold and the penalized groups; K1 has a kernel for the program."""
    name, sizes, op, pall, _ = program
    assert op.in_schema == pall.in_schema and op.out_schema == pall.out_schema, name
    assert op.with_last_qd == pall.with_last_qd is True
    assert {k: getattr(op.sizes, k) for k in sizes} == sizes
    assert op.kernel_support_error() is None
    assert op.deci.control_type == pall.deci.control_type
    np.testing.assert_array_equal(
        np.zeros(0) if op.deci.damping_coeff is None else op.deci.damping_coeff,
        np.zeros(0) if pall.deci.damping_coeff is None else pall.deci.damping_coeff)


@pytest.mark.parametrize("control", ["V", "T"])
def test_env_step_matches_jax(control):
    """One GR1T1 env step with the ``control`` law, port against JAX."""
    jc, tc = configs(cuda_step.control_config(control), 4)
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    rng = np.random.RandomState(0)
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    assert jenv._post_fold and tenv._post_fold
    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    with jax.disable_jit():
        ts = env_state_from_numpy(jax_state_to_numpy(js))
        ts64 = env_state_from_numpy(as_float64(jax_state_to_numpy(js)))
        a = (rng.randn(4, jenv.num_actions) * 0.5).astype(np.float32)
        u = step_block(jenv, js).copy()
        js, jo = jenv.step(js, jnp.asarray(a))
        jo = jax.device_get(jo)
    ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
    ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
    for field in ("obs", "pri_obs", "rew"):
        assert_close_widened(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                             getattr(to64, field).numpy(), err_msg=f"{control} {field}")
    np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
    for field in ("q", "qd", "base_pos", "base_lin_vel"):
        assert_close_widened(getattr(ts.physics, field).numpy(), np.asarray(getattr(js.physics, field)),
                             getattr(ts64.physics, field).numpy(), err_msg=f"{control} {field}")
    assert_close_widened(ts.torques.numpy(), np.asarray(js.torques), ts64.torques.numpy(),
                         err_msg=f"{control} torques")


@pytest.mark.parametrize("control", ["P", "V", "T"])
def test_pd_torques_match_jax(control):
    """The env's control law on (N, D) tensors against the JAX env's."""
    jc, tc = configs(cuda_step.control_config(control), 4)
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    rng = np.random.RandomState(2)
    q, qd, act, lqd = (rng.randn(4, 10).astype(np.float32) for _ in range(4))
    motor = rng.uniform(0.9, 1.1, (4, 10)).astype(np.float32)
    want = np.asarray(jenv._pd_torques(*(jnp.asarray(x) for x in (q, qd, act, motor)),
                                       last_qd=jnp.asarray(lqd)))
    got = tenv._pd_torques(*(torch.from_numpy(x) for x in (q, qd, act, motor)),
                           last_qd=torch.from_numpy(lqd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    jd, td = jenv._implicit_damping_const, tenv._implicit_damping_const
    assert (jd is None) == (td is None) == (control == "T")
    if jd is not None:
        np.testing.assert_array_equal(td, jd)
