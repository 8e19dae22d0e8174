"""Port parity for ``sim/engine.physics_step``, on the CPU.

1. Against JAX's ``physics_step`` (vmapped, under jit) on
   tests/test_scalarized.py's ``random_states`` (16 GR1T1 envs near the
   default pose, touching the ground) with random torques, implicit joint
   damping and per-env randomization, on the plane, on a heightfield
   (``Terrain.height_fn`` of a ``from_heightfield`` field) and on trimesh
   risers (``Terrain.ground_query``): one substep, at
   tests/test_scalarized.py's substep tolerances, rtol 2e-4 / atol 2e-5 on
   the state and rtol 2e-3 / atol 5e-3 on the point forces.
2. The port's engine against the port's lane program (K1's plain version,
   ``sim/scalarized.py``), as tests/test_scalarized.py:63-160 holds JAX's:
   one substep (the substep tolerances), ten chained substeps with zero
   torque (rtol 1e-3 / atol 1e-4), a whole policy step of the env's
   decimation loop on reachable states (the engine backend's
   ``_run_decimation`` against ``CudaDecimation.plain``: the state at rtol
   1e-3 / atol 1e-4, the feet sums, torques and point forces at rtol 2e-3 /
   atol 2e-2, each output also within 3x its env's own float32 noise floor
   of the tolerance, chip_smoke.py phase 16a's rule), and the lane
   program's ``local_plane`` and ``local_plane_walls`` ground against the
   engine on a slope and on a constant riser-wall query (2 substeps, the
   substep tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_scalarized import random_states
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim import engine as je
from wiki_grx_gym_tpu.terrain.composer import Terrain as JTerrain
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.sim import engine as te
from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarSubstep
from wiki_grx_gym_tpu_torch.terrain.composer import Terrain

N = 16
PHYS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")
VS, HS = 0.005, 0.1
SUBSTEP = dict(rtol=2e-4, atol=2e-5)
SUBSTEP_FORCE = dict(rtol=2e-3, atol=5e-3)


@pytest.fixture(scope="module")
def envs():
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = N
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = N
    return (jax_registry.make_env("GR1T1", env_cfg=jc)[0],
            torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")[0])


def fields():
    rng = np.random.RandomState(6)
    rough = rng.randint(-4, 9, (64, 64)).astype(np.int16)   # -2 .. +4 cm around the feet
    stairs = np.zeros((64, 64), np.int16)
    stairs += (np.arange(64)[:, None] // 5 % 2 * 10).astype(np.int16)   # 5 cm risers every 0.5 m in x
    stairs += (np.arange(64)[None, :] // 7 % 2 * 6).astype(np.int16)    # 3 cm risers every 0.7 m in y
    return {"heightfield": (rough, None), "trimesh": (stairs, 0.75)}


def grounds(which):
    """(JAX height_fn, JAX ground query, port height_fn, port ground query)."""
    if which == "plane":
        return je.flat_ground, None, te.flat_ground, None
    f, thr = fields()[which]
    jt, tt = JTerrain.from_heightfield(f, HS, VS, 3.2, thr), Terrain.from_heightfield(f, HS, VS, 3.2, thr)
    if thr is None:
        return jt.height_fn, None, tt.height_fn, None
    return None, jt.ground_channels, None, tt.ground_query


def inputs(env, seed):
    phys = random_states(env, N, seed)
    rng = np.random.RandomState(seed + 1)
    f32 = lambda a: np.asarray(a, np.float32)
    return ({k: np.array(getattr(phys, k)) for k in PHYS}, f32(rng.randn(N, env.num_dof) * 30),
            dict(friction=f32(0.5 + rng.rand(N)), restitution=f32(rng.rand(N) * 0.5),
                 base_mass_scale=f32(0.9 + 0.2 * rng.rand(N)), base_com_offset=f32(rng.randn(N, 3) * 0.02)),
            f32(np.asarray(env.d_gains)[None] * (0.9 + 0.2 * rng.rand(N, env.num_dof))))


def port_step(tenv, phys, tau, rand, damp, hf, gq, dtype=torch.float32, steps=1, pairs=True):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    s = te.PhysicsState(**{k: t(v) for k, v in phys.items()})
    r = te.BodyRandomization(**{k: t(v) for k, v in rand.items()})
    for _ in range(steps):
        s, out = te.physics_step(tenv.model, s, t(tau), hf, tenv.contact_params, r, tenv.sim_dt,
                                 self_pairs=tenv.self_pairs if pairs else ((), ()),
                                 joint_damping=None if damp is None else t(damp), ground_query=gq)
    return s, out


@pytest.mark.parametrize("ground", ["plane", "heightfield", "trimesh"])
def test_physics_step_matches_jax(envs, ground):
    jenv, tenv = envs
    phys, tau, rand, damp = inputs(jenv, 0)
    jh, jq, th, tq = grounds(ground)
    step = jax.jit(jax.vmap(lambda p, t, r, d: je.physics_step(
        jenv.model, p, t, jh, jenv.contact_params, r, jenv.sim_dt, self_pairs=jenv.self_pairs,
        joint_damping=d, ground_query=jq)))
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    ws, wo = step(je.PhysicsState(**j(phys)), jnp.asarray(tau), je.BodyRandomization(**j(rand)), jnp.asarray(damp))
    gs, go = port_step(tenv, phys, tau, rand, damp, th, tq)
    for k in PHYS:
        np.testing.assert_allclose(getattr(gs, k).numpy(), np.asarray(getattr(ws, k)), **SUBSTEP,
                                   err_msg=f"{ground} {k}")
    for k, kw in (("point_force", SUBSTEP_FORCE), ("point_pos", SUBSTEP), ("qdd", dict(rtol=2e-3, atol=5e-2))):
        np.testing.assert_allclose(getattr(go, k).numpy(), np.asarray(getattr(wo, k)), **kw, err_msg=f"{ground} {k}")
    np.testing.assert_allclose(go.kin.twist.numpy(), np.asarray(wo.kin.twist), rtol=1e-5, atol=1e-5)
    assert (np.abs(np.asarray(wo.point_force)[..., 2]) > 0).sum() > N   # in contact


def test_default_state_and_identity_match_jax(envs):
    jenv, tenv = envs
    q0 = np.array(jenv.default_dof_pos)
    js = je.default_state(jenv.model, [0, 0, 0.9], [0, 0, 0, 1], q0)
    ts = te.default_state(tenv.model, [0, 0, 0.9], [0, 0, 0, 1], q0)
    for k in PHYS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))
        assert getattr(ts, k).dtype == torch.float32
    jr, tr = je.BodyRandomization.identity(), te.BodyRandomization.identity((4,))
    for k in ("friction", "restitution", "base_mass_scale", "base_com_offset"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.broadcast_to(np.asarray(getattr(jr, k)),
                                                                              getattr(tr, k).shape))


# ---------------------------------------------------------------------------
# the port's engine against the port's lane program
# ---------------------------------------------------------------------------

def lanes_of(s, rand, plane=None):
    col = lambda a: [a[..., i] for i in range(a.shape[-1])]
    lanes = {"pos": col(s.base_pos), "quat": col(s.base_quat), "lin": col(s.base_lin_vel),
             "ang": col(s.base_ang_vel), "q": col(s.q), "qd": col(s.qd),
             "anchor": [col(s.anchor[:, p]) for p in range(s.anchor.shape[1])],
             "friction": rand.friction, "restitution": rand.restitution, "mass_scale": rand.base_mass_scale,
             "com_offset": col(rand.base_com_offset)}
    if plane is not None:
        lanes["plane"] = plane
    return lanes


def stack_lanes(lanes):
    st = lambda ls: torch.stack([torch.broadcast_to(x, (N,)) for x in ls], -1)
    out = {k: st(lanes[k]) for k in ("pos", "quat", "lin", "ang", "q", "qd")}
    out["anchor"] = torch.stack([st(a) for a in lanes["anchor"]], -2)
    return out


LANE = {"pos": "base_pos", "quat": "base_quat", "lin": "base_lin_vel", "ang": "base_ang_vel", "q": "q",
        "qd": "qd", "anchor": "anchor"}


def lane_roll(tenv, phys, tau, rand, damp, steps, mode="plane", plane=None):
    sub = ScalarSubstep(tenv.model, tenv.contact_params, tenv.sim_dt, tenv.self_pairs, terrain_mode=mode)
    t = lambda a: torch.from_numpy(np.asarray(a))
    s = te.PhysicsState(**{k: t(v) for k, v in phys.items()})
    r = te.BodyRandomization(**{k: t(v) for k, v in rand.items()})
    lanes = lanes_of(s, r, plane)
    aux = None
    for _ in range(steps):
        lanes, aux = sub.substep(lanes, [t(tau)[:, i] for i in range(tenv.num_dof)],
                                 None if damp is None else [t(damp)[:, i] for i in range(tenv.num_dof)])
    force = torch.stack([torch.stack([torch.broadcast_to(x, (N,)) for x in f], -1) for f in aux["point_force"]], -2)
    return stack_lanes(lanes), force


def test_substep_matches_lane_program(envs):
    jenv, tenv = envs
    phys, tau, rand, damp = inputs(jenv, 0)
    gs, go = port_step(tenv, phys, tau, rand, damp, te.flat_ground, None)
    ls, lf = lane_roll(tenv, phys, tau, rand, damp, 1)
    for k, f in LANE.items():
        np.testing.assert_allclose(getattr(gs, f).numpy(), ls[k].numpy(), **SUBSTEP, err_msg=f)
    np.testing.assert_allclose(go.point_force.numpy(), lf.numpy(), **SUBSTEP_FORCE)


def test_ten_substeps_match_lane_program(envs):
    """10 chained substeps (one policy step of physics), zero torque: no
    formulation drift compounds."""
    jenv, tenv = envs
    phys, _, _, _ = inputs(jenv, 2)
    rand = {k: np.asarray(v) for k, v in dict(friction=np.ones(N, np.float32), restitution=np.zeros(N, np.float32),
                                              base_mass_scale=np.ones(N, np.float32),
                                              base_com_offset=np.zeros((N, 3), np.float32)).items()}
    tau = np.zeros((N, tenv.num_dof), np.float32)
    gs, _ = port_step(tenv, phys, tau, rand, None, te.flat_ground, None, steps=10)
    ls, _ = lane_roll(tenv, phys, tau, rand, None, 10)
    for k, f in LANE.items():
        if k != "anchor":
            np.testing.assert_allclose(getattr(gs, f).numpy(), ls[k].numpy(), rtol=1e-3, atol=1e-4, err_msg=f)


@pytest.fixture(scope="module")
def decimation_case():
    """K1's plain version (the fold program of the "auto" env on the CPU)
    and the engine backend's ``_run_decimation`` on the same reachable
    GR1T1 states and inputs, each in float32 and float64 (32 envs)."""
    n = 32
    env, state = cuda_step.reachable_state(n, "cpu", steps=6)
    eng = cuda_step.task_env("GR1T1", n, "cpu", lambda c: setattr(c.sim, "use_pallas", False))
    assert env.backend == "lanes" and eng.backend == "engine"
    out = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(1)
        args, kw = cuda_step.decimation_inputs(env, state, gen, dtype=dtype)
        phys, actions, last_actions, motor, delay, rand = args
        s = state.replace(physics=phys, last_actions=last_actions, motor_strength=motor, rand=rand,
                          last_dof_vel=kw["last_qd"], torques=torch.zeros_like(phys.q))
        out[dtype] = (env.decimation_op.plain(*args, **kw), eng._run_decimation(s, actions, delay[:, None], None))
    return out


def groups(res):
    g = {f: getattr(res[0], f) for f in PHYS}
    g.update(force_sum=res[1], vxyz_sum=res[2], vrpy_sum=res[3], tau=res[4], point_force=res[5])
    return {k: v.double().reshape(v.shape[0], -1).numpy() for k, v in g.items()}


@pytest.mark.parametrize("name", list(PHYS) + ["force_sum", "vxyz_sum", "vrpy_sum", "tau", "point_force"])
def test_policy_step_matches_lane_program(decimation_case, name):
    lane, eng = (groups(r) for r in decimation_case[torch.float32])
    lane64, eng64 = (groups(r) for r in decimation_case[torch.float64])
    rtol, atol = (1e-3, 1e-4) if name in PHYS else (2e-3, 2e-2)
    err = np.abs(eng[name] - lane[name])
    stated = atol + rtol * np.abs(lane[name])
    env_floor = np.abs(lane[name] - lane64[name]).max(axis=1, keepdims=True)
    assert np.all(err <= stated + 3.0 * env_floor), (name, float(err.max()))
    # in float64 the two programs agree far inside the tolerance
    assert np.all(np.abs(eng64[name] - lane64[name]) <= 1e-3 * stated), name


def test_engine_step_returns_no_kernel_outputs(decimation_case):
    lane, eng = decimation_case[torch.float32]
    assert eng[6] is None and eng[7] is None and eng[8] is None and lane[8] is not None


def test_local_plane_matches_engine_on_slope(envs):
    """On a planar slope the lane program's per-point planes are the
    terrain: 2 substeps match the engine on the slope's height function."""
    jenv, tenv = envs
    gx, gy = 0.18, -0.11
    phys, tau, rand, _ = inputs(jenv, 7)
    phys["base_pos"][:, 2] += gx * phys["base_pos"][:, 0] + gy * phys["base_pos"][:, 1]
    tau = tau / 6.0
    gs, _ = port_step(tenv, phys, tau, rand, None, lambda x, y: gx * x + gy * y, None, steps=2)
    plane = [[torch.zeros(N), torch.full((N,), gx), torch.full((N,), gy)] for _ in range(tenv.model.num_points)]
    ls, _ = lane_roll(tenv, phys, tau, rand, None, 2, "local_plane", plane)
    for k, f in LANE.items():
        np.testing.assert_allclose(getattr(gs, f).numpy(), ls[k].numpy(), **SUBSTEP, err_msg=f)


def test_local_plane_walls_matches_engine_on_step(envs):
    """A flat tread at 0 and an up-riser wall just ahead of the robots,
    which move into it: the wall force, the tread suppression and the cone
    friction match the engine with a constant ground query."""
    jenv, tenv = envs
    phys, tau, rand, _ = inputs(jenv, 11)
    phys["base_pos"][:, 0] = 0.0
    phys["base_lin_vel"][:, 0] = 2.0
    tau = tau / 6.0
    chan = torch.tensor([0.0, 0.0, 0.0, 0.22, 0.2, 1.0, 0.0, 0.0, 0.0])
    gq = lambda x, y: chan.to(x.dtype).expand(x.shape + (9,))
    gs, _ = port_step(tenv, phys, tau, rand, None, None, gq, steps=2)
    plane = [[torch.full((N,), float(v)) for v in chan] for _ in range(tenv.model.num_points)]
    ls, _ = lane_roll(tenv, phys, tau, rand, None, 2, "local_plane_walls", plane)
    assert float(gs.base_pos[:, 0].max()) < 0.25   # the wall acted
    for k, f in LANE.items():
        np.testing.assert_allclose(getattr(gs, f).numpy(), ls[k].numpy(), **SUBSTEP, err_msg=f)
