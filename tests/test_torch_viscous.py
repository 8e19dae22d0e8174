"""Port parity at the viscous-friction contact: ``contact_tangent_stiffness
= 0`` (no anchored stick spring; the tangential force is the capped-viscous
law ``k_t = min(m / dt, mu f_n / max(|v_t|, slip))``) with self-collision
off, the root ``bench.py``'s ``ref_equiv_subset`` (``scripts/bench.py``'s
``ref_equiv_subset``). On the CPU:

1. K1's plain version (``sim/scalarized.py`` with ``envs/post_lanes.py``,
   through the ``cuda_step`` wrapper on CPU tensors) against JAX's
   ``lanes`` backend under jit: one policy step at the config's 10
   substeps, 8 reachable GR1T1 envs with their feet on the ground, every
   output group at tests/test_torch_decimation.py's tolerances (state rtol
   1e-5 / atol 1e-5, point forces atol 1e-4 N, reward lanes rtol 1e-4 /
   atol 1e-5), each widened by 3x the port's own float32 noise floor on
   the same input (its float32 result against float64), the boolean lanes
   exact.
2. The port's engine (``sim/engine.physics_step``) against JAX's, one
   substep from the same 8 reachable states with random torques, joint
   damping and per-env randomization, on the plane, a heightfield and
   trimesh risers, at tests/test_torch_engine.py's substep tolerances
   (state rtol 2e-4 / atol 2e-5, point forces rtol 2e-3 / atol 5e-3).
3. The lane program's terrain modes (``local_plane`` on a planar slope,
   ``local_plane_walls`` on a flat tread with a riser wall ahead of robots
   moving into it, as tests/test_torch_engine.py sets them up) against
   JAX's engine on the same ground, two substeps from the same states, at
   those substep tolerances: K1's terrain-mode viscous branch.

Each shows that the viscous law ran: points in contact with a non-zero
tangential force, anchors left as they were, and the stick program giving
other forces on the same inputs. K1's constant block for this program
carries ``use_tangent = 0``; the kernel itself is held against the plain
version on the card (chip_smoke.py, ``GR1T1_viscous``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_decimation import PHYS_GROUPS, POST, build_case, check_group, run_port
from test_torch_engine import SUBSTEP, SUBSTEP_FORCE, grounds, lanes_of, port_step
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim import engine as je
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.scripts.bench import ref_equiv_subset
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.sim import engine as te
from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarSubstep

PHYS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")
N = 8


def contact_counts(point_force):
    """(points with a normal force, points with a tangential force) on the
    plane, from (N, P, 3) forces."""
    f = np.asarray(point_force, np.float64)
    return int((f[..., 2] > 0).sum()), int((np.abs(f[..., :2]).max(axis=-1) > 0).sum())


# ---- 1. the lane program (K1's plain version), one policy step ------------


@pytest.fixture(scope="module")
def case():
    """(JAX output, port output, port output in float64, port op, port inputs)."""
    want, got, op, port_inputs = build_case(10, ref_equiv_subset)
    return want, got, run_port(op, port_inputs, torch.float64), op, port_inputs


@pytest.mark.parametrize("name", PHYS_GROUPS + ["post/" + k for k in POST])
def test_lane_program_group_matches_jax(case, name):
    check_group(case[:3], name)


def test_lane_program_runs_the_viscous_law(case):
    want, got, _, op, port_inputs = case
    assert op.deci.decimation == 10
    assert op.deci.sub.contact.tangent_stiffness == 0.0 and op.sizes.NPAIR == 0
    assert float(got[8]["feet_contact"].sum()) >= 4
    normal, tangential = contact_counts(got[5].numpy())
    assert normal >= 8 and tangential >= 8
    assert contact_counts(want[5]) == (normal, tangential)
    # no anchor spring: the anchors pass through unchanged
    np.testing.assert_array_equal(got[0].anchor.numpy(), port_inputs[0]["anchor"])


def test_stick_program_differs_on_the_same_inputs(case):
    """The same inputs through the stick program (anchored spring, also
    without self-collision) give other tangential forces, and K1's constant
    blocks of the two programs differ in ``use_tangent``."""
    _, got, _, op, port_inputs = case
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = got[0].q.shape[0]
    tc.asset.self_collisions = -1
    stick = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")[0].decimation_op
    assert stick.sizes == op.sizes
    other = run_port(stick, port_inputs, torch.float32)
    assert float((other[5][..., :2] - got[5][..., :2]).abs().max()) > 1.0   # newtons
    kv = cuda_step._make_constants(op.deci, op.in_off, op.out_off, op.c_in, op.c_out)
    ks = cuda_step._make_constants(stick.deci, stick.in_off, stick.out_off, stick.c_in, stick.c_out)
    assert (kv.use_tangent, ks.use_tangent) == (0, 1)


# ---- 2. the engine, one substep -------------------------------------------


@pytest.fixture(scope="module")
def envs():
    jc, _ = jax_registry.get_cfgs("GR1T1")
    tc, _ = torch_registry.get_cfgs("GR1T1")
    for c in (jc, tc):
        c.env.num_envs = N
        ref_equiv_subset(c)
    jenv = jax_registry.make_env("GR1T1", env_cfg=jc)[0]
    tenv = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")[0]
    assert jenv.contact_params.tangent_stiffness == tenv.contact_params.tangent_stiffness == 0.0
    assert tenv.self_pairs == ((), ()) and not jenv.self_pairs[0]
    return jenv, tenv


def engine_inputs(case, env):
    """(physics state, torques, randomization, joint damping) as numpy:
    the lane program's reachable states and randomization (feet on the
    ground), random torques and damping as tests/test_torch_engine.py
    draws them."""
    phys, rand = case[4][0], case[4][1]
    assert phys["q"].shape[0] == N
    rng = np.random.RandomState(1)
    f32 = lambda a: np.asarray(a, np.float32)
    return (phys, f32(rng.randn(N, env.num_dof) * 30), rand,
            f32(np.asarray(env.d_gains)[None] * (0.9 + 0.2 * rng.rand(N, env.num_dof))))


@pytest.mark.parametrize("ground", ["plane", "heightfield", "trimesh"])
def test_engine_substep_matches_jax(case, envs, ground):
    jenv, tenv = envs
    phys, tau, rand, damp = engine_inputs(case, jenv)
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
    # the viscous law ran: the anchors stay, and points in contact carry a
    # tangential force
    np.testing.assert_array_equal(gs.anchor.numpy(), phys["anchor"])
    f = go.point_force.numpy()
    assert (np.abs(f).max(axis=-1) > 0).sum() >= N
    if ground == "plane":
        normal, tangential = contact_counts(f)
        assert normal >= N and tangential >= N


def test_engine_viscous_differs_from_stick(case, envs):
    jenv, tenv = envs
    phys, tau, rand, damp = engine_inputs(case, jenv)
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = N
    tc.asset.self_collisions = -1
    stick = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")[0]
    th = grounds("plane")[2]
    _, visc = port_step(tenv, phys, tau, rand, damp, th, None)
    _, stuck = port_step(stick, phys, tau, rand, damp, th, None)
    assert float((visc.point_force[..., :2] - stuck.point_force[..., :2]).abs().max()) > 1.0


# ---- 3. the lane program's terrain modes against JAX's engine --------------

SLOPE = (0.18, -0.11)
RISER = (0.0, 0.0, 0.0, 0.05, 0.2, 1.0, 0.0, 0.0, 0.0)   # flat tread; a wall at x 0.05, top 0.2 m


def lane_roll(tenv, mode, phys, rand, tau, plane, dtype):
    """Two substeps of the lane program in ``mode`` (states and forces as
    numpy, float64)."""
    sub = ScalarSubstep(tenv.model, tenv.contact_params, tenv.sim_dt, tenv.self_pairs, terrain_mode=mode)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    lanes = lanes_of(te.PhysicsState(**{k: t(v) for k, v in phys.items()}),
                     te.BodyRandomization(**{k: t(v) for k, v in rand.items()}),
                     [[t(v) for v in p] for p in plane])
    for _ in range(2):
        lanes, aux = sub.substep(lanes, [t(tau)[:, i] for i in range(tenv.num_dof)], None)
    st = lambda ls: torch.stack([torch.broadcast_to(x, (N,)) for x in ls], -1).double().numpy()
    out = {"base_pos": st(lanes["pos"]), "base_quat": st(lanes["quat"]), "base_lin_vel": st(lanes["lin"]),
           "base_ang_vel": st(lanes["ang"]), "q": st(lanes["q"]), "qd": st(lanes["qd"]),
           "anchor": np.stack([st(a) for a in lanes["anchor"]], -2)}
    out["point_force"] = np.stack([st(f) for f in aux["point_force"]], -2)
    return out


@pytest.mark.parametrize("mode", ["local_plane", "local_plane_walls"])
def test_lane_terrain_modes_match_jax_engine(case, envs, mode):
    """Each output within the substep tolerance plus 3x the lane program's
    own float32 noise floor on this input (its float32 result against its
    float64 one; tests/test_torch_decimation.py's rule): the stiff riser
    contact amplifies last-bit differences between two float32 programs."""
    jenv, tenv = envs
    phys, tau, rand, _ = engine_inputs(case, jenv)
    phys = {k: v.copy() for k, v in phys.items()}
    tau = tau / 6.0
    nump = tenv.model.num_points
    if mode == "local_plane":
        gx, gy = SLOPE
        phys["base_pos"][:, 2] += gx * phys["base_pos"][:, 0] + gy * phys["base_pos"][:, 1]
        jh, jq = (lambda x, y: gx * x + gy * y), None
        plane = [[np.zeros(N, np.float32), np.full(N, gx, np.float32), np.full(N, gy, np.float32)]] * nump
    else:
        phys["base_pos"][:, 0] = 0.0
        phys["base_lin_vel"][:, 0] = 2.0
        chan = jnp.asarray(RISER, jnp.float32)
        jh, jq = None, (lambda x, y: jnp.broadcast_to(chan, x.shape + (9,)))
        plane = [[np.full(N, v, np.float32) for v in RISER]] * nump
    step = jax.jit(jax.vmap(lambda p, t, r: je.physics_step(
        jenv.model, p, t, jh, jenv.contact_params, r, jenv.sim_dt, self_pairs=jenv.self_pairs, ground_query=jq)))
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    ws, jr = je.PhysicsState(**j(phys)), je.BodyRandomization(**j(rand))
    for _ in range(2):
        ws, wo = step(ws, jnp.asarray(tau), jr)
    want = {k: np.asarray(getattr(ws, k), np.float64) for k in PHYS}
    want["point_force"] = np.asarray(wo.point_force, np.float64)

    got = lane_roll(tenv, mode, phys, rand, tau, plane, torch.float32)
    got64 = lane_roll(tenv, mode, phys, rand, tau, plane, torch.float64)
    for k in want:
        tol = SUBSTEP_FORCE if k == "point_force" else SUBSTEP
        floor = float(np.abs(got[k] - got64[k]).max())
        err = np.abs(got[k] - want[k])
        assert np.all(err <= tol["atol"] + tol["rtol"] * np.abs(want[k]) + 3.0 * floor), (
            f"{mode} {k}: max |port - jax| {err.max():.3e}, float32 noise floor {floor:.3e}")
    # the viscous law ran: the anchors stay, and points touch the ground
    np.testing.assert_array_equal(got["anchor"], phys["anchor"])
    assert (np.abs(got["point_force"]).max(axis=-1) > 0).sum() >= N
    if mode == "local_plane_walls":
        # points against the wall and points inside its solid (no tread force)
        x = np.asarray(wo.point_pos)[..., 0]
        r = np.asarray(tenv.model.point_radius)[None, :]
        assert ((x + r > RISER[3]) & (x < RISER[3])).sum() > 0 and (x > RISER[3]).sum() > 0
