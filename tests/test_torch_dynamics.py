"""Port parity and physics checks for ``sim/dynamics.py`` (and the
kinematics Jacobian), on the CPU.

1. Against the JAX package (``jax.vmap`` of its per-env functions, run
   eagerly: XLA on the CPU takes minutes to compile the 32-DOF body) on the
   same random states, made with numpy from a seed, for GR1T1's lower limb
   (10 DOF) and full body (GR1T1_full, 32 DOF): ``inertial_quantities``
   (with the base mass scale and com offset), ``mass_matrix``,
   ``bias_forces``, ``forward_dynamics`` (free base with external wrenches
   and the implicit joint diagonal, and fixed base) and ``jacobians``.
   Tolerance: rtol 1e-4 with an atol of 1e-5 of the compared quantity's
   largest |value| (float32: the port sums some products in another order
   than XLA; the accelerations go through the (6+D)^2 solve, condition
   ~1e4, so they get rtol 1e-3 and 1e-4 of their scale).
2. tests/test_dynamics.py's checks on the port: free fall, the pendulum's
   analytic acceleration and its energy over 8000 substeps, M equal to the
   Hessian of the kinetic energy and the gravity bias equal to the gradient
   of the potential (``torch.autograd`` in float64, to 1e-8 relative), the
   humanoid's energy in free flight, the ball settling on the plane and
   stopped by friction, the GR1T1 drop, a ball held on a 15-degree slope
   by stick friction, and the Jacobian against FK and autograd. Their
   bounds are tests/test_dynamics.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.models.serialize import load_robot as jax_load
from wiki_grx_gym_tpu.sim import dynamics as jd
from wiki_grx_gym_tpu.sim.kinematics import forward_kinematics as jax_fk
from wiki_grx_gym_tpu.sim.kinematics import jacobians as jax_jac
from wiki_grx_gym_tpu_torch.models.serialize import RESOURCES, load_robot
from wiki_grx_gym_tpu_torch.models.urdf import compile_robot
from wiki_grx_gym_tpu_torch.sim import dynamics as td
from wiki_grx_gym_tpu_torch.sim import engine
from wiki_grx_gym_tpu_torch.sim.contact import ContactParams
from wiki_grx_gym_tpu_torch.sim.kinematics import forward_kinematics, jacobians
from wiki_grx_gym_tpu_torch.utils import maths as tm

N = 6
SPECS = ["gr1t1_lower_limb", "gr1t1"]


def random_case(model, seed):
    rng = np.random.RandomState(seed)
    d, b = model.num_dof, model.num_bodies
    q4 = rng.randn(N, 4).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        quat=f32(q4 / np.linalg.norm(q4, axis=-1, keepdims=True)),
        w=f32(rng.randn(N, 3)), v=f32(rng.randn(N, 3)),
        q=f32(rng.uniform(-0.5, 0.5, (N, d))), qd=f32(rng.randn(N, d) * 2.0),
        tau=f32(rng.randn(N, d) * 20.0), ext=f32(rng.randn(N, b, 6) * 5.0),
        mass_scale=f32(0.9 + 0.2 * rng.rand(N)), com_offset=f32(rng.randn(N, 3) * 0.02),
        diag=f32(rng.rand(N, d) * 0.5),
    )


@pytest.fixture(scope="module", params=SPECS)
def case(request):
    """(spec, JAX results, port results) on one random case."""
    spec = request.param
    jmod, tmod = jax_load(f"{RESOURCES}/{spec}.json"), load_robot(f"{RESOURCES}/{spec}.json")
    c = random_case(tmod, 0)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.from_numpy(v) for k, v in c.items()}

    def jax_all(quat, w, v, q, qd, tau, ext, mass_scale, com_offset, diag):
        kin = jax_fk(jmod, quat, w, v, q, qd)
        mass, com_rel, blocks = jd.inertial_quantities(jmod, kin, mass_scale, com_offset)
        grav = mass[:, None] * jd.GRAVITY
        fd = jd.forward_dynamics(jmod, kin, qd, tau, ext, mass_scale, com_offset, joint_diag=diag)
        fx = jd.forward_dynamics(jmod, kin, qd, tau, ext, fixed_base=True)
        return dict(mass=mass, com_rel=com_rel, h=blocks.h, i_org=blocks.i_org,
                    M=jd.mass_matrix(jmod, kin, blocks),
                    C=jd.bias_forces(jmod, kin, qd, blocks, jnp.cross(com_rel, grav) + ext[:, :3],
                                     grav + ext[:, 3:]),
                    base_acc=fd.base_acc, qdd=fd.qdd, qdd_fixed=fx.qdd, jac=jax_jac(jmod, kin))

    with jax.disable_jit():
        want = jax.vmap(jax_all)(*(j[k] for k in ("quat", "w", "v", "q", "qd", "tau", "ext", "mass_scale",
                                                  "com_offset", "diag")))
    kin = forward_kinematics(tmod, t["quat"], t["w"], t["v"], t["q"], t["qd"])
    mass, com_rel, blocks = td.inertial_quantities(tmod, kin, t["mass_scale"], t["com_offset"])
    grav = mass[..., None] * td.GRAVITY
    fd = td.forward_dynamics(tmod, kin, t["qd"], t["tau"], t["ext"], t["mass_scale"], t["com_offset"],
                             joint_diag=t["diag"])
    fx = td.forward_dynamics(tmod, kin, t["qd"], t["tau"], t["ext"], fixed_base=True)
    got = dict(mass=mass, com_rel=com_rel, h=blocks.h, i_org=blocks.i_org, M=td.mass_matrix(tmod, kin, blocks),
               C=td.bias_forces(tmod, kin, t["qd"], blocks, tm._cross(com_rel, grav) + t["ext"][..., :3],
                                grav + t["ext"][..., 3:]),
               base_acc=fd.base_acc, qdd=fd.qdd, qdd_fixed=fx.qdd, jac=jacobians(tmod, kin))
    return spec, {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


SOLVED = ("base_acc", "qdd", "qdd_fixed")


@pytest.mark.parametrize("name", ["mass", "com_rel", "h", "i_org", "M", "C", "base_acc", "qdd", "qdd_fixed", "jac"])
def test_dynamics_matches_jax(case, name):
    spec, want, got = case
    assert got[name].shape == want[name].shape
    rtol, frac = (1e-3, 1e-4) if name in SOLVED else (1e-4, 1e-5)
    np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=frac * np.abs(want[name]).max(),
                               err_msg=f"{spec} {name}")


def test_mass_matrix_is_symmetric_positive_definite(case):
    _, _, got = case
    m = got["M"]
    np.testing.assert_array_equal(m, m.transpose(0, 2, 1))
    assert np.all(np.linalg.eigvalsh(m.astype(np.float64)) > 0)


# ---------------------------------------------------------------------------
# tests/test_dynamics.py on the port
# ---------------------------------------------------------------------------

def pendulum_model(base_mass=10.0, bob_mass=2.0, length=1.0):
    return compile_robot(f"""
    <robot name="pendulum">
      <link name="base">
        <inertial><origin xyz="0 0 0"/><mass value="{base_mass}"/>
          <inertia ixx="1" ixy="0" ixz="0" iyy="1" iyz="0" izz="1"/></inertial>
      </link>
      <link name="bob">
        <inertial><origin xyz="0 0 -{length}"/><mass value="{bob_mass}"/>
          <inertia ixx="1e-9" ixy="0" ixz="0" iyy="1e-9" iyz="0" izz="1e-9"/></inertial>
      </link>
      <joint name="hinge" type="revolute">
        <parent link="base"/><child link="bob"/>
        <origin xyz="0 0 0" rpy="0 0 0"/><axis xyz="0 1 0"/>
        <limit lower="-10" upper="10" effort="1e9" velocity="1e9"/>
      </joint>
    </robot>
    """)


def ball_model(mass=1.0, radius=0.1):
    return compile_robot(f"""
    <robot name="ball">
      <link name="base">
        <inertial><origin xyz="0 0 0"/><mass value="{mass}"/>
          <inertia ixx="0.004" ixy="0" ixz="0" iyy="0.004" iyz="0" izz="0.004"/></inertial>
        <collision><origin xyz="0 0 0"/><geometry><sphere radius="{radius}"/></geometry></collision>
      </link>
    </robot>
    """)


def free_space(x, y):
    return torch.full_like(x, -1e6)   # ground far below: no contact


def kin_of(model, s):
    return forward_kinematics(model, s.base_quat, s.base_ang_vel, s.base_lin_vel, s.q, s.qd)


def roll(model, state, tau, height_fn, steps, dt, record=None, **kw):
    cp, rand = ContactParams(), engine.BodyRandomization.identity(state.base_pos.shape[:-1])
    rec = []
    for _ in range(steps):
        state, out = engine.physics_step(model, state, tau(state) if callable(tau) else tau, height_fn, cp, rand,
                                         dt, **kw)
        if record is not None:
            rec.append(record(state, out))
    return state, rec


def test_free_fall():
    model = pendulum_model(base_mass=5.0)
    s = engine.default_state(model, [0, 0, 10.0], [0, 0, 0, 1], [0.0])
    new, _ = roll(model, s, torch.zeros(1), free_space, 1, 0.001)
    np.testing.assert_allclose(new.base_lin_vel.numpy() / 0.001, [0, 0, -9.81], atol=1e-3)
    np.testing.assert_allclose(new.qd.numpy(), [0.0], atol=1e-4)


@pytest.mark.parametrize("q0", [0.3, -0.7, 1.2])
def test_pendulum_acceleration_matches_analytic(q0):
    """Fixed-base point-mass pendulum: thetadd = -(g / l) sin(theta)."""
    model = pendulum_model()
    s = engine.default_state(model, [0, 0, 2.0], [0, 0, 0, 1], [q0])
    fd = td.forward_dynamics(model, kin_of(model, s), s.qd, torch.zeros(1), torch.zeros(2, 6), fixed_base=True)
    np.testing.assert_allclose(float(fd.qdd[0]), -9.81 * np.sin(q0), rtol=1e-3, atol=1e-4)


def test_pendulum_energy_conservation():
    """The fixed-base pendulum swings without drift over 4 s (8000
    substeps, a couple of periods): the amplitude stays ~1 rad."""
    model = pendulum_model()
    s = engine.default_state(model, [0, 0, 2.0], [0, 0, 0, 1], [1.0])
    _, qs = roll(model, s, torch.zeros(1), free_space, 8000, 5e-4, record=lambda st, _: float(st.q[0]),
                 fixed_base=True)
    qs = np.asarray(qs)
    assert np.all(np.isfinite(qs))
    assert 0.97 < np.max(np.abs(qs[-4000:])) < 1.03
    assert np.min(np.abs(qs)) < 0.05


@pytest.fixture(scope="module")
def lower64():
    return load_robot(f"{RESOURCES}/gr1t1_lower_limb.json")


def random_kin_args(model, seed):
    rng = np.random.RandomState(seed)
    q4 = rng.randn(4)
    return (torch.from_numpy(q4 / np.linalg.norm(q4)), torch.from_numpy(rng.uniform(-0.5, 0.5, model.num_dof)),
            torch.from_numpy(rng.randn(6 + model.num_dof)))


def test_crba_matches_kinetic_energy_hessian(lower64):
    """M equals the Hessian of the kinetic energy in the generalized
    velocity (float64 autograd)."""
    model = lower64
    base_quat, q, gen_v = random_kin_args(model, 3)

    def ke(gv):
        kin = forward_kinematics(model, base_quat, gv[:3], gv[3:6], q, gv[6:])
        mass, com_rel, blocks = td.inertial_quantities(model, kin)
        i6 = td.spatial_inertia6(mass, com_rel, blocks)
        return 0.5 * torch.einsum("bi,bij,bj->", kin.twist, i6, kin.twist)

    m_hess = torch.autograd.functional.hessian(ke, gen_v)
    kin = forward_kinematics(model, base_quat, gen_v[:3], gen_v[3:6], q, gen_v[6:])
    m_crba = td.mass_matrix(model, kin, td.inertial_quantities(model, kin)[2])
    np.testing.assert_allclose(m_crba.numpy(), m_hess.numpy(), rtol=1e-8, atol=1e-10)


def test_gravity_bias_matches_potential_gradient(lower64):
    """At qd = 0 the joint bias equals dPE/dq (float64 autograd), and the
    base's vertical force bias the total weight."""
    model = lower64
    base_quat, q, _ = random_kin_args(model, 5)
    zero = torch.zeros(3, dtype=torch.float64)

    def pe(qq):
        kin = forward_kinematics(model, base_quat, zero, zero, qq, torch.zeros_like(qq))
        mass, com_rel, _ = td.inertial_quantities(model, kin)
        return -torch.sum(mass * com_rel[:, 2] * -9.81)

    grad_pe = torch.autograd.functional.jacobian(pe, q)
    kin = forward_kinematics(model, base_quat, zero, zero, q, torch.zeros(model.num_dof, dtype=torch.float64))
    mass, com_rel, blocks = td.inertial_quantities(model, kin)
    grav = mass[:, None] * torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)
    c_full = td.bias_forces(model, kin, torch.zeros(model.num_dof, dtype=torch.float64), blocks,
                            tm._cross(com_rel, grav), grav)
    np.testing.assert_allclose(c_full[6:].numpy(), grad_pe.numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(c_full[5]), float(mass.sum()) * 9.81, rtol=1e-10)


def test_humanoid_free_float_energy():
    """Zero gravity and no contact: the energy of the free-floating
    humanoid is conserved over 2000 substeps."""
    model = load_robot(f"{RESOURCES}/gr1t1_lower_limb.json").replace(gravity_scale=0.0)
    s = engine.default_state(model, [0, 0, 1.0], [0, 0, 0, 1], torch.zeros(model.num_dof))
    s = s.replace(base_ang_vel=torch.tensor([0.1, 0.2, -0.1]), qd=0.3 * torch.ones(10))

    def energy(st):
        kin = kin_of(model, st)
        mass, com_rel, blocks = td.inertial_quantities(model, kin)
        i6 = td.spatial_inertia6(mass, com_rel, blocks)
        return float(0.5 * torch.einsum("bi,bij,bj->", kin.twist.double(), i6.double(), kin.twist.double()))

    e0 = energy(s)
    s2, _ = roll(model, s, torch.zeros(model.num_dof), free_space, 2000, 2.5e-4)
    e1 = energy(s2)
    assert np.isfinite(e1) and abs(e1 - e0) / max(1.0, abs(e0)) < 5e-2


def test_ball_settles_on_plane():
    model = ball_model()
    s = engine.default_state(model, [0, 0, 0.3], [0, 0, 0, 1], torch.zeros(0))
    s, fz = roll(model, s, torch.zeros(0), engine.flat_ground, 2000, 1e-3,
                 record=lambda st, out: float(out.point_force[0, 2]))
    assert abs(float(s.base_lin_vel[2])) < 1e-3
    np.testing.assert_allclose(float(s.base_pos[2]), 0.1 - 9.81 / ContactParams().stiffness, atol=2e-3)
    np.testing.assert_allclose(fz[-1], 9.81, rtol=0.05)
    assert float(s.base_pos[2]) > 0.05


def test_ball_friction_stops_slide():
    model = ball_model()
    s = engine.default_state(model, [0, 0, 0.1], [0, 0, 0, 1], torch.zeros(0))
    s = s.replace(base_lin_vel=torch.tensor([1.0, 0.0, 0.0]))
    s, _ = roll(model, s, torch.zeros(0), engine.flat_ground, 3000, 1e-3)
    assert float(torch.linalg.vector_norm(s.base_lin_vel[:2])) < 0.5


def test_gr1t1_drop_is_stable():
    """The humanoid dropped with a PD hold at the default pose stays finite,
    lands, and its feet carry about its weight (52.8 kg)."""
    model = load_robot(f"{RESOURCES}/gr1t1_lower_limb.json")
    default_q = torch.tensor([0.0, 0.0, -np.deg2rad(15), np.deg2rad(30), -np.deg2rad(15)] * 2,
                             dtype=torch.float32)
    s = engine.default_state(model, [0, 0, 0.95], [0, 0, 0, 1], default_q)
    kp = torch.tensor([91.67, 126.05, 248.28, 248.28, 28.65] * 2)
    kd = kp / 10 * 0.5
    feet = model.link_point_mask(["left_foot_roll_link", "right_foot_roll_link"])
    lim = model.dof_effort_limit

    def tau(st):
        return torch.clamp(kp * (default_q - st.q) - kd * st.qd, -lim, lim)

    s, fz = roll(model, s, tau, engine.flat_ground, 500, 0.002,
                 record=lambda st, out: float(torch.sum(out.point_force[:, 2] * feet)))
    assert bool(torch.isfinite(s.base_pos).all()) and bool(torch.isfinite(s.q).all())
    late = float(np.mean(fz[-100:]))
    assert 0.5 * 52.8 * 9.81 < late < 2.0 * 52.8 * 9.81
    assert 0.3 < float(s.base_pos[2]) < 1.0


def test_stick_friction_no_creep_on_slope():
    """Anchored friction holds a ball on a 15-degree slope: < 2 mm of drift
    over 3 s after settling."""
    model = ball_model()
    slope = float(np.tan(np.deg2rad(15.0)))
    s = engine.default_state(model, [0, 0, 0.12], [0, 0, 0, 1], torch.zeros(0))
    incline = lambda x, y: slope * x
    s, _ = roll(model, s, torch.zeros(0), incline, 3000, 1e-3)
    x0 = float(s.base_pos[0])
    s2, _ = roll(model, s, torch.zeros(0), incline, 3000, 1e-3)
    assert abs(float(s2.base_pos[0]) - x0) < 2e-3
    assert abs(float(s2.base_lin_vel[0])) < 0.05


def test_jacobian_maps_genvel_to_body_twists(lower64):
    model = lower64
    base_quat, q, gen_v = random_kin_args(model, 7)
    kin = forward_kinematics(model, base_quat, gen_v[:3], gen_v[3:6], q, gen_v[6:])
    jac = jacobians(model, kin)
    assert jac.shape == (model.num_bodies, 6, 6 + model.num_dof)
    tw = jac @ gen_v
    v_origin = kin.twist[:, 3:] + tm._cross(kin.twist[:, :3], kin.pos_rel)
    np.testing.assert_allclose(tw[:, :3].numpy(), kin.twist[:, :3].numpy(), atol=1e-12)
    np.testing.assert_allclose(tw[:, 3:].numpy(), v_origin.numpy(), atol=1e-12)


def test_jacobian_linear_block_matches_position_autodiff(lower64):
    model = lower64
    base_quat, q, _ = random_kin_args(model, 9)
    zero = torch.zeros(3, dtype=torch.float64)
    dpos = torch.autograd.functional.jacobian(
        lambda qq: forward_kinematics(model, base_quat, zero, zero, qq, torch.zeros_like(qq)).pos_rel, q)
    kin = forward_kinematics(model, base_quat, zero, zero, q, torch.zeros(model.num_dof, dtype=torch.float64))
    np.testing.assert_allclose(jacobians(model, kin)[:, 3:, 6:].numpy(), dpos.numpy(), rtol=1e-9, atol=1e-12)
