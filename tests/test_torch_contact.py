"""Port parity and checks for ``sim/contact.py``, on the CPU.

1. Against the JAX package (its per-env functions under ``jax.vmap``) on
   the same inputs, made with numpy from a seed: ``contact_forces`` with
   stick-friction anchors and with capped-viscous friction, on a slope
   (a height function), on a heightfield (``Terrain.height_fn`` of a
   ``from_heightfield`` field against JAX's) and on trimesh risers
   (``ground_query`` against JAX's ``ground_channels``, points planted on
   the walls); ``ground_normal``; ``wall_forces``; ``self_collision_forces``
   on GR1T1's 64 pairs; ``body_wrenches``. Per-env friction and restitution
   are (N,). Tolerance: rtol 1e-5 with an atol of 1e-5 of the largest
   |force| (the same formulas; a norm or a sum of three products may round
   in another order), anchors rtol 1e-5 / atol 1e-6 m.
2. tests/test_contact.py's self-pair audit and its ball held on a
   15-degree slope by stick friction (< 1 mm of creep over 3 s), and
   tests/test_riser.py's spheres on ``from_heightfield`` fields: pushed into
   a 0.2 m step it stops at the riser, without the riser correction a hard
   push wedges it up the ramp, and rolled off a descending step it lands on
   the low tread.
3. float64 autograd through ``contact_forces``: points at rest on the
   ground (zero tangential velocity and anchor error) and airborne points
   give finite gradients (no 0 / 0 from a zero-length norm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.sim import contact as jc
from wiki_grx_gym_tpu.terrain.composer import Terrain as JTerrain
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import contact as tc
from wiki_grx_gym_tpu_torch.terrain.composer import Terrain

N, P = 8, 29
DT = 0.002
VS, HS = 0.005, 0.1
SLOPE = (0.18, -0.11)


def points(seed, center=(0.0, 0.0), spread=0.5):
    """(N, P, 3) positions within a few cm of z = 0 (some in contact),
    velocities, anchors near the positions, radii, per-env friction and
    restitution."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    pos = np.stack([center[0] + rng.uniform(-spread, spread, (N, P)), center[1] + rng.uniform(-spread, spread, (N, P)),
                    rng.uniform(-0.02, 0.08, (N, P))], -1)
    return dict(pos=f32(pos), vel=f32(rng.randn(N, P, 3)), anchor=f32(pos + rng.randn(N, P, 3) * 0.01),
                radius=f32(rng.uniform(0.02, 0.06, P)), friction=f32(0.5 + rng.rand(N)),
                restitution=f32(rng.rand(N) * 0.5))


def grounds():
    rng = np.random.RandomState(5)
    rough = rng.randint(-20, 60, (64, 64)).astype(np.int16)
    step = np.zeros((24, 24), np.int16)
    step[10:, :] = int(round(0.2 / VS))
    step[:, 12:] += int(round(0.1 / VS))
    slope = lambda np_: (lambda x, y: SLOPE[0] * x + SLOPE[1] * y)
    return {
        "slope": (slope(jnp), slope(torch), None, None, (0.0, 0.0)),
        "heightfield": (JTerrain.from_heightfield(rough, HS, VS).height_fn,
                        Terrain.from_heightfield(rough, HS, VS).height_fn, None, None, (3.2, 3.2)),
        "trimesh": (None, None, JTerrain.from_heightfield(step, HS, VS, 0.0, 0.75).ground_channels,
                    Terrain.from_heightfield(step, HS, VS, 0.0, 0.75).ground_query, (1.0, 1.2)),
    }


def run_both(ground, anchored, params=None, seed=0):
    jh, th, jq, tq, center = grounds()[ground]
    c = points(seed, center)
    if ground == "slope":   # lift the points onto the slope
        c["pos"][..., 2] += SLOPE[0] * c["pos"][..., 0] + SLOPE[1] * c["pos"][..., 1]
    elif ground == "heightfield":
        c["pos"][..., 2] += np.asarray(jh(jnp.asarray(c["pos"][..., 0]), jnp.asarray(c["pos"][..., 1])))
    else:   # on the treads: 0, 0.1, 0.2 or 0.3 m
        x, y = c["pos"][..., 0], c["pos"][..., 1]
        c["pos"][..., 2] += 0.2 * (x >= 1.0) + 0.1 * (y >= 1.2)
    params = params or tc.ContactParams()
    jparams = jc.ContactParams(**{k: getattr(params, k) for k in params.__dataclass_fields__})
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    f = lambda pos, vel, fr, rs, an: jc.contact_forces(
        jparams, jh, pos, vel, j["radius"], fr, rs, DT, anchor=an if anchored else None, ground_query=jq)
    want = jax.vmap(f)(j["pos"], j["vel"], j["friction"], j["restitution"], j["anchor"])
    got = tc.contact_forces(params, th, t["pos"], t["vel"], t["radius"], t["friction"], t["restitution"], DT,
                            anchor=t["anchor"] if anchored else None, ground_query=tq)
    return c, want, got


def close(got, want, name, rel=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("ground", ["slope", "heightfield", "trimesh"])
@pytest.mark.parametrize("anchored", [True, False])
def test_contact_forces_match_jax(ground, anchored):
    c, want, got = run_both(ground, anchored)
    if anchored:
        close(got[0], want[0], "force")
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6, err_msg="anchor")
        want = want[0]
    else:
        close(got, want, "force")
    want = np.asarray(want)
    # both sides of the contact: some points pushed, some free
    assert (np.abs(want[..., 2]) > 0).sum() > N and (want == 0).all(-1).sum() > N


def test_trimesh_points_touch_the_walls():
    """The trimesh case's points include riser-wall contacts and centers
    inside a riser solid (tread force suppressed)."""
    c = points(0, (1.0, 1.2))
    _, _, _, tq, _ = grounds()["trimesh"]
    pos = torch.from_numpy(c["pos"])
    ch = tq(pos[..., 0], pos[..., 1])
    r = torch.from_numpy(c["radius"])
    active = torch.zeros(pos.shape[:2], dtype=torch.bool)
    for a in range(2):
        wp, top, sign = ch[..., 3 + 3 * a], ch[..., 4 + 3 * a], ch[..., 5 + 3 * a]
        active |= (sign != 0) & (sign * (pos[..., a] - wp) + r > 0) & (pos[..., 2] < top)
    assert int(active.sum()) > 0


def test_ground_normal_matches_jax():
    jh, th, *_ = grounds()["heightfield"]
    c = points(1, (3.2, 3.2))
    x, y = c["pos"][..., 0], c["pos"][..., 1]
    want = np.asarray(jc.ground_normal(jh, jnp.asarray(x), jnp.asarray(y)))
    got = tc.ground_normal(th, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_wall_forces_match_jax():
    """Planted walls per point and axis: none, in contact, holding the
    center, below the point (tests/test_torch_terrain_env's kinds)."""
    rng = np.random.RandomState(2)
    c = points(2)
    pos, r = c["pos"], c["radius"]
    kind = (np.arange(P)[None, :] + np.arange(N)[:, None]) % 4
    walls = []
    for ax in range(2):
        k = (kind + ax) % 4
        sign = np.where(k == 0, 0.0, np.where(k == 2, -1.0, 1.0))
        wpos = np.where(k == 1, pos[..., ax] + 0.5 * r, np.where(k == 2, pos[..., ax] + 0.01, pos[..., ax] - 0.01))
        top = np.where(k == 3, pos[..., 2] - 0.1, pos[..., 2] + 0.5)
        walls += [wpos, top, sign]
    walls = np.stack(walls, -1).astype(np.float32)
    d_n = (rng.rand(N, 1) * 50.0).astype(np.float32)
    jp = jc.ContactParams()
    want = jax.vmap(lambda p, v, w, d: jc.wall_forces(jp, p, v, jnp.asarray(r), w, d))(
        *(jnp.asarray(a) for a in (pos, c["vel"], walls, d_n[:, 0])))
    got = tc.wall_forces(tc.ContactParams(), *(torch.from_numpy(a) for a in (pos, c["vel"], r, walls, d_n)))
    close(got[0], want[0], "wall force")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.asarray(want[1]).any() and (np.abs(np.asarray(want[0])) > 0).any()


@pytest.fixture(scope="module")
def pairs():
    cfg, _ = torch_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = torch_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    return env


def test_self_collision_forces_match_jax(pairs):
    env = pairs
    pi, pj = env.self_pairs
    rng = np.random.RandomState(3)
    # every point within a few cm of a common cluster: many pairs overlap
    pos = (rng.randn(N, P, 3) * 0.05).astype(np.float32)
    vel = rng.randn(N, P, 3).astype(np.float32)
    r = env.model.point_radius.numpy()
    jp = jc.ContactParams()
    want = jax.vmap(lambda p, v: jc.self_collision_forces(jp, p, v, jnp.asarray(r), pi, pj, DT))(
        jnp.asarray(pos), jnp.asarray(vel))
    got = tc.self_collision_forces(env.contact_params, torch.from_numpy(pos), torch.from_numpy(vel),
                                   torch.from_numpy(r), pi, pj, DT)
    close(got, want, "self-collision")
    assert (np.abs(np.asarray(want)) > 0).any(-1).sum() > N
    assert torch.equal(tc.self_collision_forces(env.contact_params, torch.from_numpy(pos), torch.from_numpy(vel),
                                                torch.from_numpy(r), (), (), DT), torch.zeros(N, P, 3))


def test_body_wrenches_match_jax(pairs):
    m = pairs.model
    rng = np.random.RandomState(4)
    rel, force = (rng.randn(N, P, 3).astype(np.float32) for _ in range(2))
    want = jax.vmap(lambda a, b: jc.body_wrenches(m.num_bodies, m.point_body, a, b))(jnp.asarray(rel),
                                                                                    jnp.asarray(force))
    got = tc.body_wrenches(m.num_bodies, m.point_body, torch.from_numpy(rel), torch.from_numpy(force))
    close(got, want, "wrenches")
    # the wrenches sum to the total force and moment, and are the same bits on a second call
    np.testing.assert_allclose(got[..., 3:].sum(1).numpy(), force.sum(1), rtol=1e-5, atol=1e-4)
    again = tc.body_wrenches(m.num_bodies, m.point_body, torch.from_numpy(rel), torch.from_numpy(force))
    assert torch.equal(got, again)


def test_self_pair_audit_excludes_nothing(pairs):
    """tests/test_contact.py's audit: every cross-limb pair is visible to
    the self-collision model."""
    included, excluded = pairs.self_pair_report()
    assert len(included) == len(pairs.self_pairs[0]) >= 32 and excluded == []


def test_ball_holds_15deg_slope_with_stick_friction():
    params = tc.ContactParams()
    slope = float(np.tan(np.radians(15.0)))
    height_fn = lambda x, y: slope * x
    mass, radius = 1.0, 0.05
    pos = torch.tensor([[0.0, 0.0, radius - 0.001]])
    vel = torch.zeros(1, 3)
    anchor = pos.clone()
    g = torch.tensor([0.0, 0.0, -9.81])
    start = None
    for i in range(1500):   # 3 s
        f, anchor = tc.contact_forces(params, height_fn, pos, vel, torch.tensor([radius]), torch.tensor(0.8),
                                      torch.tensor(0.0), DT, anchor=anchor)
        vel = vel + (f / mass + g) * DT
        pos = pos + vel * DT
        if i == 250:   # after the settling transient
            start = pos.clone()
    drift = float(torch.linalg.vector_norm((pos - start)[0, :2]))
    assert drift < 1e-3, f"ball crept {drift * 1e3:.2f} mm down the slope"


def integrate_sphere(t, push_n, steps=1500, dt=0.002, r=0.05, m=1.0, x0=0.55, z0=None, mu=1.0):
    """tests/test_riser.py's point-mass sphere on the terrain, pushed +x
    with ``push_n`` newtons; returns the (x, z) trajectory."""
    params = tc.ContactParams(point_mass=m)
    pos = torch.tensor([[x0, 0.55, r if z0 is None else z0]])
    vel = torch.zeros(1, 3)
    anchor = pos.clone()
    acc0 = torch.tensor([push_n / m, 0.0, -9.81])
    xs, zs = [], []
    for _ in range(steps):
        f, anchor = tc.contact_forces(params, None, pos, vel, torch.full((1,), r), torch.tensor(mu),
                                      torch.tensor(0.0), dt, anchor=anchor, ground_query=t.ground_query)
        vel = vel + (f / m + acc0) * dt
        pos = pos + vel * dt
        xs.append(float(pos[0, 0]))
        zs.append(float(pos[0, 2]))
    return np.asarray(xs), np.asarray(zs)


def step_field(high_from=10, down=False):
    f = np.zeros((24, 24), np.int16)
    if down:
        f[:high_from, :] = int(round(0.2 / VS))
    else:
        f[high_from:, :] = int(round(0.2 / VS))
    return f


def test_sphere_pushed_into_step_stops():
    xs, zs = integrate_sphere(Terrain.from_heightfield(step_field(), HS, VS, 0.0, 0.75), push_n=40.0)
    assert xs[-1] < 10 * HS - 0.05 + 0.02 and np.max(xs) < 10 * HS - 0.05 + 0.02
    assert np.max(zs) < 0.12


def test_sphere_wedges_up_ramp_without_riser_correction():
    xs_r, zs_r = integrate_sphere(Terrain.from_heightfield(step_field(), HS, VS, 0.0, None), push_n=300.0)
    assert np.max(zs_r) > 0.08
    xs_w, zs_w = integrate_sphere(Terrain.from_heightfield(step_field(), HS, VS, 0.0, 0.75), push_n=300.0)
    assert np.max(zs_w) < 0.07 and xs_w[-1] < 10 * HS - 0.05 + 0.04


def test_walking_down_step_lands_on_low_tread():
    t = Terrain.from_heightfield(step_field(down=True), HS, VS, 0.0, 0.75)
    xs, zs = integrate_sphere(t, push_n=10.0, x0=0.75, z0=0.25, steps=2000)
    assert xs[-1] > 10 * HS + 0.2 and abs(zs[-1] - 0.05) < 0.02


@pytest.mark.parametrize("anchored", [True, False])
def test_gradients_finite_at_rest_and_in_the_air(anchored):
    """float64: a point resting on the plane (zero tangential velocity, its
    anchor where it is) and a point in the air; d force / d (pos, vel) is
    finite for both."""
    pos = torch.tensor([[[0.0, 0.0, 0.049], [0.3, 0.0, 0.5]]], dtype=torch.float64, requires_grad=True)
    vel = torch.zeros(1, 2, 3, dtype=torch.float64, requires_grad=True)
    anchor = pos.detach().clone() if anchored else None
    out = tc.contact_forces(tc.ContactParams(), lambda x, y: torch.zeros_like(x), pos, vel,
                            torch.tensor([0.05, 0.05], dtype=torch.float64), torch.ones(1, dtype=torch.float64),
                            torch.zeros(1, dtype=torch.float64), DT, anchor=anchor)
    force = out[0] if anchored else out
    assert float(force[0, 0, 2].detach()) > 0 and float(force[0, 1].detach().abs().sum()) == 0.0
    gp, gv = torch.autograd.grad(force.sum() + (out[1].sum() if anchored else 0.0), [pos, vel])
    assert bool(torch.isfinite(gp).all()) and bool(torch.isfinite(gv).all())
