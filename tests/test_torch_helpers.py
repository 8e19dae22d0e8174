"""Port parity for the engine's helpers and the public helpers of ROADMAP
queue 1 item 18, against the JAX package on the same inputs (numpy, from a
seed), on the CPU:

- ``utils/maths``: ``skew``, ``mat3_vec``, ``mat3_mul``, ``mat3_sandwich``,
  ``outer3``, ``rotmat_to_quat``, ``tensor_clamp`` and
  ``rand_sqrt_uniform`` (its shaping of the same U[-1, 1) draws);
- ``sim/spatial``: every function;
- ``RobotModel.ancestors`` and ``link_point_mask`` on both GR1T1 models;
- ``LeggedEnv.self_pair_report`` (tests/test_contact.py's audit);
- ``Terrain.from_heightfield`` and the engine's whole-field lookups
  (``height_fn``, ``measured_heights``, ``ground_query``) against JAX's
  ``height_fn``, ``measured_heights`` and ``ground_channels``.

Tolerances: rtol 1e-5 / atol 1e-6 for the float functions (the same
formulas in the same order; XLA and PyTorch may still round a sum of three
products differently in the last bit), 1e-5 m for the lookups, exact for
the integer taps, tables and masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.models.serialize import load_robot as jax_load
from wiki_grx_gym_tpu.sim import spatial as js
from wiki_grx_gym_tpu.terrain.composer import Terrain as JTerrain
from wiki_grx_gym_tpu.utils import maths as jm
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.models.serialize import RESOURCES, load_robot
from wiki_grx_gym_tpu_torch.sim import spatial as ts
from wiki_grx_gym_tpu_torch.terrain.composer import Terrain
from wiki_grx_gym_tpu_torch.utils import maths as tm

TOL = dict(rtol=1e-5, atol=1e-6)


def _rot(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jm.quat_to_rotmat(jnp.asarray(q)))


def _call(fn_j, fn_t, *args):
    j = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    t = fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("name", ["skew", "mat3_vec", "mat3_mul", "mat3_sandwich", "outer3",
                                  "rotmat_to_quat", "tensor_clamp"])
def test_maths_matches_jax(name):
    rng = np.random.RandomState(0)
    n = 64
    v, w = rng.randn(n, 3).astype(np.float32), rng.randn(n, 3).astype(np.float32)
    a, b = rng.randn(n, 3, 3).astype(np.float32), rng.randn(n, 3, 3).astype(np.float32)
    r = _rot(rng, n)
    # rotations with every branch of the Shepperd blend: trace > 0 and each
    # diagonal entry the largest
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]).astype(np.float32)
    r = np.concatenate([r, flips, flips @ r[:3]])
    args = {"skew": (v,), "mat3_vec": (a, v), "mat3_mul": (a, b), "mat3_sandwich": (r[:n], a),
            "outer3": (v, w), "rotmat_to_quat": (r,), "tensor_clamp": (a, b[:, :1] - 1.0, b[:, :1] + 1.0)}[name]
    j, t = _call(getattr(jm, name), getattr(tm, name), *args)
    np.testing.assert_allclose(t, j, **TOL)
    if name == "rotmat_to_quat":   # a rotation and its quaternion
        np.testing.assert_allclose(tm.quat_to_rotmat(torch.from_numpy(t)).numpy(), r, atol=1e-5)


def test_rand_sqrt_uniform_shapes_the_same_draws():
    """JAX's ``rand_sqrt_uniform`` draws U[-1, 1) from its key; the port's
    shaping of the same draws gives the same samples, and its own sampler
    stays in [lo, hi) with the shape's CDF ((sqrt-shaped) mass at the
    ends)."""
    key = jax.random.PRNGKey(3)
    lo, hi, shape = -0.3, 0.7, (4096,)
    want = np.asarray(jm.rand_sqrt_uniform(key, lo, hi, shape))
    r = np.array(jax.random.uniform(key, shape, minval=-1.0, maxval=1.0, dtype=jnp.float32))
    got = tm.sqrt_uniform_shape(torch.from_numpy(r), lo, hi).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    s = tm.rand_sqrt_uniform(torch.Generator().manual_seed(0), lo, hi, (20000,)).numpy()
    assert s.dtype == np.float32 and lo <= s.min() and s.max() < hi
    # P(s < mid) = 1/2, and P(|s - mid| > (hi - lo) / 4) = 3/4 for the sqrt shape
    mid = 0.5 * (lo + hi)
    assert abs(np.mean(s < mid) - 0.5) < 0.02
    assert abs(np.mean(np.abs(s - mid) > (hi - lo) / 4) - 0.75) < 0.02


@pytest.mark.parametrize("name", ["motion_cross", "force_cross", "spatial_inertia", "wrench_at",
                                  "revolute_subspace", "twist_kinetic_energy"])
def test_spatial_matches_jax(name):
    rng = np.random.RandomState(1)
    n = 32
    a6, b6 = rng.randn(n, 6).astype(np.float32), rng.randn(n, 6).astype(np.float32)
    p, f, tq = (rng.randn(n, 3).astype(np.float32) for _ in range(3))
    mass = (0.5 + rng.rand(n)).astype(np.float32)
    ic = rng.randn(n, 3, 3).astype(np.float32)
    ic = ic @ ic.transpose(0, 2, 1)
    i6 = np.array(js.spatial_inertia(jnp.asarray(mass), jnp.asarray(p), jnp.asarray(ic)))
    args = {"motion_cross": (a6, b6), "force_cross": (a6, b6), "spatial_inertia": (mass, p, ic),
            "wrench_at": (p, f, tq), "revolute_subspace": (f, p), "twist_kinetic_energy": (i6, a6)}[name]
    j, t = _call(getattr(js, name), getattr(ts, name), *args)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    if name == "wrench_at":
        j2, t2 = _call(js.wrench_at, ts.wrench_at, p, f)
        np.testing.assert_allclose(t2, j2, **TOL)


@pytest.mark.parametrize("spec", ["gr1t1_lower_limb", "gr1t1"])
def test_ancestors_and_link_point_mask_match_jax(spec):
    tmod, jmod = load_robot(f"{RESOURCES}/{spec}.json"), jax_load(f"{RESOURCES}/{spec}.json")
    for b in range(tmod.num_bodies):
        assert tmod.ancestors(b) == jmod.ancestors(b)
    assert tmod.ancestors(0) == () and tmod.ancestors(tmod.num_bodies - 1)[-1] == tmod.num_bodies - 1
    feet = tmod.find_links("foot_roll")
    assert len(feet) == 2
    for links in (feet, feet[:1], tmod.link_names[:3]):
        got = tmod.link_point_mask(links, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmod.link_point_mask(links)))
    assert float(tmod.link_point_mask(feet).sum()) > 0


def test_self_pair_report_matches_jax():
    """tests/test_contact.py's audit on the port: every cross-limb pair is
    included (none lies inside the default-pose margin), the same lists and
    gaps as JAX's."""
    jc, _ = jax_registry.get_cfgs("GR1T1")
    jc.env.num_envs = 2
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tc.env.num_envs = 2
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=tc, device="cpu")
    inc, exc = tenv.self_pair_report()
    jinc, jexc = jenv.self_pair_report()
    assert len(inc) == len(tenv.self_pairs[0]) >= 32 and exc == [] == jexc
    assert [(a, b) for a, b, _ in inc] == [(a, b) for a, b, _ in jinc]
    np.testing.assert_allclose([g for *_, g in inc], [g for *_, g in jinc], rtol=1e-5, atol=1e-6)


VS, HS = 0.005, 0.1


def _fields():
    rng = np.random.RandomState(2)
    rough = rng.randint(-20, 60, (64, 64)).astype(np.int16)
    step = np.zeros((24, 24), np.int16)
    step[10:, :] = int(round(0.2 / VS))
    return {"rough": rough, "step": step}


@pytest.mark.parametrize("field", ["rough", "step"])
@pytest.mark.parametrize("border,threshold", [(0.0, 0.75), (0.5, None)])
def test_from_heightfield_lookups_match_jax(field, border, threshold):
    f = _fields()[field]
    t = Terrain.from_heightfield(f, HS, VS, border, threshold)
    j = JTerrain.from_heightfield(f, HS, VS, border, threshold)
    assert t.slope_threshold_raw == j.slope_threshold_raw and t.shape == f.shape
    assert (t.env_length, t.env_width) == (j.env_length, j.env_width)
    rng = np.random.RandomState(3)
    size = f.shape[0] * HS
    # points inside and beyond the field (the lookups clip to its edge)
    x = rng.uniform(-0.8, size + 0.8, (16, 37)).astype(np.float32)
    y = rng.uniform(-0.8, size + 0.8, (16, 37)).astype(np.float32)
    for tf, jf, atol in ((t.height_fn, j.height_fn, 1e-5), (t.measured_heights, j.measured_heights, 0.0),
                         (t.ground_query, j.ground_channels, 1e-5)):
        got = tf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(jf(jnp.asarray(x), jnp.asarray(y)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=tf.__name__)
    # float64 queries keep their dtype
    assert t.height_fn(torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)).dtype \
        == torch.float64


def test_riser_channels_on_a_step():
    """tests/test_riser.py's channel cases on the port's whole-field query:
    the flat region, the up riser (low tread extended, a +x wall at the
    grid line with the step's top, the back-edge face past it) and the down
    riser (a -x wall)."""
    f = _fields()["step"]
    t = Terrain.from_heightfield(f, HS, VS, 0.0, 0.75)
    q = lambda x, y: t.ground_query(torch.tensor([x]), torch.tensor([y]))[0]
    ch = q(0.35, 0.55)
    assert torch.allclose(ch[:3], torch.zeros(3), atol=1e-6) and ch[5] == 0.0 and ch[8] == 0.0
    x = 9.0 * HS + 0.07
    ch = q(x, 0.55)
    assert abs(float(ch[0] + ch[1] * x + ch[2] * 0.55)) < 1e-6 and abs(float(ch[1])) < 1e-6
    assert ch[5] == 1.0 and abs(float(ch[3]) - 10.0 * HS) < 1e-6 and abs(float(ch[4]) - 0.2) < 1e-6
    ch = q(10.5 * HS, 0.55)
    assert ch[5] == 1.0 and abs(float(ch[3]) - 10.0 * HS) < 1e-6
    assert abs(float(ch[0] + ch[1] * 10.5 * HS + ch[2] * 0.55) - 0.2) < 1e-6
    down = np.zeros((24, 24), np.int16)
    down[:10, :] = int(round(0.2 / VS))
    t = Terrain.from_heightfield(down, HS, VS, 0.0, 0.75)
    ch = t.ground_query(torch.tensor([9.0 * HS + 0.03]), torch.tensor([0.55]))[0]
    assert ch[5] == -1.0 and abs(float(ch[3]) - 9.0 * HS) < 1e-6 and abs(float(ch[4]) - 0.2) < 1e-6
