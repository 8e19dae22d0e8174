"""Port parity for the terrain path and heading commands: the lane program's
terrain modes and the env's post stage outside K1, against the JAX package
on the CPU.

1. The lane program (K1's plain version) in ``local_plane`` and
   ``local_plane_walls`` against ``wiki_grx_gym_tpu/sim/scalarized.py`` in
   lanes mode: one substep (``ScalarSubstep.substep``) and a whole policy
   step without the post fold (``ScalarDecimation.run`` with ``post=None``
   through the JAX ``PallasDecimation(lanes=True)`` and the port's
   ``CudaDecimation.plain``, the final-state ``point_pos`` included), 8
   reachable GR1T1 states with planted ground lanes
   (``cuda_step.planted_planes``): tread planes in contact, and riser walls
   in contact, holding a point's center (tread force suppressed), and below
   a point.
2. The env, GR1T1 at 4 envs and decimation 2, JAX with
   ``use_pallas="lanes"`` against the port's env, both from the same
   converted JAX ``EnvState``, 3 policy steps with the same actions and the
   same per-step uniform block U (tests/test_torch_env.py's scheme), in
   three configurations: heightfield and trimesh terrain (a 3 x 3
   curriculum grid, ``refresh_interval`` 2: step 0 refreshes the measured
   heights and the planes, step 1 carries them, step 2 refreshes again),
   and the plane with ``heading_command=True`` (4 commands). Env 0 times out
   at step 0, 4.5 m from its origin on level 0 (the curriculum moves it up
   a level), and env 1 at step 1 (a carry step: its plane becomes the flat
   spawn plane).

The JAX steps run eagerly (``jax.disable_jit()``, as tests/test_terrain.py's
refresh test does): XLA on the CPU takes longer to compile the terrain step
than the eager run takes; ``init_state`` runs under jit. Tolerances are tests/test_torch_env.py's: rtol
1e-4, atol 1e-5, widened by 3x the port's float32 noise floor at that step
(the port run in float64 from the same state); counters, levels and
booleans exact. The substep check holds the state to rtol/atol 1e-5 and the
point forces to atol 1e-4 N (tests/test_torch_decimation.py's), widened
the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_env import (PHYS, RAND, as_float64, assert_close_widened, jax_state_to_numpy,
                            step_block)
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.sim.engine import BodyRandomization as JRand
from wiki_grx_gym_tpu.sim.engine import PhysicsState as JPhys
from wiki_grx_gym_tpu.sim.scalarized import ScalarSubstep as JaxSubstep
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.sim.engine import BodyRandomization, PhysicsState
from wiki_grx_gym_tpu_torch.sim.scalarized import ScalarSubstep

N, STEPS, DECIMATION = 4, 3, 2
N_LANES = 8
CONFIGS = ("heightfield", "trimesh", "heading")


def configure(cfg, which, n):
    cfg.env.num_envs = n
    cfg.control.decimation = DECIMATION
    if which == "heading":
        cuda_step.heading_config(cfg)
    else:
        cuda_step.terrain_config(which, 3, 3)(cfg)
        assert cfg.terrain.refresh_interval == 2
    return cfg


def make_envs(which, n=N):
    jc, _ = jax_registry.get_cfgs("GR1T1")
    configure(jc, which, n).sim.use_pallas = "lanes"
    tc, _ = torch_registry.get_cfgs("GR1T1")
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=configure(tc, which, n), device="cpu")
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=jc)
    assert not jenv._post_fold and not tenv._post_fold
    return jenv, tenv


def state_to_numpy(s):
    """``jax_state_to_numpy`` with the terrain fields that the state holds."""
    d = jax_state_to_numpy(s)
    for k in ("ground_plane", "measured_cache"):
        if getattr(s, k) is not None:
            d[k] = np.asarray(getattr(s, k))
    return d


# ---------------------------------------------------------------------------
# 1. the lane program's terrain modes
# ---------------------------------------------------------------------------

def lane_case(mode):
    """(JAX env, port env, port state with planted lanes) for ``mode``."""
    which = "trimesh" if mode == "local_plane_walls" else "heightfield"
    jenv, tenv = make_envs(which, N_LANES)
    assert tenv.terrain_mode == jenv._pallas_decimation.deci.sub.terrain_mode == mode
    g = torch.Generator().manual_seed(0)
    s = tenv.init_state(g)
    for _ in range(4):
        s, _ = tenv.step(s, 0.3 * torch.randn(N_LANES, tenv.num_actions, generator=g))
    return jenv, tenv, s.replace(ground_plane=cuda_step.planted_planes(tenv, s, mode == "local_plane_walls"))


@pytest.fixture(scope="module", params=["local_plane", "local_plane_walls"])
def lanes(request):
    return request.param, lane_case(request.param)


def _lanes_of(phys, rand, plane):
    col = lambda a: [a[..., i] for i in range(a.shape[-1])]
    return {
        "pos": col(phys["base_pos"]), "quat": col(phys["base_quat"]),
        "lin": col(phys["base_lin_vel"]), "ang": col(phys["base_ang_vel"]),
        "q": col(phys["q"]), "qd": col(phys["qd"]),
        "anchor": [col(phys["anchor"][:, p]) for p in range(phys["anchor"].shape[1])],
        "friction": rand["friction"], "restitution": rand["restitution"],
        "mass_scale": rand["base_mass_scale"], "com_offset": col(rand["base_com_offset"]),
        "plane": [col(plane[:, p]) for p in range(plane.shape[1])],
    }


def test_substep_matches_in_terrain_mode(lanes):
    mode, (jenv, tenv, s) = lanes
    phys = {k: getattr(s.physics, k).numpy() for k in PHYS}
    rand = {k: getattr(s.rand, k).numpy() for k in RAND}
    plane = s.ground_plane.numpy()
    rng = np.random.RandomState(1)
    tau = (rng.randn(N_LANES, 10) * 20.0).astype(np.float32)
    damp = (tenv.d_gains[None, :] * s.motor_strength.numpy()).astype(np.float32)
    jsub = JaxSubstep(jenv.model, jenv.contact_params, jenv.sim_dt, jenv.self_pairs, terrain_mode=mode)
    tsub = ScalarSubstep(tenv.model, tenv.contact_params, tenv.sim_dt, tenv.self_pairs, terrain_mode=mode)
    with jax.disable_jit():
        jl = jax.tree_util.tree_map(jnp.asarray, _lanes_of(phys, rand, plane))
        jst, jaux = jsub.substep(jl, [jnp.asarray(tau[:, i]) for i in range(10)],
                                 [jnp.asarray(damp[:, i]) for i in range(10)])
    outs = {}
    for dt in (torch.float32, torch.float64):
        tl = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(dt),
                                    _lanes_of(phys, rand, plane))
        outs[dt] = tsub.substep(tl, [torch.from_numpy(tau[:, i]).to(dt) for i in range(10)],
                                [torch.from_numpy(damp[:, i]).to(dt) for i in range(10)])
    stack = lambda ls: np.stack([np.broadcast_to(np.asarray(x), (N_LANES,)) for x in ls], -1)
    for key in ("pos", "quat", "lin", "ang", "q", "qd"):
        assert_close_widened(stack(outs[torch.float32][0][key]), stack(jst[key]),
                             stack(outs[torch.float64][0][key]), rtol=1e-5, atol=1e-5, err_msg=key)
    flat = lambda st, k: np.stack([stack(a) for a in st[k]], 1)
    assert_close_widened(flat(outs[torch.float32][0], "anchor"), flat(jst, "anchor"),
                         flat(outs[torch.float64][0], "anchor"), rtol=1e-5, atol=1e-5, err_msg="anchor")
    pf = lambda aux: np.stack([stack(f) for f in aux["point_force"]], 1)
    got, want = pf(outs[torch.float32][1]), pf(jaux)
    assert_close_widened(got, want, pf(outs[torch.float64][1]), rtol=1e-5, atol=1e-4, err_msg="point_force")
    # every branch ran: treads in contact; walls pushing; treads suppressed
    assert (np.abs(want[..., 2]) > 0).sum() > N_LANES
    if mode == "local_plane_walls":
        active, inside = cuda_step.wall_contacts(tenv, s, s.ground_plane)
        assert int(active.sum()) > N_LANES and int(inside.sum()) > N_LANES


def test_policy_step_without_fold_matches(lanes):
    """``run`` with ``post=None`` in the terrain mode: state, feet sums,
    torques, point forces, the post bodies' FK and the final-state point
    positions, through JAX's lanes wrapper and the port's plain wrapper."""
    mode, (jenv, tenv, s) = lanes
    pall, op = jenv._pallas_decimation, tenv.decimation_op
    assert pall.post is None and op.post is None and op.plane_lanes == pall.plane_lanes
    g = torch.Generator().manual_seed(2)
    args, kw = cuda_step.decimation_inputs(tenv, s, g)
    g.manual_seed(2)
    args64, kw64 = cuda_step.decimation_inputs(tenv, s, g, dtype=torch.float64)
    assert kw["extra"] is None and kw["plane"] is not None
    got, got64 = op(*args, **kw), op(*args64, **kw64)
    j = lambda t: jnp.asarray(t.numpy())
    phys, actions, last_actions, motor, delay, rand = args
    with jax.disable_jit():
        want = pall(JPhys(**{k: j(getattr(phys, k)) for k in PHYS}), j(actions), j(last_actions),
                    j(motor), j(delay), JRand(**{k: j(getattr(rand, k)) for k in RAND}),
                    last_qd=j(kw["last_qd"]), plane=j(kw["plane"]))
    names = ["force_sum", "vxyz_sum", "vrpy_sum", "tau", "point_force"]
    for i, name in enumerate(names, start=1):
        atol = 1e-4 if name in ("force_sum", "point_force") else 1e-5
        assert_close_widened(got[i].numpy(), np.asarray(want[i]), got64[i].numpy(), atol=atol, err_msg=name)
    for k in PHYS:
        assert_close_widened(getattr(got[0], k).numpy(), np.asarray(getattr(want[0], k)),
                             getattr(got64[0], k).numpy(), err_msg=k)
    for i in range(2):
        assert_close_widened(got[6][i].numpy(), np.asarray(want[6][i]), got64[6][i].numpy(),
                             err_msg="post_kin")
    assert got[7].shape == (N_LANES, 29, 3) and got[8] is None and want[8] is None
    assert_close_widened(got[7].numpy(), np.asarray(want[7]), got64[7].numpy(), err_msg="point_pos")


# ---------------------------------------------------------------------------
# 2. the env
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=CONFIGS)
def trajectories(request):
    """(config, [(JAX state, JAX out)], [(port state, port out)], [(port
    float64 state, port float64 out)]) after each of the STEPS steps."""
    which = request.param
    jenv, tenv = make_envs(which)
    rng = np.random.RandomState(0)
    jout, tout, tout64 = [], [], []
    # init under jit (its cached host constants made first, outside the trace)
    jenv._default_point_rel
    if jenv.terrain is not None:
        jenv.terrain._block_pyramid
    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    with jax.disable_jit():
        # env 0 times out at step 0, 4.5 m from its origin on level 0 (it
        # moves up a level); env 1 times out at step 1
        ml = jenv.max_episode_length
        org = np.asarray(js.env_origins).copy()
        org[0, :2] = np.asarray(js.physics.base_pos)[0, :2] - [4.5, 0.0]
        js = js.replace(
            episode_length=jnp.asarray([ml, ml - 1, 3, 7], jnp.int32),
            env_origins=jnp.asarray(org),
            terrain_levels=js.terrain_levels.at[0].set(0),
        )
        ts = env_state_from_numpy(state_to_numpy(js))
        ts64 = env_state_from_numpy(as_float64(state_to_numpy(js)))
        for _ in range(STEPS):
            a = (rng.randn(N, jenv.num_actions) * 0.5).astype(np.float32)
            u = step_block(jenv, js)
            js, jo = jenv.step(js, jnp.asarray(a))
            ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
            ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
            jout.append((state_to_numpy(js), jax.device_get(jo)))
            tout.append((ts, to))
            tout64.append((ts64, to64))
    return which, jout, tout, tout64


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("field", ["obs", "pri_obs", "rew"])
def test_outputs_match(trajectories, t, field):
    which, *tr = trajectories
    (_, jo), (_, to), (_, to64) = (x[t] for x in tr)
    assert getattr(to, field).shape == np.asarray(getattr(jo, field)).shape
    assert_close_widened(getattr(to, field).numpy(), np.asarray(getattr(jo, field)),
                         getattr(to64, field).numpy(), err_msg=f"{which} {field} step {t}")


def test_resets_and_curriculum_match(trajectories):
    which, jout, tout, _ = trajectories
    for t in range(STEPS):
        (js, jo), (ts, to) = jout[t], tout[t]
        np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset))
        np.testing.assert_array_equal(to.extras["time_outs"].numpy(), np.asarray(jo.extras["time_outs"]))
        for k in ("terrain_levels", "terrain_types", "episode_length", "common_step"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), js[k], err_msg=f"{which} {k} step {t}")
    resets = [np.asarray(jo.reset) for _, jo in jout]
    assert resets[0][0] and resets[1][1]   # the planted timeouts
    if which != "heading":
        assert jout[0][0]["terrain_levels"][0] == 1   # up a level
        assert "terrain_level" in tout[-1][1].extras["episode"]


@pytest.mark.parametrize("field", [
    "feet_air_time", "feet_land_time", "episode_sums", "commands", "actions", "last_actions",
    "last_dof_vel", "torques", "feet_contact_last", "env_origins",
])
def test_env_state_matches(trajectories, field):
    which, jout, tout, tout64 = trajectories
    for t in range(STEPS):
        js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
        got, want = getattr(ts, field).numpy(), js[field]
        if got.dtype == np.bool_:
            np.testing.assert_array_equal(got, want, err_msg=f"{which} {field} step {t}")
        else:
            assert_close_widened(got, want, getattr(ts64, field).numpy(), err_msg=f"{which} {field} step {t}")


@pytest.mark.parametrize("field", PHYS)
def test_physics_state_matches(trajectories, field):
    which, jout, tout, tout64 = trajectories
    for t in range(STEPS):
        js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
        assert_close_widened(getattr(ts.physics, field).numpy(), js["physics"][field],
                             getattr(ts64.physics, field).numpy(), err_msg=f"{which} {field} step {t}")


def test_ground_planes_and_measured_heights_match(trajectories):
    """The planes refreshed (steps 0 and 2) and carried (step 1: equal to
    step 0's but for the flat spawn plane of the env reset there), and the
    measured heights, refreshed and carried in the same phase, equal to
    JAX's at every step."""
    which, jout, tout, tout64 = trajectories
    if which == "heading":
        assert all(ts.ground_plane is None and ts.measured_cache is None for ts, _ in tout)
        return
    for t in range(STEPS):
        js, ts, ts64 = jout[t][0], tout[t][0], tout64[t][0]
        for k in ("ground_plane", "measured_cache"):
            assert_close_widened(getattr(ts, k).numpy(), js[k], getattr(ts64, k).numpy(),
                                 err_msg=f"{which} {k} step {t}")
    g = [ts.ground_plane for ts, _ in tout]
    reset1 = tout[1][1].reset
    assert reset1[1] and torch.equal(g[1][~reset1], g[0][~reset1])
    assert torch.all(g[1][1, :, 0] == tout[1][0].env_origins[1, 2]) and torch.all(g[1][1, :, 1:] == 0)
    m = [ts.measured_cache for ts, _ in tout]
    assert torch.equal(m[1], m[0]) and float(m[0].abs().max()) > 0


def test_trajectory_exercises_terrain(trajectories):
    which, _, tout, _ = trajectories
    assert all(torch.isfinite(to.obs).all() and torch.isfinite(to.rew).all() for _, to in tout)
    if which == "heading":
        cmds = tout[-1][0].commands
        assert cmds.shape[1] == 4 and float(cmds[:, 2].abs().max()) > 0
