"""K1 built for other size sets than the GR1T1 lower limb's, on the card.

K1 is compiled once per program's sizes (``sim/cuda_step.py:nvcc_flags``).
Here two instantiations besides the main path's run on reachable states of
their training configs (the env a few steps after init with random
actions, 512 envs):

- ``GR1T1_full``: 33 bodies, 32 dofs, 240 self-collision pairs, its own
  team shape (``TEAM_SHAPE_FULL_BODY``);
- GR1T1 with self-collision off (``asset.self_collisions = 1``): no pairs,
  so every pair array of the kernel has capacity 1 and its loops run 0
  times;
- the programs without the post fold: GR1T1 on heightfield terrain
  (``local_plane``, the ground planes the env samples), on trimesh terrain
  (``local_plane_walls``, with ground lanes planted so that riser walls
  push, hold a point's center and pass below, ``cuda_step.planted_planes``)
  and on the plane with heading commands (3 x 3 curriculum grids);
- the all-terms fold: GR1T1 with every one of the 50 lane-form reward
  terms at a non-zero scale and contacts penalized on the thighs and shanks
  (``cuda_step.all_terms_config``; 4 groups), on states planted so that
  every term is non-zero somewhere (``cuda_step.planted_all_terms``);
- the control laws: GR1T1's fold with V and with T, and V with heading
  commands (no fold, ``last_qd`` still an input).

Each is held against its plain version (the lane program, the same
inputs) under chip_smoke.py phase 3's rule: rtol 1e-4 / atol 1e-4 (1e-2 N
on the contact forces), envs with a flipped boolean lane or a float lane
over that tolerance at most 0.1% of all (here: at most 1 of 512), and those
envs within the tolerance plus 3x the plain program's float32 noise floor
(its float32 result against float64); the all-terms and V/T programs
equal their plain versions in every output bit; the team kernel equals the
one-thread kernel in every output bit; the wrapper's call launches the team kernel
and counts one launch. The lane program's division by a Python float
(``scalarized._div``) rounds on the card as on the CPU.

Needs a CUDA card (the kernels have no CPU mode). Marked ``gpu``; elsewhere
each test skips. Beside the sets above, at the main path's size: the
full body's team kernel equals the one-thread kernel bit for bit at 1,
E - 1, E, E + 1, 4,097 and 8,192 envs (E its envs a block), and an SM
holds 16 of its envs (its working set shares the Cholesky factor with the
dynamics arrays, ``team_shared_ls``) and 32 of the lower limb's. On the
card, from the checkout's root:

    python -m pytest --noconftest -m gpu -q tests/test_torch_decimation_sizes_cuda.py
"""

import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.gpu

N = 512
RTOL, ATOL, ATOL_FORCE = 1e-4, 1e-4, 1e-2
FORCE_GROUPS = ("force_sum", "point_force")
BOOL_GROUPS = ("term_contact", "tilt", "bad", "feet_contact", "contact_filt", "first_contact")


def no_self_collision(cfg):
    cfg.asset.self_collisions = 1


SETS = {"GR1T1_full": dict(task="GR1T1_full"),
        "GR1T1_no_pairs": dict(task="GR1T1", mutate=no_self_collision),
        "GR1T1_heightfield": dict(task="GR1T1", mutate=cuda_step.terrain_config("heightfield", 3, 3)),
        "GR1T1_trimesh": dict(task="GR1T1", mutate=cuda_step.terrain_config("trimesh", 3, 3), planted=True),
        "GR1T1_heading": dict(task="GR1T1", mutate=cuda_step.heading_config),
        "GR1T1_all_terms": dict(task="GR1T1", mutate=cuda_step.all_terms_config, plant_terms=True),
        "GR1T1_V": dict(task="GR1T1", mutate=cuda_step.control_config("V")),
        "GR1T1_T": dict(task="GR1T1", mutate=cuda_step.control_config("T")),
        "GR1T1_V_heading": dict(task="GR1T1", mutate=cuda_step.control_config("V", cuda_step.heading_config))}
# this PR's programs: held to their plain versions bit for bit
EXACT = ("GR1T1_all_terms", "GR1T1_V", "GR1T1_T", "GR1T1_V_heading")


@pytest.fixture(scope="module", params=sorted(SETS))
def case(request):
    """(set name, decimation op, packed (C_in, N) input, the wrapper's
    arguments, its float64 arguments)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    dev = torch.device("cuda")
    how = dict(SETS[request.param])
    planted = how.pop("planted", False)
    plant_terms = how.pop("plant_terms", False)
    env, state = cuda_step.reachable_state(N, dev, **how)
    if planted:
        state = state.replace(ground_plane=cuda_step.planted_planes(env, state, env.riser_mode))
    if plant_terms:
        state = cuda_step.planted_all_terms(env, state)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    args, kw = cuda_step.decimation_inputs(env, state, gen)
    gen.manual_seed(1)
    args64, kw64 = cuda_step.decimation_inputs(env, state, gen, dtype=torch.float64)
    op = env.decimation_op
    comp = op._pack(*args, **kw)
    return request.param, op, comp, (args, kw), (args64, kw64)


def groups(res):
    g = {f: getattr(res[0], f) for f in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                                         "q", "qd", "anchor")}
    g.update(force_sum=res[1], vxyz_sum=res[2], vrpy_sum=res[3], tau=res[4], point_force=res[5],
             post_rel=res[6][0], post_quat=res[6][1])
    if res[7] is not None:
        g["point_pos"] = res[7]
    g.update(res[8] or {})
    return {k: v.double().reshape(v.shape[0], -1) for k, v in g.items()}


def run(op, comp, **how):
    out = torch.full((op.c_out, comp.shape[1]), -7.0, device=comp.device)
    op.launch_packed(comp.contiguous(), out, **how)
    torch.cuda.synchronize()
    return out


def test_sizes_are_the_set_s(case):
    name, op, _, _, _ = case
    if name == "GR1T1_full":
        assert (op.sizes.ND, op.sizes.NPAIR, op.c_out) == (32, 240, 374)
        assert op.team == cuda_step.TEAM_SHAPE_FULL_BODY
    elif name == "GR1T1_no_pairs":
        assert (op.sizes.ND, op.sizes.NPAIR) == (10, 0)
    elif name in EXACT:
        want = {"GR1T1_all_terms": (0, 1, 50, 4), "GR1T1_V": (1, 1, 24, 0), "GR1T1_T": (2, 1, 24, 0),
                "GR1T1_V_heading": (1, 0, 0, 0)}[name]
        assert (op.sizes.CTRL, op.sizes.FOLD, op.sizes.NR, op.sizes.NPEN) == want
    else:
        program = {"GR1T1_heightfield": (1, 3), "GR1T1_trimesh": (2, 9), "GR1T1_heading": (0, 0)}[name]
        assert (op.sizes.TERRAIN, op.plane_lanes, op.sizes.FOLD, op.post) == (*program, 0, None)
    assert op.kernel_support_error() is None


def test_kernel_within_tolerance_of_its_plain_version(case):
    _, op, _, (args, kw), (args64, kw64) = case
    k, p, p64 = groups(op(*args, **kw)), groups(op.plain(*args, **kw)), groups(op.plain(*args64, **kw64))
    flips = torch.zeros(N, dtype=torch.bool, device=args[1].device)
    for name in BOOL_GROUPS:
        if name in k:   # the post fold's
            flips |= (k[name] != p[name]).any(dim=1)
    keep, over = ~flips, torch.zeros_like(flips)
    for name in k:
        if name in BOOL_GROUPS:
            continue
        a, b, b64 = k[name], p[name], p64[name]
        assert torch.isfinite(a[keep]).all() and torch.isfinite(b[keep]).all(), name
        err = (a - b).abs()
        stated = (ATOL_FORCE if name in FORCE_GROUPS else ATOL) + RTOL * b.abs()
        floor = float((b - b64)[keep].abs().max())
        over |= (err > stated).any(dim=1) & keep
        assert bool((err[keep] <= stated[keep] + 3.0 * floor).all()), (
            f"{name}: max |kernel - plain| {float(err[keep].max()):.3e}, noise floor {floor:.3e}")
    assert int((flips | over).sum()) <= max(1, N // 1000)


def test_new_programs_equal_their_plain_version_bit_for_bit(case):
    """This PR's programs (the all-terms fold with penalized groups, V, T)
    round as their plain version does, op by op: every output bit equal
    (NaN lanes by bit pattern)."""
    name, op, _, (args, kw), _ = case
    if name not in EXACT:
        pytest.skip("held to the stated tolerance above")
    k, p = groups(op(*args, **kw)), groups(op.plain(*args, **kw))
    differ = {g: int((k[g].float().view(torch.int32) != p[g].float().view(torch.int32)).sum()) for g in k}
    assert not any(differ.values()), {g: d for g, d in differ.items() if d}


def test_team_kernel_equals_the_thread_kernel_bit_for_bit(case):
    _, op, comp, _, _ = case
    ref, got = run(op, comp, kernel="thread"), run(op, comp)
    assert int((got.view(torch.int32) != ref.view(torch.int32)).sum()) == 0


def test_wrapper_launches_the_team_kernel(case):
    _, op, comp, (args, kw), _ = case
    reset_launch_counts()
    res = op(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["k1"] == 1
    want = run(op, comp)
    off, cnt = op.out_off["qd"]
    assert torch.equal(res[0].qd.contiguous().view(torch.int32),
                       want[off:off + cnt].t().contiguous().view(torch.int32))


@pytest.mark.parametrize("c", [1e4, 10.0, 0.02, 0.0125])
def test_lane_division_rounds_as_on_the_cpu(c):
    """The lane program divides by a Python float through ``_div``: on the
    card it must round as the CPU's true division does (PyTorch on CUDA
    divides by a Python scalar as a multiplication by its reciprocal, which
    rounds differently in a large share of lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from wiki_grx_gym_tpu_torch.sim.scalarized import _div

    x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(0))
    want = (x / c).view(torch.int32)
    assert torch.equal(_div(x.cuda(), c).cpu().view(torch.int32), want)
    assert torch.equal(_div(x, c).view(torch.int32), want)


FULL_BODY_ENVS_PER_SM = 16   # 2 blocks of 32 x 8
LOWER_LIMB_ENVS_PER_SM = 32  # 4 blocks of 16 x 8


@pytest.fixture(scope="module")
def full_body_8192():
    """(decimation op, packed (C_in, 8192) input) of GR1T1_full."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    op, comp, _, _ = cuda_step.reachable_case(8192, torch.device("cuda"), task="GR1T1_full")
    return op, comp


def test_full_body_team_kernel_equals_the_thread_kernel_at_every_block_fill(full_body_8192):
    op, comp = full_body_8192
    e = op.team[1]
    differ = {n: int((run(op, comp[:, :n]).view(torch.int32)
                      != run(op, comp[:, :n], kernel="thread").view(torch.int32)).sum())
              for n in (1, e - 1, e, e + 1, 4097, 8192)}
    assert not any(differ.values()), differ


def test_envs_an_sm(full_body_8192):
    op, _ = full_body_8192
    occ = cuda_step.team_occupancy(op)
    assert occ["blocks_per_sm"] * occ["envs_per_block"] >= FULL_BODY_ENVS_PER_SM, occ
    lower = cuda_step.task_env("GR1T1", 8, torch.device("cuda")).decimation_op
    occ = cuda_step.team_occupancy(lower)
    assert occ["blocks_per_sm"] * occ["envs_per_block"] == LOWER_LIMB_ENVS_PER_SM, occ
