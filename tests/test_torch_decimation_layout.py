"""The team kernel's schedule (``sim/cuda_step.team_lists``), on the CPU.

K1's team kernel (``csrc/decimation.cu:decimation_team_kernel``) runs one
env on a team of lanes. Where the one-thread kernel sums in a serial loop,
the team kernel sums through lists that the wrapper builds on the host: per
contact point its self-collision pairs, with their signs; per body its
contact points; the bodies by depth in the tree; each dof's ancestors. Each
list must keep the serial loop's order, or a sum rounds differently and the
team kernel is no longer bit-identical to the one-thread kernel (which
``chip_smoke.py`` and ``tests/test_torch_decimation_cuda.py`` check on the
card). Here, for the GR1T1 lower limb:

- each list is in ascending order and covers each pair endpoint, each
  point and each body exactly once; the constant struct has no padding;
- a float32 replay of the pair-force accumulation and of the body wrenches
  through those lists, on seeded random states, equals the serial loops of
  ``ScalarSubstep.contact_forces`` and of the substep's wrench pass bit for
  bit. The point radii are enlarged so that every self-collision pair is in
  contact and each point sums 8 nonzero pair forces."""

import copy
import ctypes

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.sim import scalarized as sc

N = 64


@pytest.fixture(scope="module")
def sub():
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    return env.decimation_op.deci.sub


@pytest.fixture(scope="module")
def lists(sub):
    return cuda_step.team_lists(sub)


def groups(start, flat):
    return [list(flat[start[k]:start[k + 1]]) for k in range(len(start) - 1)]


def test_pair_lists_ascending_and_cover_each_endpoint_once(sub, lists):
    per_point = groups(lists["pt_pair_start"], lists["pt_pair"])
    assert len(per_point) == sub.np_
    seen = []
    for p, codes in enumerate(per_point):
        assert codes == sorted(codes), f"point {p}: pairs not in ascending order"
        for code in codes:
            s, is_j = code >> 1, code & 1
            assert sub.self_pairs[s][is_j] == p
            seen.append((s, is_j))
    assert sorted(seen) == [(s, e) for s in range(len(sub.self_pairs)) for e in (0, 1)]


def test_body_lists_ascending_and_cover_each_point_once(sub, lists):
    per_body = groups(lists["body_pt_start"], lists["body_pts"])
    assert len(per_body) == sub.nb
    for b, pts in enumerate(per_body):
        assert pts == sorted(pts), f"body {b}: points not in ascending order"
        assert all(sub.point_body[p] == b for p in pts)
    assert sorted(p for pts in per_body for p in pts) == list(range(sub.np_))


def test_levels_put_each_parent_first_and_cover_each_body_once(sub, lists):
    n = lists["n_levels"]
    levels = groups(lists["level_start"][:n + 1], lists["level_body"])
    assert sorted(b for lv in levels for b in lv) == list(range(1, sub.nb))
    done = {0}
    for lv in levels:
        assert lv == sorted(lv)
        assert all(sub.parent[b] in done for b in lv)
        done.update(lv)


def test_ancestor_masks_match_the_substep(sub, lists):
    for i in range(sub.nd):
        for j in range(sub.nd):
            assert bool((lists["anc_mask"][i] >> j) & 1) == bool(sub.ancestor[i][j])


def test_constant_struct_has_no_padding_and_holds_the_lists(sub, lists):
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    op = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")[0].decimation_op
    struct = cuda_step.const_struct(op.sizes)
    assert ctypes.sizeof(struct) == sum(ctypes.sizeof(t) for _, t in struct._fields_)
    k = cuda_step._make_constants(op.deci, op.in_off, op.out_off, op.c_in, op.c_out)
    assert k.n_levels == lists["n_levels"]
    for name, values in lists.items():
        if name != "n_levels":
            assert list(getattr(k, name))[:len(values)] == values, name


def random_state(sub, seed):
    """Seeded random lanes of a substep's state (numpy -> float32 torch)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    quat = rng.randn(4, N)
    quat /= np.linalg.norm(quat, axis=0)
    return {
        "pos": [t(rng.uniform(-0.05, 0.05, N)) for _ in range(2)] + [t(rng.uniform(0.7, 0.95, N))],
        "quat": [t(c) for c in quat],
        "lin": [t(rng.randn(N) * 0.5) for _ in range(3)],
        "ang": [t(rng.randn(N) * 0.5) for _ in range(3)],
        "q": [t(rng.randn(N) * 0.3) for _ in range(sub.nd)],
        "qd": [t(rng.randn(N)) for _ in range(sub.nd)],
        "anchor": [[t(rng.randn(N) * 0.1) for _ in range(3)] for _ in range(sub.np_)],
        "friction": t(rng.uniform(0.5, 1.5, N)),
        "restitution": t(rng.uniform(0.0, 0.5, N)),
    }


@pytest.fixture(scope="module", params=[0, 1, 2])
def contact_case(request, sub):
    """(substep with enlarged radii, state, FK, serial forces, positions)."""
    big = copy.copy(sub)
    big.point_radius = np.full_like(sub.point_radius, 1.0)
    state = random_state(big, request.param)
    quats, pos_rel, _, twists = big.fk(state)
    pts_pos, forces, _ = big.contact_forces(state, quats, pos_rel, twists)
    return big, state, (quats, pos_rel, twists), pts_pos, forces


def test_every_pair_is_in_contact(contact_case):
    big, state, (quats, pos_rel, twists), pts_pos, _ = contact_case
    for i, j in big.self_pairs:
        d = sc._sub(pts_pos[i], pts_pos[j])
        dist = torch.sqrt(sc._maximum(sc._dot(d, d), 0.0))
        assert bool(((float(big.point_radius[i]) + float(big.point_radius[j])) - dist > 0.0).all())


def test_pair_forces_through_the_lists_equal_the_serial_loop(contact_case, lists):
    """Ground forces from a copy without pairs, each pair's n f (the serial
    loop's expressions), then per point its list in order: bit for bit."""
    big, state, (quats, pos_rel, twists), pts_pos, want = contact_case
    c = big.contact
    no_pairs = copy.copy(big)
    no_pairs.self_pairs = ()
    _, forces, _ = no_pairs.contact_forces(state, quats, pos_rel, twists)
    pts_vel = []
    for p in range(big.np_):
        b = big.point_body[p]
        rel = sc._add(pos_rel[b], sc._qapply(quats[b], [float(x) for x in big.point_offset[p]]))
        pts_vel.append(sc._add(twists[b][3:], sc._cross(twists[b][:3], rel)))
    imp_cap = c.point_mass / big.dt
    d_ns = min(2.0 * c.damping_ratio * np.sqrt(c.self_collision_stiffness * c.point_mass), imp_cap)
    nf = []
    for i, j in big.self_pairs:
        d = sc._sub(pts_pos[i], pts_pos[j])
        dist = torch.sqrt(sc._maximum(sc._dot(d, d), 0.0))
        n = sc._scale(d, 1.0 / sc._maximum(dist, 1e-6))
        pen = (float(big.point_radius[i]) + float(big.point_radius[j])) - dist
        v_n = sc._dot(sc._sub(pts_vel[i], pts_vel[j]), n)
        f_mag = sc._maximum(c.self_collision_stiffness * sc._minimum(pen, 0.1) - d_ns * v_n, 0.0)
        f_mag = torch.where(pen > 0.0, f_mag, 0.0)
        nf.append(sc._scale(n, f_mag))
    for p, codes in enumerate(groups(lists["pt_pair_start"], lists["pt_pair"])):
        f = list(forces[p])
        for code in codes:
            term = nf[code >> 1]
            f = sc._sub(f, term) if code & 1 else sc._add(f, term)
        for k in range(3):
            assert torch.equal(f[k], want[p][k]), f"point {p} component {k}"


def test_body_wrenches_through_the_lists_equal_the_serial_loop(contact_case, lists):
    """The substep's serial wrench pass (over points in index order) against
    each body summing its own list in order: bit for bit."""
    big, state, _, pts_pos, forces = contact_case
    ext_ang = [[0.0, 0.0, 0.0] for _ in range(big.nb)]
    ext_lin = [[0.0, 0.0, 0.0] for _ in range(big.nb)]
    for p in range(big.np_):
        b = big.point_body[p]
        rel = sc._sub(pts_pos[p], state["pos"])
        ext_ang[b] = sc._add(ext_ang[b], sc._cross(rel, forces[p]))
        ext_lin[b] = sc._add(ext_lin[b], forces[p])
    for b, pts in enumerate(groups(lists["body_pt_start"], lists["body_pts"])):
        ea = [torch.zeros(N), torch.zeros(N), torch.zeros(N)]
        el = [torch.zeros(N), torch.zeros(N), torch.zeros(N)]
        for p in pts:
            rel = sc._sub(pts_pos[p], state["pos"])
            ea = sc._add(ea, sc._cross(rel, forces[p]))
            el = sc._add(el, forces[p])
        for k in range(3):
            want_a = torch.broadcast_to(torch.as_tensor(ext_ang[b][k], dtype=torch.float32), (N,))
            want_l = torch.broadcast_to(torch.as_tensor(ext_lin[b][k], dtype=torch.float32), (N,))
            assert torch.equal(ea[k], want_a), f"body {b} torque {k}"
            assert torch.equal(el[k], want_l), f"body {b} force {k}"
