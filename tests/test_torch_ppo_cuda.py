"""K2 and K3 on the card against their plain versions, at small sizes and in
the cases the GR1T1 main path (and so ``chip_smoke.py``) does not reach: a
row count that leaves partial GEMM tiles, a fixed std, the unclipped value
loss, a NaN advantage (the NaN-loss path), the std floor at 0.3 (above the
0.2 init, so K3's projection acts from the first step) and hidden widths
that are no multiple of 8 (the bf16 chain pads their row stride). K2 in both
operand types: float32 (the SIMT chain) and bf16 (the tensor-core chain).
Also K2's tensor-core GEMM alone (``gemm_check``: the main path's kernel,
f32 output, no epilogue) against the float64 product of the same bf16
values at every GR1T1 main-path shape and at ragged row counts, and the
whole update against the composition of its one-step calls, bit for bit,
and K2's packed bf16 weights (``pack_params``) against their plain version
``pack_weights``, bit for bit. K3's fused step (``k3_step``, one cooperative
launch: the main path's) against PR 2's two-launch step (``k3_step_ref``,
its reference) bit for bit in p, m, v, g, the LR/metric slots, the partial
sums and the step record, at GR1T1's size and in the small cases (fixed
std, std floor, NaN loss). The update's CUDA graph: a second call with new
tensors at new addresses gives the bits of a fresh ``FusedPPOGrad``'s first
call on them (the graph re-reads its inputs), and a one-step copy made after
a whole-update graph exists runs one step of its own.

Needs a CUDA card (the kernels have no CPU mode; on the CPU the plain
versions are held to the JAX package by test_torch_ppo_grads.py and
test_torch_ppo_update.py). Marked ``gpu``; elsewhere each test skips. On
the card, from the checkout's root (``--noconftest``: the tests' conftest
sets JAX up, and this file needs no JAX):

    python -m pytest --noconftest -m gpu -q tests/test_torch_ppo_cuda.py

Tolerances, float32 operands, where only the order of the sums differs:
loss and value loss rtol 1e-5; the surrogate and the KL, whose terms
cancel, atol 1e-5 x the mean |advantage| and 4 x A x 2^-24; each gradient
leaf rtol 1e-4 with atol 1e-5 x its largest |value|. Over the update's 4
steps the trajectories stay at that noise: params, m and v to 1e-4 of the
plain version's in L2, the LR to rtol 1e-6. bf16 operands, where a sum in
another order can also round a hidden activation or a backward gradient to
the neighbouring bf16 value: loss and aux rtol 1e-4 (the cancelling ones
with the same atol), each leaf rtol 1e-2 with atol 1e-3 x its largest
|value| (chip_smoke.py phase 5's). The GEMM: products of bf16 values are
exact in f32, so each entry within K x 2^-23 x sum |a b| of the float64
product.
"""

import math

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.fused_update import (
    FusedPPOGrad, _lib, gemm_check, gemm_check_plain, k3_step_once, pack_weights)
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic

pytestmark = pytest.mark.gpu

O, P, A = 39, 168, 23
MB = 2


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 and K3 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make(dev, rows, fixed_std=False, floor=0.0, clipped_vl=True, nan_row=None, seed=0,
         op=torch.float32, hidden=(64, 32), A=A):
    """(fused, flat params, buffers) for these hidden widths on ``dev``."""
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims, pc.critic_hidden_dims = list(hidden), list(hidden)
    pc.fixed_std, pc.noise_std_floor = fixed_std, floor
    alg = train_cfg.algorithm
    net = ActorCritic(O, P, A, pc, generator=torch.Generator().manual_seed(seed))
    fused = FusedPPOGrad(net, clip_param=alg.clip_param, value_loss_coef=alg.value_loss_coef,
                         entropy_coef=alg.entropy_coef, use_clipped_value_loss=clipped_vl,
                         rows=rows, num_mini_batches=MB, num_epochs=2, tile=128,
                         op_dtype=op, max_grad_norm=alg.max_grad_norm,
                         desired_kl=alg.desired_kl, lr_min=alg.learning_rate_min,
                         lr_max=alg.learning_rate_max)
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    wide = f(MB, rows, O + P)
    mu = 0.3 * f(MB, rows, A)
    sigma = rng.uniform(0.15, 0.3, (MB, rows, A)).astype(np.float32)
    actions = mu + sigma * f(MB, rows, A)
    logp = (-0.5 * np.sum(((actions - mu) / sigma) ** 2, -1) - np.sum(np.log(sigma), -1)
            - 0.5 * A * math.log(2 * math.pi))
    adv = f(MB, rows)
    if nan_row is not None:
        adv[0, nan_row] = np.nan
    fscal = np.concatenate([actions, logp[..., None], mu, sigma, f(MB, rows, 1),
                            f(MB, rows, 1), adv[..., None]], axis=-1)
    bufs = fused.split_buffers(torch.from_numpy(wide).to(dev), torch.from_numpy(fscal).to(dev), O)
    return fused, net.params_flat.to(dev), bufs


CASES = {
    "partial_tiles": dict(rows=300),
    "fixed_std": dict(rows=200, fixed_std=True),
    "unclipped_value_loss": dict(rows=200, clipped_vl=False),
    "nan_loss": dict(rows=200, nan_row=5),
    "std_floor": dict(rows=200, floor=0.3),
    "odd_hidden_widths": dict(rows=200, hidden=(37, 21)),
}


# (loss/aux rtol, leaf rtol, leaf atol as a fraction of the leaf's largest |value|)
K2_TOL = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (1e-4, 1e-2, 1e-3)}


@pytest.mark.parametrize("op", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_k2_matches_plain_on_the_card(cuda, case, op):
    fused, p, bufs = make(cuda, op=op, **CASES[case])
    loss_tol, rtol, atol_frac = K2_TOL[op]
    before = LAUNCHES["k2"]
    for mb in range(MB):
        lk, gk, ak = fused.grads(p, bufs, mb)
        lp, gp, ap = fused.grads_plain(p, bufs, mb)
        torch.cuda.synchronize()
        nan = case == "nan_loss" and mb == 0
        assert math.isnan(float(lk)) == math.isnan(float(lp)) == nan
        adv = bufs["fscal"][mb][:, 3 * A + 3]
        adv_scale = float(adv[torch.isfinite(adv)].abs().mean())
        atol = {"value_loss": 0.0, "surrogate_loss": loss_tol * adv_scale, "kl": 4 * A * 2.0**-24}
        for k, (x, y) in [("loss", (lk, lp))] + [(k, (ak[k], ap[k])) for k in ap]:
            torch.testing.assert_close(x, y, rtol=loss_tol, atol=atol.get(k, loss_tol * adv_scale),
                                       equal_nan=True, msg=f"{case} mb {mb}: {k}")
        assert torch.equal(torch.isnan(gk), torch.isnan(gp))
        for name, off, shape in fused.net.layout:
            a, b = gk[off: off + math.prod(shape)], gp[off: off + math.prod(shape)]
            scale = float(b[torch.isfinite(b)].abs().max()) if torch.isfinite(b).any() else 1.0
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol_frac * scale, equal_nan=True,
                                       msg=f"{case} mb {mb}: gradient of {name}")
    assert LAUNCHES["k2"] == before + MB


@pytest.mark.parametrize("case", list(CASES))
def test_k3_matches_plain_on_the_card(cuda, case):
    fused, p, bufs = make(cuda, **CASES[case])
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    count = torch.tensor(3, dtype=torch.int32, device=cuda)
    lr = torch.tensor(1e-3, device=cuda)
    before = dict(LAUNCHES)
    pk, mk, vk, lrk, metk = fused.update_scan(p, m, v, count, lr, bufs)
    pp, mp, vp, lrp, metp = fused.update_scan_plain(p, m, v, count, lr, bufs)
    torch.cuda.synchronize()
    steps = fused.num_epochs * fused.num_mini_batches
    assert LAUNCHES["k2"] == before["k2"] + steps and LAUNCHES["k3"] == before["k3"] + 1
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    for what, a, b in (("update", pk - p, pp - p), ("m", mk, mp), ("v", vk, vp)):
        # a NaN advantage makes the gradient NaN: K3, like the TPU kernel,
        # multiplies it by ok = 0 and NaN x 0 stays NaN (so does the global
        # norm): the two must agree on where the NaNs are
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), what
        assert case == "nan_loss" or bool(fin.all()), what
        if fin.any():
            assert rel(a[fin], b[fin]) <= 1e-4, f"{case}: {what} {rel(a[fin], b[fin]):.3e}"
    torch.testing.assert_close(lrk, lrp, rtol=1e-6, atol=0, equal_nan=True)
    std = pk[fused.std_off:]
    if case == "std_floor":
        assert float(std.min()) >= 0.3
    if case == "fixed_std":
        assert torch.equal(std, p[fused.std_off:])   # no gradient reaches a fixed std
    for k in ("value_loss", "surrogate_loss", "kl"):
        torch.testing.assert_close(metk[k], metp[k], rtol=1e-4, atol=1e-6, equal_nan=True, msg=k)


def gr1t1_shapes():
    """K2's tensor-core products at GR1T1's widths: every main-path shape at
    10480 rows, and the ragged row counts 1, 63, 65, 200 on the input layers
    (K = 39 and 168 padded to the 64-deep stage) and a hidden input
    gradient."""
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    net = ActorCritic(O, P, 10, train_cfg.policy)
    fused = FusedPPOGrad(net, 0.2, 1.0, 0.0, True, rows=10480, num_mini_batches=1)
    cases = fused.gemm_shapes()
    for rows in (1, 63, 65, 200):
        cases += [c for c in fused.gemm_shapes(rows) if c[4].endswith(" 0 forward")
                  or c[4].endswith(" 0 weight gradient") or c[4] == "actor 2 input gradient"]
    return cases


GEMM_CASES = gr1t1_shapes()


def gemm_operands(kind, M, N, K, dev, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {0: ((M, K), (N, K)), 1: ((M, K), (K, N)), 2: ((K, M), (K, N))}[kind]
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev).to(torch.bfloat16) for s in shapes]


@pytest.mark.parametrize("kind,M,N,K", [c[:4] for c in GEMM_CASES],
                         ids=[f"{c[4].replace(' ', '_')}-{c[1]}x{c[2]}x{c[3]}" for c in GEMM_CASES])
def test_k2_gemm_matches_float64(cuda, kind, M, N, K):
    a, b = gemm_operands(kind, M, N, K, cuda)
    c = gemm_check(kind, a, b)
    want = gemm_check_plain(kind, a, b)
    limit = K * 2.0**-23 * gemm_check_plain(kind, a.abs(), b.abs())
    torch.cuda.synchronize()
    assert c.shape == (M, N) and bool(torch.isfinite(c).all())
    err = (c.double() - want).abs()
    assert bool((err <= limit).all()), f"largest |error| / limit {float((err / limit).max()):.3e}"


@pytest.mark.parametrize("op", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_update_is_its_one_step_composition(cuda, op):
    """The whole update equals its grad steps run one at a time (a one-step
    FusedPPOGrad on minibatch s % MB, count0 + s, the carried LR), bit for
    bit: chip_smoke.py phase 6c's harness."""
    import copy

    fused, p, bufs = make(cuda, rows=200, op=op)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    count = torch.tensor(3, dtype=torch.int32, device=cuda)
    lr = torch.tensor(1e-3, device=cuda)
    whole = fused.update_scan(p, m, v, count, lr, bufs)
    one = copy.copy(fused)
    one.num_mini_batches, one.num_epochs = 1, 1
    state = (p, m, v, lr)
    for s in range(fused.num_epochs * fused.num_mini_batches):
        k = s % fused.num_mini_batches
        out = one.update_scan(*state[:3], count + s, state[3], {n: x[k:k + 1] for n, x in bufs.items()})
        state = out[:4]
    torch.cuda.synchronize()
    for name, x, y in zip(("p", "m", "v", "lr"), whole[:4], state):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("hidden", [(64, 32), (37, 21)], ids=["64_32", "37_21"])
def test_k2_packed_weights_match_pack_weights(cuda, hidden):
    """K2's packed bf16 weights after one bf16 grad step (``pack_params``)
    equal their plain version ``pack_weights`` bit for bit, pads and gaps
    included."""
    fused, p, bufs = make(cuda, rows=200, op=torch.bfloat16, hidden=hidden)
    args, keep = fused._k2_context(p, bufs)
    fused._k2_launch(_lib("k2"), args, 0, cuda)
    want = pack_weights(p, fused.net.layout, fused.q_layout, fused.q_total)
    torch.cuda.synchronize()
    assert torch.equal(keep["q"], want)


# K3's fused step against its reference pair: GR1T1's size (436,885
# parameters, 10 actions, bf16 K2 gradient) and the small cases
K3_STEP_CASES = {
    "gr1t1": dict(rows=1000, hidden=(512, 256, 128), A=10, op=torch.bfloat16),
    "fixed_std": dict(rows=200, fixed_std=True),
    "std_floor": dict(rows=200, floor=0.3),
    "nan_loss": dict(rows=200, nan_row=5),
}


@pytest.mark.parametrize("case", list(K3_STEP_CASES))
def test_k3_fused_step_equals_its_reference_pair(cuda, case):
    fused, p, bufs = make(cuda, **K3_STEP_CASES[case])
    if case == "gr1t1":
        assert fused.net.num_params == 436885
    rng = np.random.RandomState(1)
    n = p.numel()
    m = torch.from_numpy((1e-3 * rng.randn(n)).astype(np.float32)).to(cuda)
    v = torch.from_numpy((1e-6 * rng.rand(n)).astype(np.float32)).to(cuda)
    count, lr = torch.tensor(5, dtype=torch.int32, device=cuda), torch.tensor(1e-3, device=cuda)
    args, keep = fused._k2_context(p, bufs)
    fused._k2_launch(_lib("k2"), args, 0, cuda)
    for s in (0, 1):
        got = k3_step_once(fused, p, m, v, keep["g"], keep["aux"], count, lr, s)
        ref = k3_step_once(fused, p, m, v, keep["g"], keep["aux"], count, lr, s, reference=True)
        torch.cuda.synchronize()
        for key in got:
            same = got[key].view(torch.int32) == ref[key].view(torch.int32)
            assert bool(same.all()), f"{case} step {s}: {key} differs in {int((~same).sum())} words"
        nan = case == "nan_loss"
        assert float(got["step"][0]) == (0.0 if nan else 1.0)
        assert bool(torch.isnan(got["p"]).all()) == nan and (nan or bool(torch.isfinite(got["p"]).all()))
        if case == "std_floor":
            assert float(got["p"][fused.std_off:].min()) >= 0.3


@pytest.mark.parametrize("op", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_graph_rereads_its_inputs(cuda, op):
    """A second update through the same graph, from new tensors at new
    addresses, gives the bits of a fresh FusedPPOGrad's first update on
    them."""
    fused, p, bufs = make(cuda, rows=200, op=op)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    fused.update_scan(p, m, v, torch.tensor(3, dtype=torch.int32, device=cuda), torch.tensor(1e-3, device=cuda),
                      bufs)
    _, p2, bufs2 = make(cuda, rows=200, op=op, seed=1)
    rng = np.random.RandomState(2)
    m2 = torch.from_numpy((1e-3 * rng.randn(p2.numel())).astype(np.float32)).to(cuda)
    v2 = torch.from_numpy((1e-6 * rng.rand(p2.numel())).astype(np.float32)).to(cuda)
    args2 = (p2, m2, v2, torch.tensor(11, dtype=torch.int32, device=cuda), torch.tensor(2e-3, device=cuda), bufs2)
    before = dict(LAUNCHES)
    second = fused.update_scan(*args2)
    steps = fused.num_epochs * fused.num_mini_batches
    assert LAUNCHES["k2"] == before["k2"] + steps and LAUNCHES["k3"] == before["k3"] + 1
    assert len(fused._graphs) == 1
    first = make(cuda, rows=200, op=op)[0].update_scan(*args2)
    torch.cuda.synchronize()
    for name, x, y in zip(("p", "m", "v", "lr"), second[:4], first[:4]):
        assert torch.equal(x, y), name
    for key in second[4]:
        assert torch.equal(second[4][key], first[4][key]), key
    assert not torch.equal(second[0], p2)


def test_k3_one_step_copy_after_a_whole_update_graph(cuda):
    """chip_smoke.py 6c's one-step copies share the whole update's graph
    cache: a copy made after the 4-step graph exists runs one step of its
    own (its own graph, one K3 node), equal to a fresh one-step instance's."""
    import copy

    fused, p, bufs = make(cuda, rows=200, op=torch.bfloat16)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    count, lr = torch.tensor(3, dtype=torch.int32, device=cuda), torch.tensor(1e-3, device=cuda)
    fused.update_scan(p, m, v, count, lr, bufs)
    one = copy.copy(fused)
    one.num_mini_batches, one.num_epochs = 1, 1
    first = {n: x[:1] for n, x in bufs.items()}
    before = dict(LAUNCHES)
    got = one.update_scan(p, m, v, count, lr, first)
    assert LAUNCHES["k2"] == before["k2"] + 1 and LAUNCHES["k3"] == before["k3"] + 1
    assert len(fused._graphs) == 2
    assert sorted(ctx.nodes["cooperative"] for ctx in fused._graphs.values()) == [1, 4]
    fresh = make(cuda, rows=200, op=torch.bfloat16)[0]
    fresh.num_mini_batches, fresh.num_epochs = 1, 1
    want = fresh.update_scan(p, m, v, count, lr, first)
    torch.cuda.synchronize()
    for name, x, y in zip(("p", "m", "v", "lr"), got[:4], want[:4]):
        assert torch.equal(x, y), name
