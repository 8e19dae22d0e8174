"""K2 and K3 on the card against their plain versions, at small sizes and in
the cases the GR1T1 main path (and so ``chip_smoke.py``) does not reach: a
row count that leaves partial GEMM tiles, a fixed std, the unclipped value
loss, a NaN advantage (the NaN-loss path) and the std floor at 0.3 (above
the 0.2 init, so K3's projection acts from the first step).

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
plain version's in L2, the LR to rtol 1e-6.
"""

import math

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad
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


def make(dev, rows, fixed_std=False, floor=0.0, clipped_vl=True, nan_row=None, seed=0):
    """(fused, flat params, buffers) for hidden (64, 32) on ``dev``."""
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims, pc.critic_hidden_dims = [64, 32], [64, 32]
    pc.fixed_std, pc.noise_std_floor = fixed_std, floor
    alg = train_cfg.algorithm
    net = ActorCritic(O, P, A, pc, generator=torch.Generator().manual_seed(seed))
    fused = FusedPPOGrad(net, clip_param=alg.clip_param, value_loss_coef=alg.value_loss_coef,
                         entropy_coef=alg.entropy_coef, use_clipped_value_loss=clipped_vl,
                         rows=rows, num_mini_batches=MB, num_epochs=2, tile=128,
                         op_dtype=torch.float32, max_grad_norm=alg.max_grad_norm,
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
}


@pytest.mark.parametrize("case", list(CASES))
def test_k2_matches_plain_on_the_card(cuda, case):
    fused, p, bufs = make(cuda, **CASES[case])
    before = LAUNCHES["k2"]
    for mb in range(MB):
        lk, gk, ak = fused.grads(p, bufs, mb)
        lp, gp, ap = fused.grads_plain(p, bufs, mb)
        torch.cuda.synchronize()
        nan = case == "nan_loss" and mb == 0
        assert math.isnan(float(lk)) == math.isnan(float(lp)) == nan
        adv = bufs["fscal"][mb][:, 3 * A + 3]
        adv_scale = float(adv[torch.isfinite(adv)].abs().mean())
        atol = {"value_loss": 0.0, "surrogate_loss": 1e-5 * adv_scale, "kl": 4 * A * 2.0**-24}
        for k, (x, y) in [("loss", (lk, lp))] + [(k, (ak[k], ap[k])) for k in ap]:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=atol.get(k, 1e-5 * adv_scale),
                                       equal_nan=True, msg=f"{case} mb {mb}: {k}")
        assert torch.equal(torch.isnan(gk), torch.isnan(gp))
        for name, off, shape in fused.net.layout:
            a, b = gk[off: off + math.prod(shape)], gp[off: off + math.prod(shape)]
            scale = float(b[torch.isfinite(b)].abs().max()) if torch.isfinite(b).any() else 1.0
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale, equal_nan=True,
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
