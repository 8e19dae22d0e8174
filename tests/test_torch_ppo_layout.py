"""The operand layouts of K2's tensor-core chain and the whole-update harness
of ``chip_smoke.py`` phase 6c, on the CPU (plain torch; the kernels read
these layouts on the card).

- The packed bf16 weights (``packed_layout``/``pack_weights``): at
  GR1T1's widths and two small nets, every matrix
  starts 128-B aligned with 16-B aligned rows padded to a multiple of 16
  columns, the round trip gives back each weight rounded to bf16 bit for
  bit, and everything outside the weights is zero (the padded K adds
  nothing to a product).
- The obs / critic-obs repack (``repack_rows``) of the shuffle buffer's
  strided views into contiguous zero-padded ``(MB, rows, 48)`` and
  ``(MB, rows, 176)`` bf16 buffers.
- The tensor-core products of one grad step (``gemm_shapes``) and the plain
  version of the GEMM check (``gemm_check`` on CPU tensors).
- The step-0 harness: the whole ``update_scan_plain`` at a small size equals
  the composition of its one-step calls (a one-step ``FusedPPOGrad`` on
  minibatch ``s % MB``, count ``count0 + s``, the LR carried out of step
  s - 1) bit for bit in p, m, v and the LR, in both operand types.
"""

import copy
import math

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.fused_update import (
    FusedPPOGrad, gemm_check, pack_weights, packed_layout, repack_rows)
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic

O, P = 39, 168
NETS = {"gr1t1": ((512, 256, 128), 10), "small": ((64, 32), 23), "odd": ((40, 24, 8), 3)}


def make_fused(hidden, A, rows=96, mbs=3, epochs=2, op=torch.float32, seed=0):
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims, pc.critic_hidden_dims = list(hidden), list(hidden)
    alg = train_cfg.algorithm
    net = ActorCritic(O, P, A, pc, generator=torch.Generator().manual_seed(seed))
    return FusedPPOGrad(net, clip_param=alg.clip_param, value_loss_coef=alg.value_loss_coef,
                        entropy_coef=alg.entropy_coef, use_clipped_value_loss=True, rows=rows,
                        num_mini_batches=mbs, num_epochs=epochs, tile=32, op_dtype=op,
                        max_grad_norm=alg.max_grad_norm, desired_kl=alg.desired_kl,
                        lr_min=alg.learning_rate_min, lr_max=alg.learning_rate_max)


def buffers(fused, seed=0):
    """Shuffle buffers as PPO._pack_shuffle lays them out, made with numpy."""
    mbs, rows, A = fused.num_mini_batches, fused.rows, fused.act_dim
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(mbs, rows, A)
    sigma = rng.uniform(0.15, 0.3, (mbs, rows, A)).astype(np.float32)
    actions = mu + sigma * f(mbs, rows, A)
    logp = (-0.5 * np.sum(((actions - mu) / sigma) ** 2, -1) - np.sum(np.log(sigma), -1)
            - 0.5 * A * math.log(2 * math.pi))
    fscal = np.concatenate([actions, logp[..., None], mu, sigma, f(mbs, rows, 1), f(mbs, rows, 1),
                            f(mbs, rows, 1)], axis=-1)
    wide = torch.from_numpy(f(mbs, rows, O + P)).to(fused.op_dtype)
    return fused.split_buffers(wide, torch.from_numpy(fscal), O)


def unpack_weights(q, layout, q_layout):
    """The packed copy back to the weights' place in the flat layout (f32,
    zeros for the biases and the std)."""
    n = layout[-1][1] + math.prod(layout[-1][2])
    p = torch.zeros(n, dtype=torch.float32)
    weights = [(off, shape) for name, off, shape in layout if name.endswith("weight")]
    for (off, (dout, din)), (qo, ld) in zip(weights, q_layout):
        p[off: off + dout * din] = q[qo: qo + dout * ld].view(dout, ld)[:, :din].reshape(-1).float()
    return p


@pytest.mark.parametrize("name", list(NETS))
def test_packed_weights_round_trip_aligned_and_zero_padded(name):
    hidden, A = NETS[name]
    fused = make_fused(hidden, A)
    net = fused.net
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(net.num_params, generator=gen)
    q = pack_weights(p, net.layout, fused.q_layout, fused.q_total)
    assert q.dtype == torch.bfloat16 and q.shape == (fused.q_total,)
    assert len(fused.q_layout) == len(fused.layer_dims) == len(net.layout) // 2
    covered = torch.zeros(fused.q_total, dtype=torch.bool)
    for (din, dout), (off, ld) in zip(fused.layer_dims, fused.q_layout):
        assert (off * 2) % 128 == 0 and (ld * 2) % 16 == 0 and ld % 16 == 0 and din <= ld < din + 16
        covered[off: off + dout * ld].view(dout, ld)[:, :din] = True
    assert fused.q_total * 2 % 128 == 0
    assert not bool(q[~covered].float().abs().any()), "padding and gaps must be zero"
    back = unpack_weights(q, net.layout, fused.q_layout)
    for lname, off, shape in net.layout:
        sl = slice(off, off + math.prod(shape))
        want = p[sl].to(torch.bfloat16).float() if lname.endswith("weight") else torch.zeros(math.prod(shape))
        assert torch.equal(back[sl], want), lname


def test_packed_layout_at_gr1t1_widths():
    layout, total = packed_layout([(39, 512), (512, 256), (256, 128), (128, 10),
                                   (168, 512), (512, 256), (256, 128), (128, 1)])
    assert [ld for _, ld in layout] == [48, 512, 256, 128, 176, 512, 256, 128]
    assert layout[0][0] == 0 and layout[1][0] == 512 * 48 and total == 443776


@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_obs_repack(op):
    fused = make_fused(*NETS["small"], op=op)
    bufs = buffers(fused)
    for key, feat, width in (("obs", O, 48), ("cobs", P, 176)):
        x = bufs[key]
        assert x.stride(-1) == 1 and x.stride(1) == O + P   # a view into the wide buffer
        y = repack_rows(x, width)
        assert y.dtype == torch.bfloat16 and y.is_contiguous()
        assert tuple(y.shape) == (fused.num_mini_batches, fused.rows, width) and (y.stride(1) * 2) % 16 == 0
        assert torch.equal(y[..., :feat], x.to(torch.bfloat16))
        assert not bool(y[..., feat:].float().abs().any())


def test_gemm_shapes_and_plain_check():
    fused = make_fused(*NETS["gr1t1"], rows=10480, mbs=1)
    shapes = fused.gemm_shapes()
    kinds = [k for k, *_ in shapes]
    assert len(shapes) == 22 and kinds.count(0) == 8 and kinds.count(1) == 6 and kinds.count(2) == 8
    # forward and weight gradient over every weight, input gradient over all
    # but the input layers': 25.136 GFLOP
    w, w_in = 435072, 39 * 512 + 168 * 512
    assert sum(2 * M * N * K for _, M, N, K, _ in shapes) == 2 * 10480 * (3 * w - w_in) == 25135902720
    assert (0, 10480, 512, 39, "actor 0 forward") in shapes
    assert (2, 1, 128, 10480, "critic 3 weight gradient") in shapes
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(7, 5).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(5, 3).astype(np.float32)).to(torch.bfloat16)
    want = a.double() @ b.double()
    assert torch.equal(gemm_check(1, a, b), want)
    assert torch.equal(gemm_check(0, a, b.t().contiguous()), want)
    assert torch.equal(gemm_check(2, a.t().contiguous(), b), want)


@pytest.mark.parametrize("op", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_whole_update_is_its_one_step_composition(op):
    fused = make_fused(*NETS["small"], op=op)
    bufs = buffers(fused, seed=3)
    p = fused.net.params_flat.clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    count0 = torch.tensor(5, dtype=torch.int32)
    lr = torch.tensor(1e-3)
    whole = fused.update_scan_plain(p, m, v, count0, lr, bufs)
    one = copy.copy(fused)
    one.num_mini_batches, one.num_epochs = 1, 1
    state = (p, m, v, lr)
    lrs = []
    for s in range(fused.num_epochs * fused.num_mini_batches):
        k = s % fused.num_mini_batches
        out = one.update_scan(*state[:3], count0 + s, state[3], {n: x[k:k + 1] for n, x in bufs.items()})
        state = out[:4]
        lrs.append(float(state[3]))
    for name, x, y in zip(("p", "m", "v", "lr"), whole[:4], state):
        assert torch.equal(x, y), name
    assert len(set(lrs)) > 1, "the adaptive LR should move in this run"
