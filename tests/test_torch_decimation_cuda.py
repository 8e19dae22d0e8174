"""K1's team kernel on the card against the one-thread kernel, bit for bit.

The team kernel (``csrc/decimation.cu:decimation_team_kernel``, the main
path's) computes every output with the same float operations in the same
order as the one-thread kernel (``decimation_kernel``, kept as its
reference), so the two must agree in every bit of every output lane (NaN
lanes compared by bit pattern). Checked here on reachable GR1T1 states:

- at 1, 7, 8, 9, 33 and 4097 envs (a block holds 8 envs and a warp 2, so
  these leave ragged blocks and a half-used warp);
- each env's result does not depend on its neighbours: the first n envs of
  a 4096-env launch equal a launch of those n alone;
- an env whose joint velocity is NaN gets ``bad = 1`` and leaves every
  other env of its warp and block bit-identical to the launch without it;
- the wrapper's call on CUDA tensors launches the team kernel (its output
  equals the team kernel's on the packed input) and counts one launch.

Needs a CUDA card (the kernels have no CPU mode; on the CPU the plain
version is held to the JAX package by test_torch_decimation.py, and the team
kernel's schedule by test_torch_decimation_layout.py). Marked ``gpu``;
elsewhere each test skips. On the card, from the checkout's root
(``--noconftest``: the tests' conftest sets JAX up, and this file needs no
JAX):

    python -m pytest --noconftest -m gpu -q tests/test_torch_decimation_cuda.py
"""

import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.gpu

N_MAX = 4097


@pytest.fixture(scope="module")
def case():
    """(decimation op, packed (C_in, 4097) input, the wrapper's arguments) on
    reachable states: the env a few steps after init with random actions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return cuda_step.reachable_case(N_MAX, torch.device("cuda"))


def run(op, comp, **how):
    out = torch.full((op.c_out, comp.shape[1]), -7.0, device=comp.device)
    op.launch_packed(comp.contiguous(), out, **how)
    torch.cuda.synchronize()
    return out


def bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 33, 4097])
def test_team_kernel_equals_the_thread_kernel_bit_for_bit(case, n):
    op, comp, _, _ = case
    ref = run(op, comp[:, :n], kernel="thread")
    got = run(op, comp[:, :n])
    differ = int((bits(got) != bits(ref)).sum())
    assert differ == 0, f"{differ} differing output lanes at n={n}"


@pytest.mark.parametrize("n", [1, 7, 9, 33])
def test_each_env_is_independent_of_its_neighbours(case, n):
    op, comp, _, _ = case
    full = run(op, comp[:, :4096])
    alone = run(op, comp[:, :n])
    assert torch.equal(bits(full[:, :n]), bits(alone))


def test_nan_env_is_bad_and_leaves_its_block_unchanged(case):
    op, comp, _, _ = case
    n, e = 64, 13        # env 13: second team of warp 6, block 1 of 8 envs
    clean = comp[:, :n].clone()
    dirty = clean.clone()
    dirty[op.in_off["qd"][0] + 2, e] = float("nan")
    a, b = run(op, clean), run(op, dirty)
    bad = op.out_off["bad"][0]
    assert float(b[bad, e]) == 1.0 and float(a[bad, e]) == 0.0
    others = [j for j in range(n) if j != e]
    assert torch.equal(bits(a[:, others]), bits(b[:, others]))
    ref = run(op, dirty, kernel="thread")
    assert torch.equal(bits(b), bits(ref))


def test_wrapper_launches_the_team_kernel(case):
    op, comp, args, kw = case
    reset_launch_counts()
    res = op(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["k1"] == 1
    want = run(op, comp)
    off, cnt = op.out_off["qd"]
    assert torch.equal(bits(res[0].qd.contiguous()), bits(want[off:off + cnt].t().contiguous()))
    off, cnt = op.out_off["rew_terms"]
    assert torch.equal(bits(res[8]["rew_terms"].contiguous()), bits(want[off:off + cnt].t().contiguous()))
