"""K1's all-terms fold on the CPU under ThreadSanitizer: no race, and bit
for bit the one-thread kernel.

The harness of tests/test_torch_decimation_race.py (``csrc/host/``: each GPU
thread of a block a std::thread, ``__syncwarp(mask)`` and ``__syncthreads``
barriers over the mask's and the block's threads) built for GR1T1 with
every one of the 50 reward terms at a non-zero scale and contacts penalized
on the thighs and shanks (4 groups; ``cuda_step.all_terms_config``): the
terms spread over the team's lanes, the post values written by lane 0 and
read by all. The states are planted so that every term is non-zero
somewhere (penalized groups in touch, joints past their soft limits, a
friction cone wider than the stumble ratio: ``cuda_step.planted_all_terms``),
at 1, 8 and 61 envs (one team alone in a block, one full block, and eight
blocks of which the last holds 5 envs). ``scripts/sanitize_k1.py --host
--program V`` (or ``T``) runs the control laws' programs the same way.

Needs g++ with ThreadSanitizer; no card.
"""

import shutil

import pytest

from wiki_grx_gym_tpu_torch.scripts import sanitize_k1
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

ALL_TERMS = sanitize_k1.PROGRAMS["all_terms"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("k1_host_all_terms")
    op = cuda_step.task_env("GR1T1", 1, "cpu", ALL_TERMS).decimation_op
    assert (op.sizes.FOLD, op.sizes.NR, op.sizes.NPEN, op.sizes.NPENP) == (1, 50, 4, 8)
    return sanitize_k1.build_host(op, out_dir), out_dir, op


@pytest.mark.parametrize("n", [1, 8, 61])
def test_all_terms_team_kernel_has_no_race_and_equals_the_thread_kernel(host, n):
    exe, out_dir, op = host
    const, inp, c_out = sanitize_k1.write_case(n, out_dir, mutate=ALL_TERMS, plant_terms=True, steps=4)
    rc, text = sanitize_k1.run([exe, const, inp, n, c_out], timeout=600)
    if any("FATAL: ThreadSanitizer" in line for line in text):
        pytest.skip("ThreadSanitizer cannot start here: " + " ".join(text[:3]))
    report = "\n".join(text)
    assert rc == 0 and "ThreadSanitizer" not in report, report[-6000:]
    assert f"{n} envs, {op.c_out} x {n} output lanes, 0 differ" in report, report[-2000:]
