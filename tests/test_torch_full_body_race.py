"""K1's team kernel at the 32-DOF full body's sizes, on the CPU under
ThreadSanitizer: no race, and bit for bit the one-thread kernel.

The harness of tests/test_torch_decimation_race.py (``csrc/host/``: each GPU
thread of a block a std::thread, ``__syncwarp(mask)`` and ``__syncthreads``
barriers over the mask's and the block's threads) built for GR1T1_full's
sizes (33 bodies, 32 dofs, 240 self-collision pairs, NIN 340, NOUT 374) and
its team shape (``sim/cuda_step.py:team_shape``): lane l of a team takes
dof l and, where a team has fewer lanes than dofs, dof l + T too. Run on
reachable full-body states (the env a few steps after init) at 1 env and
at a block and a half of envs (a full block and a half-used one). Each run
has its own time limit.

Needs g++ with ThreadSanitizer; no card.
"""

import shutil

import pytest

from wiki_grx_gym_tpu_torch.scripts import sanitize_k1
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

TASK = "GR1T1_full"
E = cuda_step.TEAM_SHAPE_FULL_BODY[1]
RUN_TIMEOUT_S = 300   # one checked run (it takes ~10-20 s on a CPU)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("k1_host_full")
    op = cuda_step.task_env(TASK, 1, "cpu").decimation_op
    assert op.sizes.ND == 32 and op.team == cuda_step.TEAM_SHAPE_FULL_BODY
    return sanitize_k1.build_host(op, out_dir), out_dir, op


@pytest.mark.parametrize("n", [1, E + E // 2])
def test_full_body_team_kernel_has_no_race_and_equals_the_thread_kernel(host, n):
    exe, out_dir, op = host
    const, inp, c_out = sanitize_k1.write_case(n, out_dir, task=TASK, steps=4)
    rc, text = sanitize_k1.run([exe, const, inp, n, c_out], timeout=RUN_TIMEOUT_S)
    if any("FATAL: ThreadSanitizer" in line for line in text):
        pytest.skip("ThreadSanitizer cannot start here: " + " ".join(text[:3]))
    report = "\n".join(text)
    assert rc == 0 and "ThreadSanitizer" not in report, report[-6000:]
    assert f"{n} envs, {op.c_out} x {n} output lanes, 0 differ" in report, report[-2000:]
