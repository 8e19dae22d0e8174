"""K1's team kernel on the CPU under ThreadSanitizer: no race, and bit for
bit the one-thread kernel.

The kernels of ``csrc/decimation.cu`` are compiled for the host with g++
(``csrc/host/k1_host.cpp``: each GPU thread of a block a std::thread;
``__syncthreads`` and ``__syncwarp(mask)`` barriers over the block's and the
mask's threads; shuffles that order no memory, ``csrc/host/cuda_runtime.h``)
with ``-fsanitize=thread``, and run by the program that runs them on the card
under compute-sanitizer (``csrc/k1_sanitize.cpp``; ``scripts/sanitize_k1.py
--host``) on reachable GR1T1 states. ThreadSanitizer reports every pair of
accesses to one address, one of them a write, that no barrier orders (a
missing ``__syncwarp``), and the team kernel must equal the one-thread
kernel in every output bit (both from one compiler, without contraction).
At 1, 8 and 61 envs: one team alone in a block, one full block, and eight
blocks of which the last holds 5 envs (a half-used warp). A copy with the
barrier before the back substitution taken out must be caught, and so must
one without the barrier between the fill of the mass matrix's rows (which
reads the dynamics arrays) and the first write of its factor: the programs
whose factor shares the dynamics arrays' memory (``team_shared_ls``: the
32-DOF body) have it, so that copy runs GR1T1_full's sizes, one env.

Needs g++ with ThreadSanitizer; no card.
"""

import shutil

import pytest

from wiki_grx_gym_tpu_torch import build as kbuild
from wiki_grx_gym_tpu_torch.scripts import sanitize_k1
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")


def run_case(exe, out_dir, n, task="GR1T1", steps=8):
    const, inp, c_out = sanitize_k1.write_case(n, out_dir, task=task, steps=steps)
    rc, text = sanitize_k1.run([exe, const, inp, n, c_out], timeout=600)
    if any("FATAL: ThreadSanitizer" in line for line in text):
        pytest.skip("ThreadSanitizer cannot start here: " + " ".join(text[:3]))
    return rc, text


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("k1_host")
    op = cuda_step.task_env("GR1T1", 1, "cpu").decimation_op
    return sanitize_k1.build_host(op, out_dir), out_dir


@pytest.mark.parametrize("n", [1, 8, 61])
def test_team_kernel_has_no_race_and_equals_the_thread_kernel(host, n):
    exe, out_dir = host
    rc, text = run_case(exe, out_dir, n)
    report = "\n".join(text)
    assert rc == 0 and "ThreadSanitizer" not in report, report[-6000:]
    assert f"{n} envs, 301 x {n} output lanes, 0 differ" in report, report[-2000:]


def assert_caught_without(tmp_path, barrier, kept, task="GR1T1", n=8, steps=8):
    """A copy of the sources with ``barrier`` replaced by ``kept`` (the
    barrier's line taken out) must report a race at ``n`` envs of ``task``
    (``steps`` policy steps after init)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC, csrc)
    src = (csrc / "decimation.cu").read_text()
    assert src.count(barrier) == 1
    (csrc / "decimation.cu").write_text(src.replace(barrier, kept))
    op = cuda_step.task_env(task, 1, "cpu").decimation_op
    rc, text = run_case(sanitize_k1.build_host(op, tmp_path, csrc), tmp_path, n, task, steps)
    assert rc != 0 and any("WARNING: ThreadSanitizer: data race" in line for line in text), "\n".join(text)


def test_a_missing_barrier_is_caught(tmp_path):
    assert_caught_without(tmp_path, "    __syncwarp(mask);\n    // back substitution on one lane\n",
                          "    // back substitution on one lane\n")


def test_a_missing_barrier_before_the_factor_is_caught(tmp_path):
    comment = "        // the factor overwrites the dynamics arrays the fill has read\n"
    assert_caught_without(tmp_path, comment + "        __syncwarp(mask);\n", comment, task="GR1T1_full", n=1,
                          steps=4)
