"""K1's terrain program on the CPU under ThreadSanitizer: no race, and bit
for bit the one-thread kernel.

The harness of tests/test_torch_decimation_race.py (``csrc/host/``: each GPU
thread of a block a std::thread, ``__syncwarp(mask)`` and ``__syncthreads``
barriers over the mask's and the block's threads) built for the GR1T1
trimesh program: ``local_plane_walls`` (9 ground lanes a contact point in,
the final-state point positions out) without the post fold. The inputs are
reachable GR1T1 states on a 2 x 2 trimesh grid with planted ground lanes
(``cuda_step.planted_planes``: treads in contact, riser walls in contact,
holding a point's center, and below a point), so every branch of the
terrain contact runs, at 1, 8 and 61 envs (one team alone in a block, one
full block, and eight blocks of which the last holds 5 envs).

Needs g++ with ThreadSanitizer; no card.
"""

import shutil

import pytest

from wiki_grx_gym_tpu_torch.scripts import sanitize_k1
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

TRIMESH = cuda_step.terrain_config("trimesh", 2, 2)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("k1_host_terrain")
    op = cuda_step.task_env("GR1T1", 1, "cpu", TRIMESH).decimation_op
    assert (op.sizes.TERRAIN, op.sizes.FOLD, op.plane_lanes) == (2, 0, 9)
    return sanitize_k1.build_host(op, out_dir), out_dir, op


@pytest.mark.parametrize("n", [1, 8, 61])
def test_trimesh_team_kernel_has_no_race_and_equals_the_thread_kernel(host, n):
    exe, out_dir, op = host
    const, inp, c_out = sanitize_k1.write_case(n, out_dir, mutate=TRIMESH, planted=True, steps=4)
    rc, text = sanitize_k1.run([exe, const, inp, n, c_out], timeout=600)
    if any("FATAL: ThreadSanitizer" in line for line in text):
        pytest.skip("ThreadSanitizer cannot start here: " + " ".join(text[:3]))
    report = "\n".join(text)
    assert rc == 0 and "ThreadSanitizer" not in report, report[-6000:]
    assert f"{n} envs, {op.c_out} x {n} output lanes, 0 differ" in report, report[-2000:]
