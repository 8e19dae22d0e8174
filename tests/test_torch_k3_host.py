"""K3's fused optimizer step on the CPU under ThreadSanitizer: no race, bit
for bit its reference pair, and within a stated tolerance of its plain
version.

The kernels of ``csrc/ppo_update.cu`` are compiled for the host with g++
(``csrc/host/k3_host.cpp`` over ``csrc/host/cuda_runtime.h``: each GPU thread
a std::thread, ``__syncthreads`` a barrier over the block's threads, each
block its own shared memory; the fused step's blocks all run at once and
``cooperative_groups::this_grid().sync()`` is a barrier over all of them)
with ``-fsanitize=thread -ffp-contract=off``. The program runs the fused
step (``k3_fused_step``, the main path's) and PR 2's two-launch step
(``k3_norm`` + ``k3_adam``, its reference) on the same inputs, made here with
numpy.

- The two must agree in every bit of p, m, v, g, the LR/metric state slots,
  the partial sums and the step record (NaN lanes by bit pattern): they run
  the same helpers in the same order, compiled without contraction.
- Against ``FusedPPOGrad._k3_step_plain`` (float32 PyTorch on the CPU),
  which sums the global norm in another order (per leaf) and rounds the
  entropy term through a reciprocal: the update (new minus old p), m and v
  agree to 1e-5 in L2, each entry to rtol 1e-4 with an atol of 1e-6 x the
  largest |value| of its vector (for the update, of the params: an update
  is a difference of two params, so it resolves no finer than their
  rounding); the LR exactly; the step record and the running metric sums
  exactly (they use the same float32 operations).
- ThreadSanitizer reports no race.

Cases: 898 parameters (actor 20-15-6, critic 30-15-1, 6 std entries), in
one block, or in three whose last chunk is ragged (300, 300, 298 entries)
and holds the std entries; the clip by global norm triggering and not; the
adaptive LR going down, up and staying; a NaN gradient entry with a NaN
loss (the NaN-loss path: everything NaN, as on the TPU); a NaN loss with a
finite gradient (ok = 0: the moments decay, the params still move); the std
floor at 0.3 and a fixed std. A copy of ``ppo_update.cu`` without the grid
barrier must be caught.

Needs g++ with ThreadSanitizer; no card.
"""

import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch import build as kbuild
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.scripts.sanitize_k1 import HOST_FLAGS

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

O, P, A, HIDDEN = 20, 30, 6, 15
ROWS = 100
LR = 5e-4
BARRIER = "    cooperative_groups::this_grid().sync();\n"

CASES = {
    "1_block_lr_stays": dict(nblocks=1, gscale=0.01, kl=0.01),
    "3_blocks_lr_stays": dict(nblocks=3, gscale=0.01, kl=0.01, s=1),
    "3_blocks_clip_lr_down": dict(nblocks=3, gscale=1.0, kl=0.03),
    "1_block_clip_lr_up": dict(nblocks=1, gscale=1.0, kl=0.002, s=1),
    "3_blocks_lr_up": dict(nblocks=3, gscale=0.01, kl=0.002),
    "3_blocks_nan_gradient": dict(nblocks=3, gscale=0.01, kl=0.01, nan="grad"),
    "3_blocks_nan_loss": dict(nblocks=3, gscale=0.01, kl=0.01, nan="loss"),
    "3_blocks_std_floor": dict(nblocks=3, gscale=1.0, kl=0.01, floor=0.3),
    "3_blocks_fixed_std": dict(nblocks=3, gscale=0.01, kl=0.03, fixed_std=True),
}


def make_fused(fixed_std=False, floor=0.0):
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims, pc.critic_hidden_dims = [HIDDEN], [HIDDEN]
    pc.fixed_std, pc.noise_std_floor = fixed_std, floor
    net = ActorCritic(O, P, A, pc, generator=torch.Generator().manual_seed(0))
    return FusedPPOGrad(net, clip_param=0.2, value_loss_coef=1.0, entropy_coef=0.01,
                        use_clipped_value_loss=True, rows=ROWS, num_mini_batches=1,
                        max_grad_norm=1.0, desired_kl=0.01, lr_min=1e-5, lr_max=1e-3)


def make_inputs(fused, gscale, kl, nan=None, seed=0):
    """(p, m, v, g, aux, count0) in float32 numpy, made from a seed."""
    n = fused.net.num_params
    rng = np.random.RandomState(seed)
    p = rng.randn(n).astype(np.float32) * np.float32(0.05)
    p[fused.std_off:] = rng.uniform(0.25, 0.35, A).astype(np.float32)   # around the 0.3 floor
    m = (rng.randn(n) * 0.01 * gscale).astype(np.float32)
    v = (rng.rand(n) * 1e-4 * gscale ** 2).astype(np.float32)
    g = (rng.randn(n) * gscale).astype(np.float32)
    aux = np.array([0.05 * ROWS, 0.4 * ROWS, kl * ROWS, 0.0], np.float32)   # surr, vl, kl sums
    if nan == "grad":
        g[n // 2] = np.nan
    if nan in ("grad", "loss"):
        aux[0] = np.nan
    return p, m, v, g, aux, 7


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("k3_host")
    return build_host(out_dir), out_dir


def build_host(out_dir, csrc=kbuild.CSRC):
    exe = out_dir / "k3_host_tsan"
    cmd = ["g++", *HOST_FLAGS, "-I", str(csrc / "host"), str(csrc / "host" / "k3_host.cpp"), "-o", str(exe)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, f"building K3 for the host failed:\n{res.stdout}\n{res.stderr}"
    return exe


def run_case(exe, out_dir, fused, nblocks, s, inputs):
    """Runs the fused step and the reference pair; returns (rc, output
    lines, {"fused": arrays, "reference": arrays}) with arrays p, m, v, g,
    state, step, part."""
    p, m, v, g, aux, count0 = inputs
    state = np.zeros(16, np.float32)
    state[(s & 1) * 8: (s & 1) * 8 + 4] = [LR, 0.5, -0.25, 0.125]   # the slot step s reads
    args = bytes(fused._k3_args({}, nblocks))
    src, dst = out_dir / "input.bin", out_dir / "output.bin"
    with open(src, "wb") as f:
        f.write(np.int32(len(args)).tobytes() + args + np.int32(s).tobytes() + np.int32(count0).tobytes())
        for x in (state, aux, p, m, v, g):
            f.write(x.astype(np.float32).tobytes())
    res = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=600)
    text = (res.stdout + res.stderr).strip().splitlines()
    if any("FATAL: ThreadSanitizer" in line for line in text):
        pytest.skip("ThreadSanitizer cannot start here: " + " ".join(text[:3]))
    out = {}
    if res.returncode == 0:
        flat = np.fromfile(dst, dtype=np.float32)
        n = p.size
        sizes = [("p", n), ("m", n), ("v", n), ("g", n), ("state", 16), ("step", 4), ("part", nblocks)]
        pos = 0
        for name in ("fused", "reference"):
            out[name] = {}
            for key, size in sizes:
                out[name][key] = flat[pos: pos + size]
                pos += size
        assert pos == flat.size
    return res.returncode, text, out


def close(a, b, what, scale):
    """The stated tolerance against the plain version: 1e-5 in L2, each
    entry rtol 1e-4 with an atol of 1e-6 x ``scale``."""
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin), what
    if not fin.any():
        return
    a, b = a[fin].astype(np.float64), b[fin].astype(np.float64)
    err, ref = np.linalg.norm(a - b), np.linalg.norm(b)
    assert err <= 1e-5 * ref, f"{what}: L2 {err:.3e} of {ref:.3e}"
    assert np.all(np.abs(a - b) <= 1e-4 * np.abs(b) + 1e-6 * scale), f"{what}: largest |diff| {np.abs(a - b).max():.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_has_no_race_equals_the_reference_pair_and_the_plain_step(host, case):
    exe, out_dir = host
    c = dict(CASES[case])
    nblocks, s = c.pop("nblocks"), c.pop("s", 0)
    fused = make_fused(c.pop("fixed_std", False), c.pop("floor", 0.0))
    inputs = make_inputs(fused, **c)
    p, m, v, g, aux, count0 = inputs
    n = fused.net.num_params
    assert n == 898 and fused.std_off == n - A
    chunk = -(-n // nblocks)
    assert nblocks == 1 or (n - (nblocks - 1) * chunk < chunk and fused.std_off > (nblocks - 1) * chunk)

    rc, text, out = run_case(exe, out_dir, fused, nblocks, s, inputs)
    report = "\n".join(text)
    assert rc == 0 and "ThreadSanitizer" not in report, report[-6000:]
    words = 4 * n + 16 + 4 + nblocks
    assert f"fused vs reference 0 differing words of {words}" in report, report[-2000:]
    fu, ref = out["fused"], out["reference"]
    for key in fu:
        assert np.array_equal(fu[key].view(np.uint32), ref[key].view(np.uint32)), key

    # against the plain step
    t = torch.from_numpy
    pp, mp, vp, lrp, means = fused._k3_step_plain(
        t(p), t(m), t(v), t(g), t(aux[:3].copy()), torch.tensor(count0 + s, dtype=torch.int32),
        torch.tensor(LR, dtype=torch.float32))
    largest = lambda x: float(np.abs(x[np.isfinite(x)]).max()) if np.isfinite(x).any() else 0.0
    close(fu["p"] - p, (pp - t(p)).numpy(), "update", largest(p))
    close(fu["m"], mp.numpy(), "m", largest(mp.numpy()))
    close(fu["v"], vp.numpy(), "v", largest(vp.numpy()))
    out_slot, in_slot = ((s + 1) & 1) * 8, (s & 1) * 8
    lr_new = fu["state"][out_slot]
    assert lr_new.view(np.uint32) == np.float32(lrp).view(np.uint32), (float(lr_new), float(lrp))
    vl, surr, kl = means.numpy()
    ok = 0.0 if c.get("nan") else 1.0
    np.testing.assert_array_equal(fu["step"], np.array([ok, surr, vl, kl], np.float32))
    seeded = np.array([0.5, -0.25, 0.125], np.float32)
    np.testing.assert_array_equal(fu["state"][out_slot + 1: out_slot + 4], seeded + np.array([vl, surr, kl]))
    assert fu["state"][in_slot] == np.float32(LR)
    # the std entries' gradient gains the entropy term -ce / std in the kernel
    std = p[fused.std_off:]
    want_g = g.copy()
    if not fused.fixed_std:
        want_g[fused.std_off:] = g[fused.std_off:] + np.float32(-fused.entropy_coef) / std
    assert np.array_equal(fu["g"].view(np.uint32), want_g.view(np.uint32))

    # the case does what its name says
    if "lr_stays" in case or "nan" in case or "floor" in case:
        assert float(lr_new) == np.float32(LR)
    elif "lr_down" in case or "fixed_std" in case:
        assert float(lr_new) < np.float32(LR)
    elif "lr_up" in case:
        assert float(lr_new) > np.float32(LR)
    if c.get("nan") is None:
        gg = want_g.astype(np.float64)
        clipped = math.sqrt(float(np.sum(gg * gg))) >= fused.max_grad_norm
        assert clipped == (c["gscale"] >= 1.0), case
        assert np.isfinite(fu["p"]).all()
    elif c["nan"] == "grad":
        assert np.isnan(fu["p"]).all()
    else:   # ok = 0: the moments decay and the params still move, finitely
        np.testing.assert_array_equal(fu["m"], np.float32(fused.adam_b1) * m)
        assert np.isfinite(fu["p"]).all() and not np.array_equal(fu["p"], p)
    if fused.std_floor > 0.0:
        assert float(fu["p"][fused.std_off:].min()) >= 0.3 and float(std.min()) < 0.3
    if fused.fixed_std:
        assert np.array_equal(fu["g"][fused.std_off:], g[fused.std_off:])


def test_a_missing_grid_barrier_is_caught(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kbuild.CSRC, csrc)
    src = (csrc / "ppo_update.cu").read_text()
    assert src.count(BARRIER) == 1
    (csrc / "ppo_update.cu").write_text(src.replace(BARRIER, ""))
    fused = make_fused()
    rc, text, _ = run_case(build_host(tmp_path, csrc), tmp_path, fused, 3, 0,
                           make_inputs(fused, gscale=1.0, kl=0.01))
    assert rc != 0 and any("WARNING: ThreadSanitizer: data race" in line for line in text), "\n".join(text)
