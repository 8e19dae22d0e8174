#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``wiki_grx_gym_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the decimation kernel K1 (``csrc/decimation.cu``) with nvcc into
   ``build/kernels``; print the build time and ptxas' register/spill report.
3. K1 against its plain PyTorch version (the lane program) on the card:
   4096 envs of the GR1T1 training config (noise, domain randomization,
   pushes, actuation delay on), reachable states (``init_state`` + a few
   steps with random actions), one policy step through each. Every float
   output must agree within rtol 1e-4 / atol 1e-4 (atol 1e-2 N for the
   contact forces), in all but at most 0.1% of the envs: ten stiff substeps
   amplify last-bit rounding differences, and in a few chaotic envs they
   exceed that tolerance, as threshold flips do for the boolean lanes.
   Those envs together (a boolean lane differs, or a float lane is over the
   stated tolerance) may be at most 0.1% of all; in the envs over the float
   tolerance each output must still lie within it plus 3x the float32 noise
   floor of the plain program on that output group (its float32 result
   against float64 on the same input, largest over the envs without a
   boolean flip). Times K1 per launch (CUDA events), the plain version, and
   computes K1's bound.
4. The slice: ``OnPolicyRunner(...).init_state()`` and one 64-step rollout
   at 4096 envs (K1 must launch exactly 64 times; all outputs finite), then
   the port's ``play`` loop for 20 steps from a seeded ``policy.npz``.
5. Print the kernels' JSON line, the card line, and the final ok line.
"""

import json
import math
import os
import subprocess
import sys
import time

THIS = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 4096
ROLLOUT_STEPS = 64
PLAY_STEPS = 20
FP32_PEAK = 67e12      # H100 SXM FP32 FLOP/s outside the tensor cores (data sheet;
                       # an FMA counts as two operations)
HBM_RATE = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
RTOL, ATOL, ATOL_FORCE = 1e-4, 1e-4, 1e-2
FORCE_GROUPS = ("force_sum", "point_force")   # contact forces, newtons
BOOL_GROUPS = ("post/term_contact", "post/tilt", "post/bad", "post/feet_contact",
               "post/contact_filt", "post/first_contact")


def log(*a):
    print(*a, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def groups(res):
    """Every output group of the K1 wrapper's return tuple, float64."""
    g = {f: getattr(res[0], f) for f in ("base_pos", "base_quat", "base_lin_vel",
                                         "base_ang_vel", "q", "qd", "anchor")}
    g.update(force_sum=res[1], vxyz_sum=res[2], vrpy_sum=res[3], tau=res[4],
             point_force=res[5], post_rel=res[6][0], post_quat=res[6][1])
    g.update({"post/" + k: v for k, v in res[8].items()})
    return {k: v.double().reshape(v.shape[0], -1) for k, v in g.items()}


def decimation_inputs(env, state, gen, dtype=None):
    """The arguments env.step hands K1, on fresh random actions and delays."""
    import torch

    n = env.num_envs
    actions = env.clip_actions(0.3 * torch.randn(n, env.num_actions, device=env.device, generator=gen))
    delay = 3.0 * torch.rand(n, device=env.device, generator=gen)
    extra = {
        "commands": state.commands[:, :3], "last_last_actions": state.last_last_actions,
        "feet_air_time": state.feet_air_time, "feet_land_time": state.feet_land_time,
        "feet_contact_last": state.feet_contact_last.to(torch.float32),
    }
    c = (lambda x: x.to(dtype)) if dtype is not None else (lambda x: x)
    phys = state.physics.replace(**{k: c(getattr(state.physics, k)) for k in (
        "base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")})
    rand = state.rand.replace(**{k: c(getattr(state.rand, k)) for k in (
        "friction", "restitution", "base_mass_scale", "base_com_offset")})
    args = (phys, c(actions), c(state.last_actions), c(state.motor_strength), c(delay), rand)
    kw = dict(last_qd=c(state.last_dof_vel), extra={k: c(v) for k, v in extra.items()})
    return args, kw


def count_plain_ops():
    """Floating-point operations of the plain lane program per env and
    policy step: every elementwise arithmetic, comparison and select op run
    at N=1 counts one per output element (views, copies and stacking do not
    count)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from wiki_grx_gym_tpu_torch.envs import task_registry

    skip = ("view", "stack", "cat", "clone", "copy", "zeros", "ones", "empty", "full",
            "select", "slice", "unsqueeze", "squeeze", "expand", "_to_copy", "lift",
            "detach", "alias", "t.", "transpose", "reshape", "unbind", "scalar_tensor",
            "_local_scalar", "as_strided", "split", "unsafe", "broadcast")

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket.__name__) + "."
            if not any(name.startswith(s) for s in skip) and isinstance(out, torch.Tensor):
                Count.ops += out.numel()
            return out

    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 1
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    state = env.init_state(0)
    args, kw = decimation_inputs(env, state, torch.Generator().manual_seed(0))
    with Count():
        env.decimation_op.plain(*args, **kw)
    return Count.ops


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    log("card:", card)
    sys.path.insert(0, THIS)
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 2: build K1 ----
    t0 = time.perf_counter()
    cuda_step.build_library()
    build_s = time.perf_counter() - t0
    ptxas = cuda_step.BUILD_INFO.get("ptxas", [])
    log(f"[build] K1 built in {build_s:.1f} s ({cuda_step.BUILD_INFO.get('seconds', 0.0):.1f} s nvcc)")
    for line in ptxas:
        log("[build] ptxas:", line)

    # ---- phase 3: K1 against its plain version, 4096 envs ----
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = env.init_state(gen)
    for _ in range(8):   # reachable states: the robots land on their feet
        state, _ = env.step(state, 0.3 * torch.randn(env.num_envs, env.num_actions, device=dev,
                                                       generator=gen))
    op = env.decimation_op
    gen_in = torch.Generator(device=dev)
    gen_in.manual_seed(1)
    args, kw = decimation_inputs(env, state, gen_in)
    gen_in.manual_seed(1)
    args64, kw64 = decimation_inputs(env, state, gen_in, dtype=torch.float64)
    k = groups(op(*args, **kw))
    p = groups(op.plain(*args, **kw))
    p64 = groups(op.plain(*args64, **kw64))
    torch.cuda.synchronize()
    flips = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)
    for name in BOOL_GROUPS:
        flips |= (k[name] != p[name]).any(dim=1)
    keep = ~flips
    over = torch.zeros(N_ENVS, dtype=torch.bool, device=dev)   # over the stated tolerance
    widened_ok, max_abs_err = True, 0.0
    for name in k:
        if name in BOOL_GROUPS:
            continue
        a, b, b64 = k[name], p[name], p64[name]
        if not (torch.isfinite(a[keep]).all() and torch.isfinite(b[keep]).all()):
            raise SystemExit(f"K1 vs plain: {name} has non-finite values")
        err = (a - b).abs()
        atol = ATOL_FORCE if name in FORCE_GROUPS else ATOL
        stated = atol + RTOL * b.abs()
        floor = float((b - b64)[keep].abs().max())
        env_over = (err > stated).any(dim=1) & keep
        over |= env_over
        good = bool((err[keep] <= stated[keep] + 3.0 * floor).all())
        widened_ok &= good
        rel = float((err[keep] / (b[keep].abs() + 1e-6)).max())
        if name not in FORCE_GROUPS:
            max_abs_err = max(max_abs_err, float(err[keep].max()))
        log(f"[K1 vs plain] {name:26s} max_abs {float(err[keep].max()):.3e} max_rel {rel:.3e} "
            f"envs over rtol {RTOL:g}/atol {atol:g}: {int(env_over.sum())}; "
            f"f32 noise floor {floor:.3e}; within stated + 3 x floor {good}")
    divergent = flips | over
    div_frac = float(divergent.float().mean())
    log(f"[K1 vs plain] {N_ENVS} envs: boolean lanes differ in {int(flips.sum())}, float lanes "
        f"over the stated tolerance in {int(over.sum())}; together {int(divergent.sum())} envs "
        f"({100 * div_frac:.3f}%, limit 0.1%)")
    force_err = max(float((k[g] - p[g])[keep].abs().max()) for g in FORCE_GROUPS)
    if div_frac > 1e-3 or not widened_ok:
        raise SystemExit("K1 disagrees with its plain version")

    # timing: K1 alone on packed buffers, the wrapper, and the plain version
    lib = cuda_step._load()
    comp = op._pack(*args[:6], kw["last_qd"], kw["extra"])
    out = torch.empty((op.c_out, N_ENVS), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.k1_launch(comp.data_ptr(), out.data_ptr(), N_ENVS, stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")

    k1_ms = cuda_ms(launch, reps=50, warmup=3)
    wrapper_ms = cuda_ms(lambda: op(*args, **kw), reps=20, warmup=2)
    plain_ms = cuda_ms(lambda: op.plain(*args, **kw), reps=2, warmup=1)
    ops_per_env = count_plain_ops()
    bytes_moved = (op.c_in + op.c_out) * 4 * N_ENVS
    ops_ms = ops_per_env * N_ENVS / FP32_PEAK * 1e3
    bytes_ms = bytes_moved / HBM_RATE * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    # K1 is built with --fmad=false: no FMA pairing, so its attainable rate
    # for these ops is half the peak
    ops_ms_no_fma = 2.0 * ops_ms
    log(f"[K1] {k1_ms:.4f} ms/launch at {N_ENVS} envs (wrapper incl. pack/unpack "
        f"{wrapper_ms:.4f} ms); plain {plain_ms:.2f} ms; ops/env/step {ops_per_env}; "
        f"bound {bound_ms:.4f} ms by {bound_by} (ops {ops_ms:.4f} ms, {ops_ms_no_fma:.4f} ms "
        f"without FMA pairing; bytes {bytes_ms:.4f} ms)")

    # ---- phase 4: the slice's main path ----
    del env, state, op, comp, out, args, kw, args64, kw64, k, p, p64
    torch.cuda.empty_cache()
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner = OnPolicyRunner(env, train_cfg, device=dev)
    assert runner.num_steps_per_env == ROLLOUT_STEPS
    rs = runner.init_state()
    rs, _, _ = runner.rollout(rs)   # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_step.reset_launch_counts()
    t0 = time.perf_counter()
    rs, batch, acc = runner.rollout(rs)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    rollout_launches = cuda_step.LAUNCHES["k1"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, v in list(batch._asdict().items()) + list(acc.items()):
        if name != "dones" and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"rollout output {name} is not finite")
    assert batch.obs.shape == (ROLLOUT_STEPS, N_ENVS, 39), batch.obs.shape
    assert batch.critic_obs.shape == (ROLLOUT_STEPS, N_ENVS, 168), batch.critic_obs.shape
    assert batch.actions.shape == (ROLLOUT_STEPS, N_ENVS, 10)
    if rollout_launches != ROLLOUT_STEPS:
        raise SystemExit(f"K1 launched {rollout_launches} times in a {ROLLOUT_STEPS}-step rollout")
    steps_per_s = ROLLOUT_STEPS * N_ENVS / rollout_s
    log(f"[rollout] {ROLLOUT_STEPS} steps x {N_ENVS} envs in {rollout_s:.3f} s = "
        f"{steps_per_s:.0f} env-steps/s; K1 launches {rollout_launches}; "
        f"mean reward {float(acc['rew'].mean()) / ROLLOUT_STEPS:.4f}; dones {int(acc['done'].sum())}; "
        f"peak memory {peak_gib:.3f} GiB")

    import numpy as np

    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    rng = np.random.RandomState(0)
    dims = [39, 512, 256, 128, 10]
    blob = {}
    for i in range(4):
        bound = 1.0 / math.sqrt(dims[i])
        blob[f"actor_w{i}"] = rng.uniform(-bound, bound, (dims[i], dims[i + 1])).astype(np.float32)
        blob[f"actor_b{i}"] = rng.uniform(-bound, bound, dims[i + 1]).astype(np.float32)
    blob["std"] = np.full(10, 0.2, np.float32)
    blob["activation"] = np.asarray("elu")
    os.makedirs(os.path.join(THIS, "build"), exist_ok=True)
    npz = os.path.join(THIS, "build", "smoke_policy.npz")
    np.savez(npz, **blob)
    before = cuda_step.LAUNCHES["k1"]
    play_log = play(get_args(["--task", "GR1T1", "--policy", npz, "--device", "cuda"]),
                    num_steps=PLAY_STEPS)
    play_launches = cuda_step.LAUNCHES["k1"] - before
    if play_launches != PLAY_STEPS + 1:
        raise SystemExit(f"play launched K1 {play_launches} times for {PLAY_STEPS} steps + init")
    if not all(math.isfinite(v) for key, vals in play_log.items() if key != "dones" for v in vals):
        raise SystemExit("play produced non-finite values")
    main_path_launches = cuda_step.LAUNCHES["k1"]
    log(f"[play] {PLAY_STEPS} steps, K1 launches {play_launches} (incl. the init step)")

    # where the rollout's time goes: one more rollout under torch.profiler
    # (after the launch counts were read; the profiler slows the host side)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs, _, _ = runner.rollout(rs)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device kernel rows only (operator rows repeat their kernels' time)
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    dev_total_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_dev_ms = sum(dev_us(e) for e in kern if "decimation_kernel" in e.key) / 1e3
    if dev_total_ms > 0:
        log(f"[profile] rollout under the profiler {prof_s * 1e3:.1f} ms wall; device kernels "
            f"{dev_total_ms:.1f} ms in {sum(e.count for e in kern)} launches "
            f"({dev_total_ms / ROLLOUT_STEPS:.3f} ms per step); K1 {k1_dev_ms:.1f} ms; device busy "
            f"{100 * dev_total_ms / (rollout_s * 1e3):.1f}% of the unprofiled rollout's "
            f"{rollout_s * 1e3:.1f} ms")
        for e in kern[:8]:
            log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    else:
        log("[profile] the profiler saw no device time; device busy share not measured")

    kernels = [{
        "name": "K1 decimation (GR1T1 lower limb, plane, post fold)",
        "route": "cuda",
        "source": "wiki_grx_gym_tpu_torch/csrc/decimation.cu",
        "replaces": "wiki_grx_gym_tpu/sim/pallas_step.py:149",
        "launches": main_path_launches,
        "max_abs_err": max_abs_err,
        "max_abs_err_forces": force_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ms_no_fma": max(ops_ms_no_fma, bytes_ms),
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
        "envs": N_ENVS,
        "ops_per_env_step": ops_per_env,
        "bytes": bytes_moved,
        "build_s": build_s,
        "ptxas": ptxas,
        "rollout_env_steps_per_s": steps_per_s,
        "rollout_launches": rollout_launches,
        "peak_mem_gib": peak_gib,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
