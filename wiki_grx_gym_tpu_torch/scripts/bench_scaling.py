"""Scaling harness (port of ``wiki_grx_gym_tpu/scripts/bench_scaling.py``):
training env-steps/s per GPU as the data-parallel group grows.

    python -m wiki_grx_gym_tpu_torch.scripts.bench_scaling [--envs_per_dev 4096]
        [--steps 64] [--iters 3]
    python -m wiki_grx_gym_tpu_torch.scripts.bench_scaling --device cpu --max_procs 2 \\
        --envs_per_dev 8 --steps 4 --iters 1     # the same program over gloo on the CPU

For each group size K in 1, 2, 4, 8 up to the GPUs the machine has (or
``--max_procs`` CPU processes), K ranks (NCCL, one GPU each; gloo on the
CPU) train GR1T1 with ``envs_per_dev`` envs each: one warm-up iteration
(over NCCL the compiled iteration's warm-up and captures), then
``--iters`` timed ones. Prints one JSON line per K: the device, the
iteration (``compiled``, CUDA graph replays with the collectives captured,
over NCCL: GR1T1 takes the step path at K > 1; ``eager`` and why over gloo
or on the CPU), the update path,
env-steps/s in all and per rank, and the per-rank rate over K = 1's
(scaling efficiency). The envs need no collective; the update all-reduces
the gradient once a grad step (K2 per shard at K > 1, K3's whole update at
K = 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def worker(rank, world, init_method, args, out_path):
    import torch

    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.parallel import mesh
    from wiki_grx_gym_tpu_torch.parallel.launch import stage

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dp = mesh.init_distributed(init_method=init_method, world_size=world, rank=rank, device=args.device)
    try:
        env_cfg, train_cfg = task_registry.get_cfgs("GR1T1")
        env_cfg.env.num_envs = args.envs_per_dev * world
        train_cfg.runner.num_steps_per_env = args.steps
        env, _ = task_registry.make_env("GR1T1", env_cfg=env_cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None, dp=dp)
        stage("the warm-up iteration")
        state = runner.learn(1)   # warm-up
        stage("the timed iterations")
        t0 = time.perf_counter()
        runner.learn(args.iters, state=state)
        dt = time.perf_counter() - t0
        stage("teardown")
        if dp.is_lead:
            fps = args.iters * args.steps * env.num_envs_global / dt
            kind = torch.cuda.get_device_name(dp.device) if dp.device.type == "cuda" else "cpu"
            why = runner.eager_reason
            with open(out_path, "w") as f:
                json.dump({"devices": world, "device": kind, "backend": dp.backend,
                           "iteration": "compiled" if why is None else f"eager ({why})", "path": runner.alg.path,
                           "envs": env.num_envs_global, "env_steps_per_s": fps,
                           "per_device": fps / world}, f)
    finally:
        mesh.destroy(dp)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs_per_dev", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--max_procs", type=int, default=None, help="largest group (default: every GPU)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for each group size (past it its ranks are killed and the run fails, naming "
                         "where each rank stopped)")
    args = ap.parse_args(argv)

    import torch

    from wiki_grx_gym_tpu_torch.parallel.launch import spawn

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: no CUDA card (pass --device cpu for the gloo program on the CPU)")
        have = torch.cuda.device_count()
    else:
        have = args.max_procs or 1
    limit = min(have, args.max_procs or have)
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for k in (n for n in (1, 2, 4, 8, 16) if n <= limit):
            out = os.path.join(tmp, f"bench_{k}.json")
            spawn(worker, k, args=(args, out), rendezvous_dir=tmp, timeout_s=args.timeout)
            with open(out) as f:
                row = json.load(f)
            base = base or row["per_device"]
            row["scaling_efficiency"] = row["per_device"] / base
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
