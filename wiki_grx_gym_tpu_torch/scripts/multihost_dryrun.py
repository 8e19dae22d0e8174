"""Data- and tensor-parallel dry run on the CPU (port of
``tools/multihost_dryrun.py`` and of ``__graft_entry__.dryrun_multichip``'s
dp x mp pass): the multi-process path of a GPU run
(``init_process_group``, the mesh, the sharded envs, the gradient
all-reduce, the lead-only writes) on one machine, as ``--procs`` local
processes over gloo.

    python -m wiki_grx_gym_tpu_torch.scripts.multihost_dryrun [--procs 2] [--num_mp 1]
        [--iters 2] [--num-envs 16] [--log-root DIR]

The ranks form a ``procs / num_mp`` (dp) x ``num_mp`` (mp) mesh; each
trains GR1T1 on its dp shard's ``num_envs / (procs / num_mp)`` envs
(decimation 2, 4 steps an env, 2 minibatches, 1 epoch) with its own log
directory under ``--log-root``. Exit code 0 = every rank finished with
finite losses, params that moved and identical peers (bit-identical learner
states in each dp group; under mp also identical replicated leaves, env
states and metrics), and only rank 0 wrote logs and checkpoints. A GPU run
of the same path is

    torchrun --nproc_per_node=K -m wiki_grx_gym_tpu_torch.scripts.train --distributed [--num_mp M] ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile


def worker(rank, world, init_method, num_envs, iters, log_root, num_mp=1):
    import torch

    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.parallel import mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = mesh.init_distributed(init_method=init_method, world_size=world, rank=rank, device="cpu",
                                  timeout_s=120)
    try:
        dp = mesh.make_mesh(num_mp, group)
        env_cfg, train_cfg = task_registry.get_cfgs("GR1T1")
        env_cfg.env.num_envs = num_envs
        env_cfg.control.decimation = 2
        train_cfg.runner.num_steps_per_env = 4
        train_cfg.algorithm.num_mini_batches = 2
        train_cfg.algorithm.num_learning_epochs = 1
        env, _ = task_registry.make_env("GR1T1", env_cfg=env_cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg,
                                                  log_root=os.path.join(log_root, f"rank{rank}"), dp=dp)
        start = runner.init_state(init_at_random_ep_len=True)
        p0 = start.ppo.params.clone()
        # learn() checks the peers after every update and raises if they differ
        state = runner.learn(iters, state=start)
        losses = [h["metrics"][k] for h in runner.log_history for k in ("value_loss", "surrogate_loss", "kl")]
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"rank {rank}: non-finite losses {losses}")
        moved = float((state.ppo.params - p0).abs().max())
        if not moved > 0:
            raise RuntimeError(f"rank {rank}: the params did not move")
        print(json.dumps({"rank": rank, "world": world, "num_mp": num_mp, "envs": env.num_envs,
                          "params": runner.net.num_params, "path": runner.alg.path, "moved": moved,
                          "value_loss": runner.log_history[-1]["metrics"]["value_loss"],
                          "digests_equal": all(bool((d == d[0]).all()) for d in runner.replica_digests)}),
              flush=True)
    finally:
        mesh.destroy(group)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--num_mp", type=int, default=1, help="tensor-parallel ways (procs must be a multiple)")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--num-envs", type=int, default=16)
    ap.add_argument("--log-root", default=None, help="default: a temporary directory")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    from wiki_grx_gym_tpu_torch.parallel.launch import spawn

    with tempfile.TemporaryDirectory() as tmp:
        log_root = args.log_root or os.path.join(tmp, "logs")
        spawn(worker, args.procs, args=(args.num_envs, args.iters, log_root, args.num_mp), rendezvous_dir=tmp,
              timeout_s=args.timeout)
        wrote = {r: os.path.isdir(os.path.join(log_root, f"rank{r}")) for r in range(args.procs)}
        lead = os.path.join(log_root, "rank0")
        ckpts = [f for _, _, files in os.walk(lead) for f in files if f.startswith("model_")]
        ok = wrote[0] and ckpts and not any(wrote[r] for r in range(1, args.procs))
        print(f"multihost_dryrun: procs={args.procs} num_mp={args.num_mp} wrote logs {wrote}, rank 0 checkpoints {sorted(ckpts)} "
              f"-> {'OK' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
