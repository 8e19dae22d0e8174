"""Time K1's kernels alone on one task's reachable states, on the card.

Builds K1 for the task's program (``sim/cuda_step.py``), makes 4096 (or
``--envs``) reachable states of its training config (``cuda_step.
reachable_state``) and times the team kernel and the one-thread kernel on
the same packed input with CUDA events, ``--reps`` launches a round, the two
in turns for ``--rounds`` rounds. Prints the card and one JSON line.

It uses only what the wrapper has had since the kernels were built per
program, so the file can time another checkout's package: run it by path
with that checkout first on ``PYTHONPATH`` to compare two trees in one
process each (parent, change, change, parent):

    python wiki_grx_gym_tpu_torch/scripts/time_k1.py --task GR1T1_full
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None):
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="GR1T1")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_k1 needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    env, state = cuda_step.reachable_state(args.envs, dev, task=args.task)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a, kw = cuda_step.decimation_inputs(env, state, gen)
    op = env.decimation_op
    comp = op._pack(*a, kw["last_qd"], kw["extra"])
    out = torch.empty((op.c_out, args.envs), dtype=torch.float32, device=dev)
    team, thread = [], []
    for _ in range(args.rounds):
        team.append(cuda_ms(lambda: op.launch_packed(comp, out), args.reps))
        thread.append(cuda_ms(lambda: op.launch_packed(comp, out, kernel="thread"), args.reps))
    print("card:", card, flush=True)
    print(json.dumps({"task": args.task, "envs": args.envs, "package": cuda_step.__file__,
                      "team_ms": team, "thread_ms": thread}), flush=True)


if __name__ == "__main__":
    main()
