"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's iterations), ``failed`` (those whose loss was
not finite), ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared with its limit, which are also the last lines of standard error.

Without a card, or with fewer cards than the cell asks for, it exits with 2
and prints no result. A cell on several cards runs one process a card
(rank 0 is this one) over NCCL, as the port's ``--distributed`` training
does. Set-up time runs from this module's first line to the window's start.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# the program's kernel caches, at fixed paths inside the checkout (the port's
# own nvcc builds go to build/kernels there)
CACHES = {"TRITON_CACHE_DIR": "build/bench_cache/triton", "TORCH_EXTENSIONS_DIR": "build/bench_cache/torch_extensions",
          "CUDA_CACHE_PATH": "build/bench_cache/cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "wiki_grx_gym_tpu")


def set_caches():
    for var, rel in CACHES.items():
        path = CHECKOUT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def forbidden_modules():
    """The modules loaded in this process whose top-level name (the part
    before the first dot) is JAX's, flax's or the JAX package's, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else f"nvidia-smi: {res.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _child(rank, world, init_method, rank_fn, args):
    set_caches()
    rank_fn(rank, world, init_method, *args)


def across_ranks(world: int, rank_fn, *args):
    """``rank_fn(rank, world, init_method, *args)`` on ``world`` ranks: rank
    0 in this process, the others in spawned processes (one a card), which
    are waited for and killed if they outlive rank 0 by two minutes.
    Returns rank 0's value; raises if a rank failed."""
    import shutil

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    rendezvous = tempfile.mkdtemp(prefix="benchmark_rdv_")
    init_method = f"file://{os.path.join(rendezvous, 'group')}"
    procs = [ctx.Process(target=_child, args=(r, world, init_method, rank_fn, args), daemon=True)
             for r in range(1, world)]
    try:
        for p in procs:
            p.start()
        value = rank_fn(0, world, init_method, *args)
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"rank processes failed: exit codes {codes}")
    return value


def gather(out, rank, world, group):
    """Every rank's ``out`` to rank 0 over the benchmark's gloo ``group``
    (the list on rank 0, None elsewhere)."""
    import torch.distributed as dist

    every = [None] * world if rank == 0 else None
    dist.gather_object(out, every, dst=0, group=group)
    return every


def _gather(out, rank, world):
    """Every rank's run results to rank 0, then the groups torn down."""
    from benchmark import program

    every = gather({k: v for k, v in out.items() if k not in ("dp", "ctl")}, rank, world, out["ctl"])
    program.destroy_group(out["dp"])
    return every


def _run_rank(rank, world, init_method, cell, seed, seconds, trace, t_start):
    from benchmark import session

    out = session.run_rank(rank, world, cell, seed, seconds, trace, t_start if rank == 0 else time.perf_counter(),
                           init_method)
    return _gather(out, rank, world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec

    bench = spec.load_benchmark()
    cell = spec.cell(args.workload, bench)
    chips = int(cell["workload"]["chips"])
    set_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), this machine has {have}; no result",
              file=sys.stderr)
        return 2
    from benchmark import report, session

    print(f"benchmark: {args.workload} seed {args.seed} on {card_line()} x {chips}", flush=True)
    if chips == 1:
        results = [session.run_rank(0, 1, cell, args.seed, args.seconds, bool(args.trace), T_START)]
    else:
        results = across_ranks(chips, _run_rank, cell, args.seed, args.seconds, bool(args.trace), T_START)
    line, checks = report.result(bench, cell, results, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad} (JAX or the JAX package); no result", file=sys.stderr)
        return 4
    for text in checks:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
