"""K1's team kernel checked for races and memory errors, on the card or on the CPU.

Both ways run the host program ``csrc/k1_sanitize.cpp``: it reads K1's model
constants and a packed input (files this script writes for reachable states
of the task's training env, made on the CPU), launches the team kernel and
the one-thread kernel on the same input, and requires every output bit to
agree. K1 is built for the task's sizes and team shape. No PyTorch is in
the checked process.

- On the card (default): the program is linked against K1's library
  (built with line info) and run under compute-sanitizer's memcheck,
  racecheck (shared-memory hazards), synccheck (barriers and their masks)
  and initcheck (reads of unwritten device memory).
- ``--host``: the kernels are compiled for the CPU with g++
  (``csrc/host/k1_host.cpp``: each GPU thread a std::thread, the barriers
  and shuffles of ``csrc/host/cuda_runtime.h``) under ThreadSanitizer, which
  reports every pair of accesses to the same memory, one a write, that no
  barrier orders. Needs no card.

The default env counts are 64 (eight full blocks of the lower limb's 16 x 8
shape) and 61 (a ragged last block with a half-used warp). ``--terrain``
checks the program of a terrain mode (heightfield: ``local_plane``,
trimesh: ``local_plane_walls``; no post fold) on planted ground lanes that
run every contact branch (``cuda_step.planted_planes``). ``--program``
checks the all-terms fold (every reward term at a non-zero scale, contacts
penalized on the thighs and shanks, the states planted so that every
term is non-zero somewhere: ``cuda_step.all_terms_config``,
``planted_all_terms``) or the V or T control law. Any error a tool reports, or a differing bit, fails the
script. Logs go to ``build/k1_sanitize``.

    python -m wiki_grx_gym_tpu_torch.scripts.sanitize_k1 [--host] [--task GR1T1_full] [--envs 64 61]
        [--terrain trimesh | --program all_terms|V|T]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

import torch

from wiki_grx_gym_tpu_torch import build as kbuild
from wiki_grx_gym_tpu_torch.sim import cuda_step

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
OUT_DIR = kbuild.BUILD_DIR.parent / "k1_sanitize"
HOST_FLAGS = ["-std=c++17", "-O1", "-g", "-fsanitize=thread", "-ffp-contract=off", "-pthread"]


def sanitizer() -> str:
    cuda = Path(kbuild.nvcc()).resolve().parents[1]
    for cand in (cuda / "bin" / "compute-sanitizer", cuda / "compute-sanitizer" / "compute-sanitizer"):
        if cand.exists():
            return str(cand)
    found = shutil.which("compute-sanitizer")
    if not found:
        raise RuntimeError("compute-sanitizer not found beside nvcc or on PATH")
    return found


def build_harness(op) -> Path:
    """K1's library for ``op``'s sizes with -lineinfo, and the host program
    linked against it."""
    lib = kbuild.build(cuda_step.library_name(op.sizes) + "_lineinfo", cuda_step._SOURCE,
                       cuda_step.nvcc_flags(op.sizes) + ["-lineinfo"])
    exe = OUT_DIR / f"k1_sanitize_{cuda_step.library_name(op.sizes)}"
    cmd = [kbuild.nvcc(), "-std=c++17", "-O2", "-o", str(exe), str(kbuild.CSRC / "k1_sanitize.cpp"),
           str(lib), "-Xlinker", f"-rpath,{lib.parent}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the sanitizer harness failed:\n{res.stdout}\n{res.stderr}")
    return exe


def build_host(op, out_dir: Path = OUT_DIR, csrc: Path = kbuild.CSRC) -> Path:
    """The program with K1's kernels, for ``op``'s sizes and team shape,
    compiled for the CPU under ThreadSanitizer (from the sources in
    ``csrc``)."""
    exe = out_dir / f"k1_host_tsan_{cuda_step.library_name(op.sizes)}"
    cmd = ["g++", *HOST_FLAGS, *cuda_step.size_defines(op.sizes), "-I", str(csrc / "host"),
           str(csrc / "host" / "k1_host.cpp"),
           str(csrc / "k1_sanitize.cpp"), "-o", str(exe)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building K1 for the host failed:\n{res.stdout}\n{res.stderr}")
    return exe


# the programs --program selects (config changes, cuda_step)
PROGRAMS = {"all_terms": cuda_step.all_terms_config, "V": cuda_step.control_config("V"),
            "T": cuda_step.control_config("T")}


def write_case(n: int, out_dir: Path = OUT_DIR, task: str = "GR1T1", steps: int = 8, mutate=None,
               planted: bool = False, plant_terms: bool = False):
    """(constants file, input file, C_out): the files of
    ``csrc/k1_sanitize.cpp`` for ``n`` envs of ``task`` (``mutate`` applied
    to its config), ``steps`` policy steps after init
    (``cuda_step.reachable_case``; ``planted``: with planted ground lanes;
    ``plant_terms``: with ``cuda_step.planted_all_terms``), made on the CPU."""
    op, comp, _, _ = cuda_step.reachable_case(n, torch.device("cpu"), planted=planted, plant_terms=plant_terms,
                                              task=task, steps=steps, mutate=mutate)
    const = cuda_step._make_constants(op.deci, op.in_off, op.out_off, op.c_in, op.c_out)
    tag = task if mutate is None else f"{task}_{mutate.__name__}"
    const_path, in_path = out_dir / f"constants_{tag}_{n}.bin", out_dir / f"input_{tag}_{n}.bin"
    const_path.write_bytes(bytes(const))
    in_path.write_bytes(comp.numpy().tobytes())
    return const_path, in_path, op.c_out


def run(cmd, timeout=900):
    """(return code, output lines) of one checked run."""
    res = subprocess.run([str(c) for c in cmd], capture_output=True, text=True, timeout=timeout)
    return res.returncode, (res.stdout + res.stderr).strip().splitlines()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, nargs="+", default=[64, 61])
    ap.add_argument("--task", default="GR1T1", help="the training env whose sizes K1 is built for")
    ap.add_argument("--host", action="store_true", help="ThreadSanitizer on the CPU instead of the card")
    ap.add_argument("--terrain", choices=("heightfield", "trimesh"),
                    help="K1's program for this terrain (no post fold), on a 2 x 2 grid, the "
                         "ground lanes planted so that every contact branch runs")
    ap.add_argument("--program", choices=sorted(PROGRAMS),
                    help="K1's all-terms fold (every reward term, penalized contact groups; "
                         "some envs dropped so that they touch) or the V or T control law")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    mutate = None if args.terrain is None else cuda_step.terrain_config(args.terrain, 2, 2)
    if args.program is not None:
        mutate = PROGRAMS[args.program]
    op = cuda_step.task_env(args.task, 1, "cpu", mutate).decimation_op
    if args.host:
        exe, checks = build_host(op), [("threadsanitizer", [])]
    else:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        print("card:", card, flush=True)
        exe, tool_exe = build_harness(op), sanitizer()
        checks = [(tool, [tool_exe, "--tool", tool, "--error-exitcode", "99"]) for tool in TOOLS]
    failed = []
    for n in args.envs:
        case = write_case(n, task=args.task, mutate=mutate, planted=args.terrain is not None,
                          plant_terms=args.program == "all_terms")
        for name, prefix in checks:
            rc, text = run([*prefix, exe, *case[:2], n, case[2]])
            tag = args.task if mutate is None else f"{args.task}_{mutate.__name__}"
            (OUT_DIR / f"{name}_{tag}_{n}.log").write_text("\n".join(text) + "\n")
            summary = [l for l in text if "SUMMARY" in l or "k1_sanitize" in l]
            print(f"{name} at {n} envs: rc {rc}; " + " | ".join(summary), flush=True)
            if rc != 0:
                failed.append(f"{name} at {n} envs")
                print("\n".join(text[-40:]), flush=True)
    if failed:
        raise SystemExit(f"failed: {', '.join(failed)} (logs in {OUT_DIR})")
    print(f"{', '.join(name for name, _ in checks)}: clean at {args.envs} envs")


if __name__ == "__main__":
    main()
