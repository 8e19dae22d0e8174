"""Where K1's team kernel spends its cycles, phase by phase, on the card.

Builds a copy of ``csrc/decimation.cu`` into ``build/kernels`` in which
thread 0 of block 0 reads ``clock64()`` after every team barrier and adds
the cycles since the previous reading to that barrier's line. The library is
built for ``--task``'s program (its sizes and team shape, as the wrapper
builds it). One launch of the team kernel then gives, per phase (named by
the comment above it in the source, summed over the substeps), the cycles
of one env's team from start to end. At a few envs the team runs alone and
the sum is the length of its dependent chain; at 4096 envs the SM's other
warps compete with it. The uninstrumented kernel is timed (CUDA events) at
the same env counts beside the one-thread kernel. Every call into the
instrumented library is checked, and a phase table whose cycles sum to 0 or
to more than the SM clock gives in the instrumented launch's own time (CUDA
events) stops the script.

    python -m wiki_grx_gym_tpu_torch.scripts.profile_k1 --envs 8 1056 4096
    python -m wiki_grx_gym_tpu_torch.scripts.profile_k1 --task GR1T1_full --envs 8 2112 4096 8192
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from wiki_grx_gym_tpu_torch import build as kbuild
from wiki_grx_gym_tpu_torch.sim import cuda_step

MARK = "__syncwarp(mask);"
HEAD = (
    "#include <cuda_runtime.h>\n"
    "__device__ long long k1p_acc[8192];\n"
    "__device__ long long k1p_last;\n"
    "#define K1PROF(L) if (threadIdx.x == 0 && blockIdx.x == 0) { long long t_ = clock64(); "
    "k1p_acc[L] += t_ - k1p_last; k1p_last = t_; }\n"
    "#define K1PSTART() if (threadIdx.x == 0 && blockIdx.x == 0) k1p_last = clock64();\n"
)
TAIL = (
    '\nextern "C" int k1p_read(long long* h) { cudaDeviceSynchronize(); '
    "return (int)cudaMemcpyFromSymbol(h, k1p_acc, sizeof(k1p_acc)); }\n"
    'extern "C" int k1p_zero() { static long long z[8192]; cudaMemcpyToSymbol(k1p_acc, z, sizeof(z)); '
    "return (int)cudaMemcpyToSymbol(k1p_last, z, sizeof(long long)); }\n"
    'extern "C" int k1p_clock_khz(int* khz) { int d = 0; cudaGetDevice(&d); '
    "return (int)cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, d); }\n"
)
_P, _INT = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "k1_set_constants": [_P, _INT, _P], "k1_launch": [_P, _P, _INT, _P],
    "k1p_zero": [], "k1p_read": [_P], "k1p_clock_khz": [ctypes.POINTER(_INT)],
}


def instrumented_source():
    """(instrumented source text, {line of the instrumented copy: phase
    label}): a reading after each team barrier of ``team_fk`` and the team
    kernel, the clock started once the block's inputs are in."""
    lines = cuda_step._SOURCE.read_text().splitlines()
    shift = HEAD.count("\n")
    start = next(i for i, s in enumerate(lines) if s.startswith("__device__") and " team_fk(" in s)
    labels, out, started = {}, [], False
    for i, s in enumerate(lines):
        if i > start and s.strip() == "__syncthreads();" and not started:
            s, started = s + " K1PSTART();", True
        elif i > start and s.strip() == MARK:
            # the phase's label: the first line of the nearest comment above
            # at the barrier's indentation or less
            ind = len(s) - len(s.lstrip())
            j = i
            while not (lines[j].strip().startswith("//") and len(lines[j]) - len(lines[j].lstrip()) <= ind):
                j -= 1
            while lines[j - 1].strip().startswith("//"):
                j -= 1
            labels[i + 1 + shift] = f"{lines[j].strip()[3:72]} (line {i + 1})"
            s = s + " K1PROF(__LINE__);"
        out.append(s)
    return HEAD + "\n".join(out) + "\n" + TAIL, labels


def load_instrumented(path, op):
    """The instrumented library for ``op``'s sizes and team shape, its
    entries declared; each returns a CUDA error code."""
    name = "k1_profiled_" + cuda_step.library_name(op.sizes)
    lib = ctypes.CDLL(str(kbuild.build(name, path, cuda_step.nvcc_flags(op.sizes))))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _INT
    return lib


def check(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def cuda_ms(fn, reps=20):
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="GR1T1")
    ap.add_argument("--envs", type=int, nargs="+", default=[8, 1056, 4096])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k1 needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print("card:", card)
    print("task:", args.task)
    src, labels = instrumented_source()
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = kbuild.BUILD_DIR / "decimation_profiled.cu"
    path.write_text(src)
    op, comp_all, _, _ = cuda_step.reachable_case(max(args.envs), dev, task=args.task)
    lib = load_instrumented(path, op)
    khz = _INT()
    check(lib.k1p_clock_khz, ctypes.byref(khz))
    stream = torch.cuda.current_stream()
    for n in args.envs:
        comp = comp_all[:, :n].contiguous()
        out = torch.empty((op.c_out, n), device=dev)
        team_ms = cuda_ms(lambda: op.launch_packed(comp, out))
        thread_ms = cuda_ms(lambda: op.launch_packed(comp, out, kernel="thread"))
        # the instrumented kernel: constants set by the wrapper's library are
        # copied into this one's symbols through its own k1_set_constants
        const = cuda_step._make_constants(op.deci, op.in_off, op.out_off, op.c_in, op.c_out)
        check(lib.k1_set_constants, ctypes.addressof(const), ctypes.sizeof(const), stream.cuda_stream)
        launch = lambda: check(lib.k1_launch, comp.data_ptr(), out.data_ptr(), n, stream.cuda_stream)
        launch()
        check(lib.k1p_zero)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record(stream)
        launch()
        t1.record(stream)
        acc = (ctypes.c_longlong * 8192)()
        check(lib.k1p_read, acc)
        prof_ms = t0.elapsed_time(t1)
        rows = [(labels[line], acc[line]) for line in sorted(labels) if acc[line]]
        total = sum(c for _, c in rows)
        limit = prof_ms * khz.value   # cycles at the SM's clock in the instrumented launch's time
        if not 0 < total <= limit:
            raise SystemExit(f"{n} envs: the phases sum to {total} cycles, outside (0, {limit:.0f}] "
                             f"(instrumented launch {prof_ms:.4f} ms at {khz.value} kHz)")
        print(f"\n{n} envs: team kernel {team_ms:.4f} ms, one-thread kernel {thread_ms:.4f} ms, "
              f"instrumented {prof_ms:.4f} ms (CUDA events); block 0's first team, {total} cycles "
              f"after the block setup ({100 * total / limit:.1f}% of the instrumented launch at "
              f"{khz.value / 1e3:.0f} MHz):")
        for label, c in rows:
            print(f"  {c:9d} cycles {100 * c / total:5.1f}%  {label}")


if __name__ == "__main__":
    main()
