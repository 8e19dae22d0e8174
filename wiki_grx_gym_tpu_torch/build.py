"""nvcc builds of the port's CUDA sources, and the kernels' launch counts.

Each kernel source in ``csrc/`` is compiled by :func:`build` on its own,
with its own flags, into a shared library with a plain C interface that its
wrapper loads with ``ctypes``. Libraries go to the checkout's
``build/kernels`` directory (listed in .gitignore), named by the library
name and a hash of the source and the flags, so a changed source or flag set
builds anew and an unchanged one is reused.

``LAUNCHES`` holds one count per kernel (``k1`` decimation, ``k2`` PPO
gradient chain, ``k3`` whole PPO update). Each wrapper adds one where it
launches its kernel and nowhere else (:func:`count_launch`). Inside the
capture of a CUDA graph nothing runs: there the launch goes to the capture's
:class:`LaunchTally`, and each replay of the graph adds the tally.
"""

from __future__ import annotations

import gc
import hashlib
import os
import re
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v prints
# each kernel's registers and spills (kept in BUILD_INFO)
BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES = {"k1": 0, "k2": 0, "k3": 0}

# per library name: path, nvcc seconds, ptxas register/spill lines, command
BUILD_INFO: Dict[str, dict] = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class LaunchTally:
    """The kernel launches that a CUDA graph's capture recorded (``counts``),
    and what the host must do after each replay (``after_replay``: e.g. K1
    noting whose constants the replay left in its ``__constant__`` memory).
    :meth:`replayed` adds the counts to ``LAUNCHES`` once per replay."""

    def __init__(self):
        self.counts = dict.fromkeys(LAUNCHES, 0)
        self.after_replay = []

    def replayed(self):
        for k, n in self.counts.items():
            LAUNCHES[k] += n
        for fn in self.after_replay:
            fn()


_TALLIES: List[LaunchTally] = []   # the captures under way, innermost last


@contextmanager
def capture_tally():
    """Collect the launches of the capture inside the block into a new
    :class:`LaunchTally` (yielded) instead of ``LAUNCHES``."""
    tally = LaunchTally()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


@contextmanager
def gc_held():
    """Python's cyclic garbage collector run once, then held off inside the
    block (a CUDA graph's capture): a collection there could free a graph
    captured before (a dropped ``learn/graphs.CompiledIteration`` is a
    reference cycle), and a capture refuses that graph's
    ``cudaGraphExecDestroy`` and ends failed."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def current_tally():
    """The tally of the capture under way, or None."""
    return _TALLIES[-1] if _TALLIES else None


def count_launch(kernel: str):
    """One launch of ``kernel`` by its wrapper: to ``LAUNCHES``, or inside a
    capture to the capture's tally."""
    tally = current_tally()
    if tally is None:
        LAUNCHES[kernel] += 1
    else:
        tally.counts[kernel] += 1


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")
    return found


def library_path(name: str, source: Path, flags: Sequence[str]) -> Path:
    tag = hashlib.sha1(Path(source).read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str, source: Path, flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``flags`` into ``build/kernels/lib<name>_<tag>.so``
    unless that file exists. Records the build in ``BUILD_INFO[name]``;
    raises with nvcc's output if the build fails."""
    info = BUILD_INFO.setdefault(name, {})
    out = library_path(name, source, flags)
    if out.exists():
        info.setdefault("path", str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd: List[str] = [nvcc(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    ptxas = [l.strip() for l in (res.stdout + res.stderr).splitlines()
             if "registers" in l or "spill" in l or "Compiling entry" in l]
    info.update(path=str(out), seconds=secs, ptxas=ptxas, cmd=" ".join(cmd))
    return out


def ptxas_summary(lines) -> Dict[str, dict]:
    """ptxas' report (-Xptxas -v) per kernel: {mangled name: {registers,
    spill_stores, spill_loads}}."""
    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out
