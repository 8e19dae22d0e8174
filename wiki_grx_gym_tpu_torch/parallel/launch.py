"""Start the ranks of a data-parallel group as local processes, with a time
limit.

A rank that dies before a collective leaves the others waiting in it, so
:func:`spawn` joins with a deadline of its own: past it every child is
killed and the call raises. Each rank runs ``fn(rank, world, init_method,
*args)`` in a fresh ``spawn`` process (``fn`` is pickled by import path);
``init_method`` is a ``file://`` rendezvous in a directory the caller owns,
so two groups on one machine never share a TCP port.

A rank names what it is doing with :func:`stage` (one line in a file beside
the rendezvous); a group that misses its deadline raises with every rank's
last stage, so a hang says where each rank stopped.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch.multiprocessing as mp

# this process's stage file, set where spawn started it
_STAGE_PATH: Optional[str] = None


def file_init_method(directory: str, name: str = "rendezvous") -> str:
    """A ``file://`` init method under ``directory`` (which must exist); the
    file must not exist before the group forms."""
    path = os.path.join(os.path.abspath(directory), name)
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def stage(what: str) -> None:
    """Record ``what`` as this rank's current stage (read by :func:`spawn`
    if the group misses its deadline); nothing outside a spawned rank."""
    if _STAGE_PATH is None:
        return
    tmp = f"{_STAGE_PATH}.tmp"
    with open(tmp, "w") as fh:
        fh.write(what)
    os.replace(tmp, _STAGE_PATH)


def _stage_file(directory: str, rank: int) -> str:
    return os.path.join(directory, f"stage_rank{rank}")


def _rank_main(rank, fn, stage_dir, *args):
    global _STAGE_PATH
    _STAGE_PATH = _stage_file(stage_dir, rank)
    stage("started")
    fn(rank, *args)


def _stages(directory: str, world: int) -> str:
    """Every rank's last :func:`stage` under ``directory``, on one line."""
    out = []
    for r in range(world):
        try:
            with open(_stage_file(directory, r)) as fh:
                out.append(f"rank {r} at '{fh.read()}'")
        except OSError:
            out.append(f"rank {r} never started")
    return "; ".join(out)


def spawn(fn, world: int, args=(), rendezvous_dir: str = ".", timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes and
    wait for all of them. Raises if a rank raises or exits non-zero (the
    others are then killed), or if they have not all finished within
    ``timeout_s`` seconds (every child is killed; the error names each
    rank's last :func:`stage`)."""
    stage_dir = os.path.abspath(rendezvous_dir)
    for r in range(world):
        if os.path.exists(_stage_file(stage_dir, r)):
            os.remove(_stage_file(stage_dir, r))
    init = file_init_method(rendezvous_dir)
    ctx = mp.start_processes(_rank_main, args=(fn, stage_dir, world, init, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not finish "
                                   f"within {timeout_s:.0f} s: {_stages(stage_dir, world)}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
