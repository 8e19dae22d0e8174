"""Start the ranks of a data-parallel group as local processes, with a time
limit.

A rank that dies before a collective leaves the others waiting in it, so
:func:`spawn` joins with a deadline of its own: past it every child is
killed and the call raises. Each rank runs ``fn(rank, world, init_method,
*args)`` in a fresh ``spawn`` process (``fn`` is pickled by import path);
``init_method`` is a ``file://`` rendezvous in a directory the caller owns,
so two groups on one machine never share a TCP port.
"""

from __future__ import annotations

import os
import time

import torch.multiprocessing as mp


def file_init_method(directory: str, name: str = "rendezvous") -> str:
    """A ``file://`` init method under ``directory`` (which must exist); the
    file must not exist before the group forms."""
    path = os.path.join(os.path.abspath(directory), name)
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def spawn(fn, world: int, args=(), rendezvous_dir: str = ".", timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes and
    wait for all of them. Raises if a rank raises or exits non-zero (the
    others are then killed), or if they have not all finished within
    ``timeout_s`` seconds (every child is killed)."""
    init = file_init_method(rendezvous_dir)
    ctx = mp.start_processes(fn, args=(world, init, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not finish "
                                   f"within {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
