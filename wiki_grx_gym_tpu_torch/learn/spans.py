"""Spans inside the compiled collection: where the collection graph's device
time goes, read on every replay.

While ``learn/graphs.CompiledIteration`` captures the collection graph of the
K1 path (one graph of the whole collection), it installs that graph's
:class:`Spans` on the runner and the env (``OnPolicyRunner.spans``,
``LeggedEnv.spans``). Everywhere else they are None: the eager
``iteration``, ``step_graph``, the rollout graph, the update graphs and the
engine's per-step graphs pay one ``is None`` test and record nothing.

A mark ``spans(phase)`` launches a one-thread kernel (``csrc/stamp.cu``) that
writes the device's ``%globaltimer`` (ns) into its own slot of a static int64
buffer. Captured, it is a kernel node of the graph, and every replay writes
the slot again. A mark of the phase already running records nothing. The
sites, per rollout step: the start of ``OnPolicyRunner.rollout_step``
(``actor``), the start of ``LeggedEnv.step`` (``env``), just before K1's call
in ``LeggedEnv._run_decimation`` (``k1``) and just after it (``env``), after
``env.step`` returns (``actor``); then the start of ``OnPolicyRunner._returns``
(``gae``) and of ``CompiledIteration._stage_update`` (``stage``). Around a
replay ``CompiledIteration.__call__`` stamps slot 0 eagerly before the
graph's launch and the slot after the last mark eagerly after it.

Each interval between two consecutive slots belongs to the phase of the
first, so the phases tile the collection (``last_timing`` keys, seconds):

- ``entry_s``: from the stamp before the launch to the graph's first mark,
  the device waiting for the collection graph's launch;
- ``actor_s``: the noise, the policy and value forwards, the log-prob, the
  time-out bootstrap, the rollout buffers' and accumulators' stores;
- ``env_s``: ``env.step`` without K1's call (action boxes, delay, commands,
  rewards, resets, observations and their noise);
- ``k1_s``: K1's call (``CudaDecimation.__call__``: wrapper and kernel);
- ``gae_s``: the last values and GAE;
- ``stage_s``: the shuffle, the staging of the update's inputs, the metric
  sums and the donation of the new state.

This module imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from collections.abc import Mapping
from typing import Callable, Dict, List

import torch

from wiki_grx_gym_tpu_torch import build as _build

PHASES = ("entry", "actor", "env", "k1", "gae", "stage")

_LIB = None
_LIB_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build.build("stamp", _build.CSRC / "stamp.cu", _build.BASE_FLAGS)))
            lib.stamp.argtypes, lib.stamp.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
            _LIB = lib
    return _LIB


def stamp(slots: torch.Tensor, i: int):
    """Write the device's ``%globaltimer`` into ``slots[i]`` on the current
    stream (a kernel node inside a capture)."""
    if not slots.is_cuda or slots.dtype != torch.int64 or not 0 <= i < slots.numel():
        raise ValueError(f"stamp: slot {i} of a {slots.dtype} {tuple(slots.shape)} buffer on {slots.device}")
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    err = _library().stamp(slots.data_ptr() + 8 * i, stream)
    if err != 0:
        raise RuntimeError(f"stamp: launch failed with CUDA error {err}")


class Spans:
    """One collection graph's marks: its slots on ``device`` (``capacity``
    of them), the phase each slot starts (``phases``: ``"entry"`` first, then
    the capture's marks in order) and the objects it is installed on while
    it records (``holders``: the runner and the env)."""

    def __init__(self, capacity: int, device, holders):
        self.slots = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.holders = tuple(holders)
        self.phases: List[str] = ["entry"]
        if self.slots.is_cuda:   # the kernel loaded before a capture launches it
            stamp(self.slots, 0)

    def __call__(self, phase: str):
        if self.phases[-1] == phase:
            return
        if len(self.phases) + 1 >= self.slots.numel():
            raise RuntimeError(f"spans: more than {self.slots.numel() - 2} marks in one collection")
        stamp(self.slots, len(self.phases))
        self.phases.append(phase)

    @contextlib.contextmanager
    def recording(self):
        """Install on the holders and record the marks anew (the capture)."""
        self.phases = ["entry"]
        for h in self.holders:
            h.spans = self
        try:
            yield
        finally:
            for h in self.holders:
                h.spans = None

    def start(self):
        """Stamp slot 0, before the graph's launch."""
        stamp(self.slots, 0)

    def end(self):
        """Stamp the slot after the last mark, after the graph's launch."""
        stamp(self.slots, len(self.phases))

    def read(self) -> Dict[str, float]:
        """Seconds of each phase in the last replay (one copy to the host)."""
        ns = self.slots[:len(self.phases) + 1].tolist()
        out = {f"{p}_s": 0.0 for p in PHASES}
        for p, t0, t1 in zip(self.phases, ns, ns[1:]):
            out[f"{p}_s"] += (t1 - t0) / 1e9
        return out


class Timing(Mapping):
    """``OnPolicyRunner.last_timing`` of a compiled call, resolved by
    ``resolve()`` at its first read (outside the iteration's wall time) and
    kept."""

    def __init__(self, resolve: Callable[[], Dict[str, float]]):
        self._resolve = resolve
        self._values = None

    def _get(self) -> Dict[str, float]:
        if self._values is None:
            self._values = self._resolve()
        return self._values

    def __getitem__(self, key):
        return self._get()[key]

    def __iter__(self):
        return iter(self._get())

    def __len__(self):
        return len(self._get())

    def __repr__(self):
        return f"Timing({self._get()!r})"
