"""The native policy runtime, bound with ctypes (port of
``wiki_grx_gym_tpu/deploy/runtime.py``).

A trained actor is written as a flat ``.grxpolicy`` binary
(:func:`export_policy_bin`) and evaluated by ``libgrxpolicy.so``, built from
``deploy/native/policy_runtime.{h,cc}`` (byte-identical copies of the JAX
package's sources): no Python, torch or JAX on the robot. The file is the
JAX package's format, byte for byte for the same weights: version 1 for an
MLP actor, version 2 with the actor's LSTM memory stack ahead of the MLP
head (the runtime then keeps the hidden state inside its handle).

:func:`ensure_library` compiles the library with g++ at first use into the
checkout's ``build/deploy`` directory (listed in .gitignore). The file's name
carries a digest of the machine, the compiler's version and both sources, so
a library built on another machine or toolchain, or from other sources, is
never loaded: a new one is built beside it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCES = (NATIVE_DIR / "policy_runtime.cc", NATIVE_DIR / "policy_runtime.h")
LIB_DIR = Path(__file__).resolve().parents[2] / "build" / "deploy"

MAGIC = 0x47525850   # "GRXP"
_ACT_IDS = {"elu": 0, "relu": 1, "tanh": 2}


def _f32_bytes(t: torch.Tensor) -> bytes:
    return t.detach().to("cpu", torch.float32).contiguous().numpy().tobytes(order="C")


def export_policy_bin(net, path: str) -> None:
    """Write the actor of ``net`` (the port's ``ActorCritic`` or
    ``ActorCriticRecurrent``) as a ``.grxpolicy`` file. The port keeps each
    head weight as (out, in); the file takes it row-major (in x out), as
    JAX stores it. The LSTM layers keep JAX's layout (w_ih (I, 4H), w_hh
    (H, 4H)), and their biases go in folded as ``b_ih + b_hh`` (summed in
    float32, as the JAX exporter sums them). The weights are float32 whatever
    the net's ``compute_dtype``; a tensor-parallel rank's net is refused
    (export ``OnPolicyRunner.full_net()``)."""
    if getattr(net, "mp", None) is not None:
        raise ValueError("a tensor-parallel shard: export the gathered net (OnPolicyRunner.full_net())")
    if net.activation not in _ACT_IDS:
        raise ValueError(f"activation {net.activation!r}: the runtime knows {sorted(_ACT_IDS)}")
    if net.actor_out_act:
        raise ValueError(f"actor output activation {net.actor_out_act!r}: the runtime has none")
    actor = net.leaves(net.params_flat)[0]
    memory = net.memories()[0] if hasattr(net, "memories") else []
    with open(path, "wb") as f:
        version = 2 if memory else 1
        f.write(struct.pack("<IIII", MAGIC, version, len(actor), _ACT_IDS[net.activation]))
        if memory:
            f.write(struct.pack("<II", len(memory), int(memory[0][1].shape[0])))
            for w_ih, w_hh, b_ih, b_hh in memory:
                b = b_ih.detach().cpu().numpy().astype(np.float32) + b_hh.detach().cpu().numpy().astype(np.float32)
                f.write(struct.pack("<I", w_ih.shape[0]))
                f.write(_f32_bytes(w_ih))
                f.write(_f32_bytes(w_hh))
                f.write(b.tobytes(order="C"))
        for w, b in actor:
            f.write(struct.pack("<II", w.shape[1], w.shape[0]))
            f.write(_f32_bytes(w.t()))
            f.write(_f32_bytes(b))


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native policy runtime cannot be built")
    return gxx


@functools.lru_cache(maxsize=None)
def library_path() -> Path:
    """``build/deploy/libgrxpolicy-<digest>.so``, the digest taken over the
    machine, ``g++ -dumpfullversion`` and the sources' bytes."""
    version = subprocess.run([_gxx(), "-dumpfullversion"], capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(f"{platform.machine()}\n{version.strip()}\n".encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return LIB_DIR / f"libgrxpolicy-{h.hexdigest()[:16]}.so"


def ensure_library() -> str:
    """Build the library with g++ if this machine, compiler and sources have
    none yet (:func:`library_path`); return its path. Raises if g++ is
    missing or fails."""
    lib = library_path()
    if lib.exists():
        return str(lib)
    LIB_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_gxx(), "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp), str(SOURCES[0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return str(lib)


class NativePolicy:
    """The deterministic actor of a ``.grxpolicy`` file, evaluated by the C++
    runtime on the CPU. A batch of observations of a recurrent policy is a
    stream of consecutive control steps of one robot."""

    def __init__(self, policy_path: str):
        lib = ctypes.CDLL(ensure_library())
        lib.grx_policy_load.restype = ctypes.c_void_p
        lib.grx_policy_load.argtypes = [ctypes.c_char_p]
        for name in ("grx_policy_input_dim", "grx_policy_output_dim", "grx_policy_num_lstm_layers"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.grx_policy_forward_batch.restype = ctypes.c_int
        lib.grx_policy_forward_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.grx_policy_free.restype = None
        lib.grx_policy_free.argtypes = [ctypes.c_void_p]
        lib.grx_policy_reset.restype = None
        lib.grx_policy_reset.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._handle = lib.grx_policy_load(str(policy_path).encode())
        if not self._handle:
            raise IOError(f"failed to load policy {policy_path!r}")
        self.input_dim = lib.grx_policy_input_dim(self._handle)
        self.output_dim = lib.grx_policy_output_dim(self._handle)
        self.num_lstm_layers = lib.grx_policy_num_lstm_layers(self._handle)

    def reset(self) -> None:
        """Zero the recurrent hidden state; a no-op for an MLP policy."""
        self._lib.grx_policy_reset(self._handle)

    def __call__(self, obs: Sequence[float]) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32)
        squeeze = obs.ndim == 1
        if squeeze:
            obs = obs[None]
        if obs.ndim != 2 or obs.shape[1] != self.input_dim:
            raise ValueError(f"observations of shape {obs.shape}; the policy takes {self.input_dim} inputs")
        out = np.empty((obs.shape[0], self.output_dim), np.float32)
        rc = self._lib.grx_policy_forward_batch(
            self._handle,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            obs.shape[0],
        )
        if rc:
            raise RuntimeError("native policy forward failed")
        return out[0] if squeeze else out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.grx_policy_free(self._handle)
            self._handle = None
