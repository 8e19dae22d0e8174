"""The process groups of a data- and tensor-parallel run (port of
``wiki_grx_gym_tpu/parallel/mesh.py``).

JAX shards the env batch over the ``dp`` axis of a device ``Mesh`` and lets
XLA emit the collectives. Here every rank is one process with one device:

- each rank steps its own shard of the envs (K1 on N/W envs a launch), with
  no collective in the rollout;
- the update all-reduces the gradient once a grad step (K2 per shard, then
  the mean, then clip and Adam), and scalars for GAE's normalisation, the
  metrics and the command curriculum;
- :class:`DataParallel` names the group, this rank and its device, and is
  what the env, the runner and PPO are given.

JAX's mesh is ``("dp", "mp")`` over ``devices.reshape(n // num_mp,
num_mp)``. :func:`make_mesh` lays the ranks out the same way, ``rank =
dp_index x num_mp + mp_index``, and forms two groups with ``dist.new_group``:
the mp group (``num_mp`` consecutive ranks, which split the MLP hidden
layers, ``learn/networks.py``) and the dp group (stride ``num_mp``, which
hold the same shard and average their gradients). It returns this rank's
:class:`DataParallel` over the dp group, which carries its
:class:`TensorParallel` as ``mp``; with ``num_mp = 1`` the data-parallel
layout is unchanged. mp peers step the same env shard.

**Captured collectives.** A group's backend is read once, when its view is
made (``dist.get_backend``), and kept as ``backend``. NCCL's collectives
are kernels on the card that a CUDA graph captures
(``learn/graphs.py``); gloo's run on the host and cannot be captured, so
``capturable`` is true for ``nccl`` alone, and a run over any other backend
keeps its iteration eager. Across ranks, only what a run on several cards
has held against the eager iteration is compiled, keyed by graph
(:meth:`DataParallel.eager_reason`): the collection by the layout, the
physics backend and the policy net (:data:`COMPILED_COLLECTIONS`), the
update, with the staging of its inputs, by the layout and the update path
(:data:`COMPILED_UPDATES`). Each collective issued while the current CUDA
stream is capturing adds one to ``CAPTURED`` (the graphs report how many
each capture holds).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import weakref
from typing import Optional

import torch
import torch.distributed as dist

from wiki_grx_gym_tpu_torch.device import resolve_device

# torchrun's variables (torch.distributed.run): their presence means this
# process is one rank of a launched group
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
DEFAULT_TIMEOUT_S = 600.0
# the backends whose collectives a CUDA graph can capture
CAPTURABLE_BACKENDS = ("nccl",)
# collectives issued during a CUDA graph's capture, by operation
CAPTURED = collections.Counter()
# what holds CUDA graphs that may launch a group's collectives (each has a
# release()): :func:`destroy` releases them before the group
_HOLDERS = weakref.WeakSet()


def launched_by_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def _src(group, src: int) -> int:
    """The global rank of rank ``src`` of ``group`` (None: the default group)."""
    return src if group is None else dist.get_global_rank(group, src)


def _noted(op: str, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        CAPTURED[op] += 1
    return x


class _Group:
    """The collectives over ``group`` (None: the default group) that the
    views share (each has ``group`` and ``backend``)."""

    def __post_init__(self):
        # the backend read from the group once, where a process group exists
        # and the view was made without one
        if self.backend is None and dist.is_available() and dist.is_initialized():
            object.__setattr__(self, "backend", str(dist.get_backend(self.group)))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this group's collectives."""
        return self.backend in CAPTURABLE_BACKENDS

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, in place; returns ``x``."""
        dist.all_reduce(_noted("all_reduce", x), op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        dist.broadcast(_noted("broadcast", x), src=_src(self.group, src), group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every group rank's ``x`` stacked in rank order: ``(world,
        *x.shape)``, gathered into one buffer (no list of outputs to copy
        from)."""
        out = torch.empty(self.world * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, _noted("all_gather", x.contiguous()).reshape(-1), group=self.group)
        return out.view(self.world, *x.shape)


@dataclasses.dataclass(frozen=True)
class TensorParallel(_Group):
    """This rank's place in its mp group: the group's size (``num_mp``), this
    rank's mp index, its device, the process group and its backend."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataParallel(_Group):
    """One rank of a data-parallel group: the group's size, this rank, this
    rank's device, the process group (None: the default group) and its
    backend. Under tensor parallelism (:func:`make_mesh`) the group is the
    dp group of this rank's mp index and ``mp`` its :class:`TensorParallel`."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    mp: Optional[TensorParallel] = None
    backend: Optional[str] = None

    @property
    def is_lead(self) -> bool:
        """Global rank 0: the rank that writes logs and checkpoints."""
        return self.rank == 0 and (self.mp is None or self.mp.rank == 0)

    @property
    def uncapturable_backend(self) -> Optional[str]:
        """The backend of this rank's dp or mp group that a CUDA graph
        cannot capture (None: both are NCCL)."""
        for view in (self, self.mp):
            if view is not None and not view.capturable:
                return view.backend or "an unknown backend"
        return None

    @property
    def layout(self) -> Optional[str]:
        """``"dp"``, ``"mp"`` or ``"dp x mp"``: which of this rank's groups
        span more than one rank (None: neither)."""
        dp, mp = self.world > 1, self.mp is not None and self.mp.world > 1
        return {(True, False): "dp", (False, True): "mp", (True, True): "dp x mp"}.get((dp, mp))

    def eager_reason(self, physics: str, net: Optional[str] = None, path: Optional[str] = None) -> Optional[str]:
        """Why a run over this rank's groups keeps its iteration (or, with
        ``path`` None, its env step) eager; None where the graphs capture
        its collectives. ``physics``: the env's backend; ``net``: the policy
        net, ``"mlp"`` or ``"lstm"``; ``path``: the update's as
        ``OnPolicyRunner.rule_path`` names it. Every group must be NCCL's,
        and across ranks the collection must be in
        :data:`COMPILED_COLLECTIONS` and the update in
        :data:`COMPILED_UPDATES` (the env step alone: some held collection
        of its layout and backend)."""
        backend = self.uncapturable_backend
        if backend is not None:
            return (f"data or tensor parallelism over {backend} (its collectives run on the host and "
                    "cannot be captured: only NCCL's can)")
        layout = self.layout
        if layout is None:
            return None
        words = _LAYOUT_WORDS[layout]
        if path is None:
            if not any(key[:2] == (layout, physics) for key in COMPILED_COLLECTIONS):
                return f"{words} across ranks with the {physics} physics backend: {_NOT_HELD}"
            return None
        if (layout, physics, net) not in COMPILED_COLLECTIONS:
            return f"{words} across ranks, the {net} policy's collection on {physics}: {_NOT_HELD}"
        if (layout, path) not in COMPILED_UPDATES:
            return f"{words} across ranks on the {path} path: {_NOT_HELD}"
        return None


# Across ranks over NCCL, the graphs a run on four cards has held bit for
# bit against the eager iteration, with NCCL kernel nodes in them and a
# planted fault caught (tests/test_torch_graphs_nccl_cuda.py, chip_smoke.py
# phase 22; PERF.md names the world that holds each key). The collection
# (the rollout, GAE) by (layout, physics backend, policy net): its
# collectives are the env step's, GAE's and, under mp, the policy's
# forward. The update with the staging of its inputs (the permutation's
# broadcast, the global shuffle's gather, the pack) by (layout, path), the
# path OnPolicyRunner.rule_path's: PPO's ("step" is the path a dp mesh
# selects for an MLP policy without an extra loss term, "xla" the path of
# tensor parallelism), "recurrent", "+symmetry" where the symmetry loss is
# on, "+global" under the global shuffle. Together the two sets hold every
# combination a mesh over NCCL selects (a mesh never selects mp's mega and
# step paths): across ranks only the "lanes" backend and gloo stay eager.
COMPILED_COLLECTIONS = frozenset({
    ("dp", "kernel", "mlp"), ("dp", "kernel", "lstm"), ("dp", "engine", "mlp"), ("dp", "engine", "lstm"),
    ("mp", "kernel", "mlp"), ("mp", "kernel", "lstm"), ("mp", "engine", "mlp"), ("mp", "engine", "lstm"),
    ("dp x mp", "kernel", "mlp"), ("dp x mp", "kernel", "lstm"), ("dp x mp", "engine", "mlp"),
    ("dp x mp", "engine", "lstm"),
})
COMPILED_UPDATES = frozenset({
    ("dp", "step"), ("dp", "xla"), ("dp", "xla+symmetry"), ("dp", "recurrent"), ("dp", "recurrent+symmetry"),
    ("dp", "mega+global"), ("dp", "step+global"), ("dp", "xla+global"), ("dp", "xla+symmetry+global"),
    ("dp", "recurrent+global"), ("dp", "recurrent+symmetry+global"),
    ("mp", "xla"), ("mp", "xla+symmetry"), ("mp", "recurrent"), ("mp", "recurrent+symmetry"),
    ("dp x mp", "xla"), ("dp x mp", "xla+symmetry"), ("dp x mp", "recurrent"), ("dp x mp", "recurrent+symmetry"),
    ("dp x mp", "xla+global"), ("dp x mp", "xla+symmetry+global"), ("dp x mp", "recurrent+global"),
    ("dp x mp", "recurrent+symmetry+global"),
})
_LAYOUT_WORDS = {"dp": "data parallelism", "mp": "tensor parallelism", "dp x mp": "data and tensor parallelism"}
_NOT_HELD = "its graphs are not yet held against the eager iteration on several cards"


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> DataParallel:
    """``torch.distributed.init_process_group`` for this process; returns its
    :class:`DataParallel`.

    Under torchrun (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) the
    group comes from those variables (``env://``) and the explicit arguments
    must be left out; otherwise ``init_method``, ``world_size`` and ``rank``
    are required. ``device``: ``"cuda"`` is ``cuda:<local rank>`` (torchrun's
    ``LOCAL_RANK``, else ``rank``), a device with an index is taken as
    given, ``"cpu"`` runs on the CPU. ``backend``: ``nccl`` on CUDA and
    ``gloo`` on the CPU by default. Nothing falls back: a failed init raises,
    and so does a CUDA device without a card."""
    if launched_by_torchrun():
        if init_method is not None or world_size is not None or rank is not None:
            raise ValueError("under torchrun the group comes from RANK/WORLD_SIZE/LOCAL_RANK; "
                             "pass no init_method, world_size or rank")
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ["LOCAL_RANK"])
    else:
        if init_method is None or world_size is None or rank is None:
            raise ValueError("init_distributed outside torchrun needs init_method, world_size and rank")
        world_size, rank = int(world_size), int(rank)
        local_rank = rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a group of {world_size}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend takes CUDA tensors: use gloo on the CPU")
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return DataParallel(world=world_size, rank=rank, device=dev)


def make_mesh(num_mp: int = 1, dp: Optional[DataParallel] = None) -> Optional[DataParallel]:
    """The run's layout. ``num_mp = 1``: ``dp`` as it is (data parallel over
    every rank of the group, or None for one process). ``num_mp > 1``: the
    ``world = n_dp x num_mp`` ranks of ``dp`` (the whole group, from
    :func:`init_distributed`) in JAX's device order (``parallel/mesh.py:32``:
    ``rank = dp_index x num_mp + mp_index``); every rank forms every group
    (``dist.new_group`` is collective). Returns this rank's dp view with its
    ``mp``. ``world % num_mp != 0`` raises, as JAX asserts."""
    num_mp = int(num_mp)
    if num_mp < 1:
        raise ValueError(f"num_mp must be >= 1, got {num_mp}")
    if num_mp == 1:
        return dp
    if dp is None:
        raise ValueError(f"num_mp={num_mp} splits the net over the ranks of a process group: run "
                         "with --distributed (init_distributed) and pass its DataParallel")
    if dp.mp is not None or dp.group is not None:
        raise ValueError("make_mesh takes the whole group's DataParallel (from init_distributed)")
    world, rank = dp.world, dp.rank
    if world % num_mp:
        raise ValueError(f"world size {world} is not divisible by num_mp={num_mp}")
    n_dp = world // num_mp
    dp_index, mp_index = divmod(rank, num_mp)
    mp_group = dp_group = None
    for i in range(n_dp):
        g = dist.new_group(ranks=[i * num_mp + j for j in range(num_mp)])
        if i == dp_index:
            mp_group = g
    for j in range(num_mp):
        g = dist.new_group(ranks=[i * num_mp + j for i in range(n_dp)])
        if j == mp_index:
            dp_group = g
    mp = TensorParallel(world=num_mp, rank=mp_index, device=dp.device, group=mp_group)
    return DataParallel(world=n_dp, rank=dp_index, device=dp.device, group=dp_group, mp=mp)


def hold(graphs) -> None:
    """Register ``graphs`` (anything with a ``release()`` that destroys its
    CUDA graphs) as a holder of graphs that launch this process's
    collectives: :func:`destroy` releases it first."""
    _HOLDERS.add(graphs)


def destroy(dp: Optional[DataParallel]) -> None:
    """Tear down the process group that :func:`init_distributed` made. The
    registered graphs (:func:`hold`) are released first: NCCL's
    communicators must outlive the CUDA graphs that launch their kernels,
    and destroying a communicator under a live graph does not return."""
    if dp is not None and dist.is_initialized():
        for holder in list(_HOLDERS):
            holder.release()
        _HOLDERS.clear()
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        dist.destroy_process_group()
