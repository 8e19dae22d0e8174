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
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from wiki_grx_gym_tpu_torch.device import resolve_device

# torchrun's variables (torch.distributed.run): their presence means this
# process is one rank of a launched group
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
DEFAULT_TIMEOUT_S = 600.0


def launched_by_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def _src(group, src: int) -> int:
    """The global rank of rank ``src`` of ``group`` (None: the default group)."""
    return src if group is None else dist.get_global_rank(group, src)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its mp group: the group's size (``num_mp``), this
    rank's mp index, its device and the process group."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the mp group, in place; returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every mp rank's ``x`` stacked in mp order: ``(world, *x.shape)``."""
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return torch.stack(out)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """mp rank ``src``'s ``x`` on every mp rank, in place; returns ``x``."""
        dist.broadcast(x, src=_src(self.group, src), group=self.group)
        return x


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group: the group's size, this rank, this
    rank's device, and the process group (None: the default group). Under
    tensor parallelism (:func:`make_mesh`) the group is the dp group of this
    rank's mp index and ``mp`` its :class:`TensorParallel`."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    mp: Optional[TensorParallel] = None

    @property
    def is_lead(self) -> bool:
        """Global rank 0: the rank that writes logs and checkpoints."""
        return self.rank == 0 and (self.mp is None or self.mp.rank == 0)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        dist.broadcast(x, src=_src(self.group, src), group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(world, *x.shape)``,
        as one all-reduce of the ranks' rows (exact for integer tensors)."""
        out = torch.zeros((self.world, *x.shape), dtype=x.dtype, device=x.device)
        out[self.rank] = x
        return self.all_reduce_sum(out)


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


def destroy(dp: Optional[DataParallel]) -> None:
    """Tear down the process group that :func:`init_distributed` made."""
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()
