"""The process group of a data-parallel run (port of
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

The tensor-parallel ``mp`` axis of JAX's mesh is ROADMAP queue 1 item 14b:
:func:`make_mesh` refuses ``num_mp > 1``.
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


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group: the group's size, this rank, this
    rank's device, and the process group (None: the default group)."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        dist.broadcast(x, src=src, group=self.group)
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
    """The run's layout: ``dp`` (data parallel over every rank of the group,
    or None for one process). ``num_mp > 1`` (tensor parallelism of the MLP
    hidden layers, JAX ``parallel/sharding.py:36-65``) is not ported."""
    if int(num_mp) != 1:
        if int(num_mp) < 1:
            raise ValueError(f"num_mp must be >= 1, got {num_mp}")
        raise NotImplementedError(
            f"num_mp={num_mp}: tensor parallelism is ROADMAP queue 1 item 14b; the port runs "
            "data parallel only (num_mp=1)")
    return dp


def destroy(dp: Optional[DataParallel]) -> None:
    """Tear down the process group that :func:`init_distributed` made."""
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()
