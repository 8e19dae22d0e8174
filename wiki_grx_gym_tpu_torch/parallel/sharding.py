"""Which rank holds what (port of ``wiki_grx_gym_tpu/parallel/sharding.py``).

JAX's rule: a leaf whose leading dimension is ``num_envs`` is sharded over
``dp``, everything else (parameters, optimizer moments, scalars, keys) is
replicated. Here:

- rank r holds envs ``[r N/W, (r+1) N/W)`` (:func:`shard_bounds`) in its own
  env, and its generators are seeded from ``(seed, rank)``
  (:func:`rank_seed`); the terrain grid is built from the config's seed
  alone, so every rank holds the same grid, as JAX's one replicated grid;
- the learner state (flat params, Adam's moments, count, learning rate) is
  replicated: broadcast from rank 0 at init and after a load
  (:func:`broadcast_ppo_state`), and kept bit-identical by the update,
  which every rank runs on the same all-reduced gradient
  (:func:`check_replicas_identical` holds it so after every update).

Under tensor parallelism (``dp.mp``, ``parallel/mesh.make_mesh``) the envs
are sharded over dp only: every mp peer steps the same env shard from the
same seed ``rank_seed(seed, dp_index)``, as JAX puts env state on
``P("dp")``. The parameters follow JAX's ``shard_params`` (Megatron split,
``learn/networks.split_axis``): :func:`shard_flat` cuts a rank's shard out
of the whole net's flat buffer and :func:`gather_flat` puts the shards back
together; Adam's moments are sharded the same way. Checkpoints and exports
hold the gathered whole net.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

# rank r's generators start from seed + r * RANK_SEED_STRIDE: rank 0 keeps the
# one-process seeds, and the ranks' streams (each seed and seed + 1) never meet
RANK_SEED_STRIDE = 1_000_003


def shard_bounds(num_envs: int, world: int, rank: int):
    """(lo, hi): the envs rank ``rank`` of ``world`` holds. ``num_envs`` must
    divide evenly (JAX asserts it, ``learn/ppo.py:319``)."""
    num_envs, world, rank = int(num_envs), int(world), int(rank)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    if num_envs % world:
        raise ValueError(f"num_envs {num_envs} is not divisible by the {world} ranks")
    per = num_envs // world
    return rank * per, (rank + 1) * per


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators; rank 0's is ``seed``."""
    return int(seed) + int(rank) * RANK_SEED_STRIDE


def gather_envs(dp, tensors):
    """Every dp rank's ``tensors``, each (T, n, ...) or (L, n, ...) with
    this rank's n envs on dim 1, joined along dim 1 in global env order
    (:func:`shard_bounds`: rank r's envs after rank r - 1's), what XLA
    moves across devices for JAX's global shuffle. One all-gather of one
    float32 buffer packing every tensor (bool and float32 tensors come back
    bit for bit). Returns the joined tensors, each in its own dtype."""
    packed = torch.cat([x.reshape(-1).to(torch.float32) for x in tensors])
    parts = dp.all_gather(packed)   # (world, packed size), in dp rank order
    out, off = [], 0
    for x in tensors:
        n = x.numel()
        out.append(torch.cat(parts[:, off: off + n].unflatten(1, x.shape).unbind(0), dim=1).to(x.dtype))
        off += n
    return out


def shard_env_state(tree, lo: int, hi: int, num_envs: int):
    """``tree`` (a dataclass, named tuple, tuple or dict of tensors, as the
    env and runner states are) with every tensor whose leading dimension is
    ``num_envs`` cut to rows ``[lo, hi)``; other leaves kept (JAX
    ``shard_env_state``). Generators are shared, not copied."""
    if isinstance(tree, torch.Tensor):
        return tree[lo:hi] if tree.dim() >= 1 and tree.shape[0] == num_envs else tree
    cut = lambda x: shard_env_state(x, lo, hi, num_envs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: cut(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cut(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cut(x) for x in tree)
    if isinstance(tree, dict):
        return {k: cut(v) for k, v in tree.items()}
    return tree


def broadcast_ppo_state(dp, ppo):
    """Rank 0's ``PPOState`` (flat params, m, v, count, learning rate) on
    every rank: one broadcast of the float32 leaves packed together and one
    of the int32 count. Returns the new state (``ppo``'s tensors are not
    written)."""
    n = ppo.params.numel()
    f32 = torch.cat([ppo.params.reshape(-1), ppo.m.reshape(-1), ppo.v.reshape(-1),
                     ppo.learning_rate.reshape(1).to(torch.float32)]).to(dp.device)
    dp.broadcast(f32)
    count = dp.broadcast(ppo.count.reshape(1).to(device=dp.device, dtype=torch.int32).clone())
    return ppo.replace(params=f32[:n].clone(), m=f32[n:2 * n].clone(), v=f32[2 * n:3 * n].clone(),
                       learning_rate=f32[3 * n].clone(), count=count[0].clone())


def _digest(tensors) -> torch.Tensor:
    """A 64-bit hash of the tensors' bytes, as a (1,) int64 tensor on the CPU."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return torch.tensor([int.from_bytes(h.digest()[:8], "little", signed=True)], dtype=torch.int64)


def ppo_state_digest(ppo) -> torch.Tensor:
    """A 64-bit hash of the bytes of params, m, v, count and learning rate,
    as a (1,) int64 tensor on the CPU."""
    return _digest((ppo.params, ppo.m, ppo.v, ppo.count, ppo.learning_rate))


def tensor_leaves(tree):
    """The tensors of ``tree`` (dataclass, named tuple, tuple, list or dict)
    in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tensor_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    return []


def _same_everywhere(group, digest, what):
    digests = group.all_gather(digest.to(group.device)).reshape(-1).cpu()
    if not bool((digests == digests[0]).all()):
        raise RuntimeError(f"the ranks' {what}: digests {digests.tolist()}")
    return digests


def check_replicas_identical(dp, ppo, what: str = "update", net=None, replicated=None) -> torch.Tensor:
    """Raise unless every rank of the dp group holds a learner state
    bit-identical to its dp rank 0's. Returns every dp rank's
    :func:`ppo_state_digest` in rank order (one all-gather). Under tensor
    parallelism (``dp.mp``; ``net`` the rank's tensor-parallel net) the mp
    peers must also hold bit-identical replicated leaves of params, m and v,
    the count, the learning rate and ``replicated`` (a tree of tensors every
    mp peer holds alike: the env state, the metrics)."""
    digests = _same_everywhere(dp, ppo_state_digest(ppo), f"learner states differ after the {what}")
    if dp.mp is not None:
        if net is None:
            raise ValueError("the mp check needs the rank's net (its split leaves)")
        keep = ~net.split_mask()
        leaves = [ppo.params[keep], ppo.m[keep], ppo.v[keep], ppo.count, ppo.learning_rate]
        _same_everywhere(dp.mp, _digest(leaves + tensor_leaves(replicated)),
                         f"replicated leaves, env states or metrics differ between mp peers after the {what}")
    return digests


def _leaves(net):
    """(name, full offset, full shape, split axis) per leaf."""
    from wiki_grx_gym_tpu_torch.learn.networks import split_axis

    return [(name, off, shape, split_axis(name)) for name, off, shape in net.full_layout]


def shard_flat(net, full: torch.Tensor, num_mp: int, j: int) -> torch.Tensor:
    """mp rank ``j``'s shard of ``full`` (the whole net's flat buffer in
    ``net.full_layout``, e.g. ``convert.py``'s result, Adam's moments or a
    gradient) of ``num_mp`` ranks: the leaves in layout order, each split
    leaf cut into ``num_mp`` equal parts along its split axis (JAX
    ``shard_params``), each replicated leaf whole."""
    if full.shape != (net.full_num_params,):
        raise ValueError(f"expected the whole net's {net.full_num_params} values, got {tuple(full.shape)}")
    out = []
    for name, off, shape, axis in _leaves(net):
        x = full[off: off + math.prod(shape)].view(shape)
        if axis is not None and num_mp > 1:
            if shape[axis] % num_mp:
                raise ValueError(f"{name}: dimension {shape[axis]} is not divisible by num_mp={num_mp}")
            x = x.chunk(num_mp, dim=axis)[j]
        out.append(x.reshape(-1))
    return torch.cat(out)


def gather_flat(net, shards) -> torch.Tensor:
    """The inverse of :func:`shard_flat`: the whole net's flat buffer from
    every mp rank's shard, in mp order (a list or a ``(num_mp, S)`` tensor;
    a replicated leaf is taken from the first)."""
    num_mp = len(shards)
    out, pos = [], 0
    for name, off, shape, axis in _leaves(net):
        if axis is None or num_mp == 1:
            part = shape
        else:
            part = tuple(d // num_mp if a == axis else d for a, d in enumerate(shape))
        n = math.prod(part)
        if axis is None or num_mp == 1:
            out.append(shards[0][pos: pos + n])
        else:
            out.append(torch.cat([s[pos: pos + n].view(part) for s in shards], dim=axis).reshape(-1))
        pos += n
    if pos != shards[0].shape[0]:
        raise ValueError(f"a shard holds {shards[0].shape[0]} values, the layout {pos}")
    return torch.cat(out)
