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
"""

from __future__ import annotations

import dataclasses
import hashlib

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


def ppo_state_digest(ppo) -> torch.Tensor:
    """A 64-bit hash of the bytes of params, m, v, count and learning rate,
    as a (1,) int64 tensor on the CPU."""
    h = hashlib.sha256()
    for t in (ppo.params, ppo.m, ppo.v, ppo.count, ppo.learning_rate):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return torch.tensor([int.from_bytes(h.digest()[:8], "little", signed=True)], dtype=torch.int64)


def check_replicas_identical(dp, ppo, what: str = "update") -> torch.Tensor:
    """Raise unless every rank's learner state is bit-identical to rank 0's.
    Returns every rank's :func:`ppo_state_digest` in rank order (one
    all-gather)."""
    digests = dp.all_gather(ppo_state_digest(ppo).to(dp.device)).reshape(-1).cpu()
    if not bool((digests == digests[0]).all()):
        raise RuntimeError(f"the ranks' learner states differ after the {what}: digests "
                           f"{digests.tolist()}")
    return digests
