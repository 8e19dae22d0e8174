"""What the benchmark makes from ``--seed``: the actor-critic's starting
weights, the iterations' draws and the envs the check steps again, each
from a generator of its own, in a few large calls.

Every seed gets the same sizes: the weights' shapes, and per iteration a
(T, N, A) standard-normal action noise, a (T, N, K) uniform block of the
env step's draws (resets, commands, observation noise, pushes) and the
update's block permutation, ``randperm(blocks)[:used]``. Only the values
differ from seed to seed. The draws are made in set-up, ``RING`` sets, and
the iterations take them in turn, so the window times no draw.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.actor_critic import layout

_STREAMS = {"params": 1, "draws": 2, "sample": 3}
RING = 4          # sets of draws made in set-up, taken in turn
ENV_SAMPLE = 2048  # envs of a run whose first step of each checked iteration the reference steps again


def stream_seed(seed: int, stream: str, rank: int = 0) -> int:
    """A 63-bit seed of its own for each stream and rank of ``seed``."""
    return (int(seed) * 1_000_003 + _STREAMS[stream] * 7919 + int(rank) * 104_729) % (2 ** 63)


def generator(seed: int, stream: str, device, rank: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, rank))
    return g


def make_params(config: dict, seed: int, device) -> torch.Tensor:
    """The starting weights in the flat layout: each weight N(0, 1/fan_in),
    each bias N(0, 0.01^2), the std at the policy's ``init_noise_std``."""
    lay = layout(config)
    total = lay[-1][1] + math.prod(lay[-1][2])
    flat = torch.randn(total, generator=generator(seed, "params", device), device=device)
    for name, off, shape in lay:
        view = flat[off: off + math.prod(shape)]
        if name == "std":
            view.fill_(config["policy"]["init_noise_std"])
        elif name.endswith(".weight"):
            view.mul_(1.0 / math.sqrt(shape[1]))
        else:
            view.mul_(0.01)
    return flat


def env_sample(seed: int, rank: int, world: int, n: int) -> torch.Tensor:
    """The envs of rank ``rank`` (of ``n`` a rank) whose steps the check
    takes again, as indices into the run's envs (rank-major), sorted:
    ``ENV_SAMPLE`` of the run's in all, or every env of a smaller run."""
    count = min(n, max(1, ENV_SAMPLE // world))
    g = generator(seed, "sample", "cpu", rank)
    return torch.sort(torch.randperm(n, generator=g)[:count]).values + rank * n


class Draws:
    """One rank's draws, iteration after iteration: (noise, u, perm) of
    shapes (T, N, A), (T, N, K) and (used,), ``ring`` sets made at once and
    taken in turn. The permutation is of one group's ``blocks`` blocks;
    every rank draws one, and the program uses rank 0's."""

    def __init__(self, seed: int, rank: int, t: int, n: int, a: int, k: int, blocks: int, used: int, device,
                 ring: int = RING):
        g = generator(seed, "draws", device, rank)
        self.sets = [(torch.randn((t, n, a), generator=g, device=device),
                      torch.rand((t, n, k), generator=g, device=device),
                      torch.randperm(blocks, generator=g, device=device)[:used]) for _ in range(ring)]
        self.i = 0

    def next(self):
        out = self.sets[self.i % len(self.sets)]
        self.i += 1
        return out
