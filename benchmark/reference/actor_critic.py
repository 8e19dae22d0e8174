"""The actor-critic of the configurations: two ELU MLPs and a learnable
per-action std (rsl_rl ``ActorCritic``), on one flat float32 vector.

The flat layout is each MLP's layers in order, each layer its weight
(out, in) then its bias, the actor before the critic, then the std.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

LOG_2PI = math.log(2.0 * math.pi)


def dims(config: dict) -> Tuple[List[int], List[int]]:
    env, pol = config["env"], config["policy"]
    return ([env["num_obs"], *pol["actor_hidden_dims"], env["num_actions"]],
            [env["num_pri_obs"], *pol["critic_hidden_dims"], 1])


def layout(config: dict) -> List[Tuple[str, int, Tuple[int, ...]]]:
    """[(leaf name, offset, shape)] of the flat vector."""
    out, off = [], 0
    actor, critic = dims(config)
    for head, d in (("actor", actor), ("critic", critic)):
        for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
            for name, shape in ((f"{head}.{i}.weight", (b, a)), (f"{head}.{i}.bias", (b,))):
                out.append((name, off, shape))
                off += math.prod(shape)
    out.append(("std", off, (actor[-1],)))
    return out


def num_params(config: dict) -> int:
    name, off, shape = layout(config)[-1]
    return off + math.prod(shape)


def leaves(flat: torch.Tensor, config: dict):
    """(actor [(W, b)], critic [(W, b)], std) as views of ``flat``."""
    lay = layout(config)
    views = [flat[off: off + math.prod(shape)].view(shape) for _, off, shape in lay]
    n_a = len(dims(config)[0]) - 1
    pairs = list(zip(views[0:-1:2], views[1:-1:2]))
    return pairs[:n_a], pairs[n_a:], views[-1]


def elu(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z > 0, z, torch.exp(z) - 1.0)


def forward(layers, x: torch.Tensor, rnd: Optional[Callable] = None):
    """An MLP's output and the inputs of each of its layers. ``rnd``
    rounds the operands of each product (inputs, activations and weights)."""
    r = rnd or (lambda t: t)
    hs = [r(x)]
    z = None
    for i, (w, b) in enumerate(layers):
        z = hs[-1] @ r(w).t() + b
        if i < len(layers) - 1:
            hs.append(r(elu(z)))
    return z, hs


def std_of(std_p: torch.Tensor, config: dict) -> torch.Tensor:
    pol = config["policy"]
    if pol["fixed_std"]:
        return torch.full_like(std_p, pol["init_noise_std"])
    if pol["noise_std_floor"] > 0.0:
        return torch.clamp(std_p, min=pol["noise_std_floor"])
    return std_p


def log_prob(mean, std, actions):
    var = std * std
    return torch.sum(-0.5 * ((actions - mean) ** 2 / var + LOG_2PI) - torch.log(std), dim=-1)


def act(flat, config, obs, critic_obs, noise, rnd=None):
    """The rollout's policy step: (actions, log_prob, mean, std, values)."""
    actor, critic, std_p = leaves(flat, config)
    mean, _ = forward(actor, obs, rnd)
    value, _ = forward(critic, critic_obs, rnd)
    std = std_of(std_p, config).expand_as(mean)
    actions = mean + std * noise
    return actions, log_prob(mean, std, actions), mean, std, value[..., 0]


def values(flat, config, critic_obs, rnd=None):
    _, critic, _ = leaves(flat, config)
    return forward(critic, critic_obs, rnd)[0][..., 0]
