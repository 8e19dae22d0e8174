"""Generalized advantage estimation with timeout bootstrapping already in
the rewards (rsl_rl ``RolloutStorage.compute_returns``), and the
advantages normalised over the whole batch (population std)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def gae(rewards, dones, values, last_values, gamma: float, lam: float,
        rnd: Optional[Callable] = None):
    """(returns, normalised advantages), each (T, N), from (T, N) rewards,
    dones and values and the (N,) values after the last step. ``rnd``
    rounds each stored intermediate (the control's lower precision)."""
    r = rnd or (lambda t: t)
    rewards, values, last_values = r(rewards.float()), r(values.float()), r(last_values.float())
    not_terminal = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    delta = r(rewards + not_terminal * gamma * next_values - values)
    coeff = not_terminal * (gamma * lam)
    adv = torch.empty_like(delta)
    acc = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        acc = r(delta[t] + coeff[t] * acc)
        adv[t] = acc
    returns = r(adv + values)
    norm = r((adv - adv.mean()) / (adv.std(correction=0) + 1e-8))
    return returns, norm
