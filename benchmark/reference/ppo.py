"""The PPO update of the configurations (rsl_rl's PPO, as the port and the
JAX package state it): the block shuffle, then epochs x minibatches grad
steps of the clipped surrogate, the clipped value loss and the entropy
bonus, each step the adaptive-KL learning rate, the NaN-loss skip, clip by
global norm, Adam, and the std projected to its floor.

The gradient is written out by hand so that each product's operands can be
rounded (``rnd``): the configurations keep the update's observations in
bf16 (``storage_dtype``), which makes the products' operands bf16 with f32
sums, and the control rounds them to fp8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from benchmark.reference.actor_critic import LOG_2PI, forward, leaves


def shuffle_geometry(t: int, n: int, block: int, num_mini_batches: int) -> Tuple[int, int, int, int]:
    """(block, blocks, used blocks, rows a minibatch) of one permutation
    group of ``n`` envs over ``t`` steps: ``block`` consecutive envs at one
    step move together, cut to a divisor of ``n`` that leaves every
    minibatch a block; the leftover blocks are dropped."""
    b = max(1, min(block, n))
    while b > 1 and ((n % b) or (t * (n // b)) < num_mini_batches):
        b -= 1
    n_blocks = t * (n // b)
    mb_blocks = n_blocks // num_mini_batches
    if mb_blocks == 0:
        raise ValueError(f"{n_blocks} blocks cannot fill {num_mini_batches} minibatches")
    return b, n_blocks, mb_blocks * num_mini_batches, mb_blocks * b


def pack(batch: Dict[str, torch.Tensor], returns, advantages, perm, groups: int, config: dict,
         store: Callable):
    """The update's minibatches: (obs, critic obs, f32 scalars), each
    (MB, rows, ...), of the (T, N, ...) batch shuffled by the block
    permutation ``perm`` of one group's blocks, applied to each of the
    ``groups`` env groups; minibatch i holds every group's i-th slice, group
    by group. ``store`` rounds the observations to the storage type."""
    alg = config["algorithm"]
    t, n = batch["rewards"].shape
    npg = n // groups
    b, n_blocks, used, rows = shuffle_geometry(t, npg, alg["shuffle_block"], alg["num_mini_batches"])
    if perm.shape != (used,):
        raise ValueError(f"perm holds {tuple(perm.shape)} indices, the shuffle uses {used}")
    mb = alg["num_mini_batches"]
    col = lambda x: x[..., None].float()
    fs = torch.cat([batch["actions"], col(batch["log_prob"]), batch["mu"], batch["sigma"],
                    col(batch["values"]), col(returns), col(advantages)], dim=-1).float()

    def shuffle(x):
        f = x.shape[-1]
        x = x.reshape(t, groups, npg // b, b, f).transpose(0, 1).reshape(groups, n_blocks, b, f)[:, perm]
        return x.reshape(groups, mb, rows, f).transpose(0, 1).reshape(mb, groups * rows, f)

    return shuffle(store(batch["obs"].float())), shuffle(store(batch["critic_obs"].float())), shuffle(fs)


def _max_grad(a, b):
    one = torch.ones_like(a)
    return torch.where(a > b, one, torch.where(a < b, 0.0 * one, 0.5 * one))


def _clip_grad(x, lo, hi):
    one = torch.ones_like(x)
    return torch.where((x > lo) & (x < hi), one, torch.where((x == lo) | (x == hi), 0.5 * one, 0.0 * one))


def grad(flat, obs, cobs, fs, config: dict, rnd: Callable):
    """(loss, flat gradient, (value loss, surrogate loss, KL)) of one
    minibatch at ``flat``."""
    alg, pol = config["algorithm"], config["policy"]
    a = config["env"]["num_actions"]
    rows = float(obs.shape[0])
    clip, vcoef, ecoef = alg["clip_param"], alg["value_loss_coef"], alg["entropy_coef"]
    actor, critic, std_p = leaves(flat, config)
    mean, h_a = forward(actor, obs, rnd)
    value, h_c = forward(critic, cobs, rnd)
    std = (torch.full_like(std_p, pol["init_noise_std"]) if pol["fixed_std"] else std_p).reshape(1, a)
    var = std * std
    actions, old_logp, old_mu = fs[:, :a], fs[:, a:a + 1], fs[:, a + 1:2 * a + 1]
    old_sigma, old_values = fs[:, 2 * a + 1:3 * a + 1], fs[:, 3 * a + 1:3 * a + 2]
    returns, adv = fs[:, 3 * a + 2:3 * a + 3], fs[:, 3 * a + 3:3 * a + 4]

    diff = actions - mean
    logp = -0.5 * torch.sum(diff * diff / var, dim=1, keepdim=True) - (0.5 * a * LOG_2PI + torch.sum(torch.log(std)))
    ratio = torch.exp(logp - old_logp)
    lo, hi = 1.0 - clip, 1.0 + clip
    surr1, surr2 = -adv * ratio, -adv * torch.clamp(ratio, lo, hi)
    surr = torch.maximum(surr1, surr2)
    kl = torch.sum(torch.log(std / old_sigma + 1e-5) + (old_sigma ** 2 + (old_mu - mean) ** 2) / (2.0 * var) - 0.5,
                   dim=1)
    e = value - returns
    if alg["use_clipped_value_loss"]:
        vdelta = value - old_values
        ec = old_values + torch.clamp(vdelta, -clip, clip) - returns
        e2, ec2 = e * e, ec * ec
        vl = torch.maximum(e2, ec2)
        gm = _max_grad(e2, ec2)
        gv = gm * (2.0 * e) + (1.0 - gm) * (2.0 * ec * _clip_grad(vdelta, -clip, clip))
    else:
        vl, gv = e * e, 2.0 * e
    gm_s = _max_grad(surr1, surr2)
    d_ratio = gm_s * (-adv) + (1.0 - gm_s) * (-adv * _clip_grad(ratio, lo, hi))
    coef = d_ratio * ratio / rows

    g = torch.zeros_like(flat)
    ga, gc, g_std = leaves(g, config)
    if not pol["fixed_std"]:
        g_std += torch.sum(coef * (diff * diff / var - 1.0) / std, dim=0) - ecoef / std[0]

    def backward(g_out, hs, layers, d_layers):
        gl = rnd(g_out)
        for i in range(len(layers) - 1, -1, -1):
            dw, db = d_layers[i]
            dw += gl.t() @ hs[i]
            db += torch.sum(gl, dim=0)
            if i > 0:
                h = hs[i]
                gl = rnd((gl @ rnd(layers[i][0])) * torch.where(h > 0, torch.ones_like(h), h + 1.0))

    backward(coef * (diff / var), h_a, actor, ga)
    backward(gv * (vcoef / rows), h_c, critic, gc)
    surr_m, vl_m, kl_m = surr.mean(), vl.mean(), kl.mean()
    entropy = torch.sum(0.5 + 0.5 * LOG_2PI + torch.log(std))
    loss = surr_m + vcoef * vl_m - ecoef * entropy
    return loss, g, torch.stack([vl_m, surr_m, kl_m])


def adapt_lr(lr, kl, alg: dict):
    if alg["schedule"] != "adaptive":
        return lr
    up = torch.clamp(lr * 1.5, max=alg["learning_rate_max"])
    down = torch.clamp(lr / 1.5, min=alg["learning_rate_min"])
    return torch.where(kl > alg["desired_kl"] * 2.0, down,
                       torch.where((kl < alg["desired_kl"] / 2.0) & (kl > 0.0), up, lr))


def update(state: dict, minibatches, config: dict, rnd: Callable
           ) -> Tuple[dict, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update from ``state`` (``params``, ``m``, ``v``, ``count``,
    ``lr``): (the new state, the means over grad steps of (value loss,
    surrogate loss, KL), the first grad step's gradient, each grad step's
    KL, which the adaptive learning rate read)."""
    alg, pol = config["algorithm"], config["policy"]
    obs, cobs, fs = minibatches
    p, m, v = state["params"].clone(), state["m"].clone(), state["v"].clone()
    count, lr = int(state["count"]), state["lr"].clone().float()
    b1, b2, eps, max_norm = 0.9, 0.999, 1e-8, alg["max_grad_norm"]
    floor = 0.0 if pol["fixed_std"] else pol["noise_std_floor"]
    std_off = p.numel() - config["env"]["num_actions"]
    steps = alg["num_learning_epochs"] * alg["num_mini_batches"]
    sums = torch.zeros(3, device=p.device)
    kls = []
    first = None
    for s in range(steps):
        i = s % alg["num_mini_batches"]
        loss, g, row = grad(p, obs[i], cobs[i], fs[i], config, rnd)
        lr = adapt_lr(lr, row[2], alg)
        kls.append(row[2])
        g = torch.where(torch.isfinite(loss), g, torch.zeros_like(g))
        if first is None:
            first = g.clone()
        norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(norm < max_norm, g, g / norm * max_norm)
        count += 1
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        p = p - lr * (m / (1.0 - b1 ** count)) / (torch.sqrt(v / (1.0 - b2 ** count)) + eps)
        if floor > 0.0:
            p[std_off:] = torch.clamp(p[std_off:], min=floor)
        sums += row
    new = {"params": p, "m": m, "v": v, "count": count, "lr": lr}
    return new, sums / steps, first, torch.stack(kls)


def leaf_norms(flat: torch.Tensor, config: dict) -> Dict[str, float]:
    """The L2 norm of each leaf of a flat vector."""
    from benchmark.reference.actor_critic import layout

    return {name: float(torch.linalg.vector_norm(flat[off: off + math.prod(shape)].double()))
            for name, off, shape in layout(config)}
