"""How ``correct`` is decided: the plain reference follows the checked
iterations the program ran in set-up, and each number compared is held to
its cell's limit (``benchmark/limits/<cell>.json``).

The reference follows the program stage by stage from the program's own
state before each checked iteration:

- the env step (``reference/env.py``: the action boxes and delay, the
  decimation loop and its post-physics tail that K1 computes, rewards,
  resets and observations): the first step of each iteration, of a sample
  of envs drawn from the seed, from the program's env state and the
  program's first actions: the share of those envs whose observations,
  critic observations, reward or reset differ (``env_off_pct``);
- the policy step of every rollout step (actor mean, std, the action from
  the benchmark's noise, log-probability, critic value) and the last
  values, from the program's observations and weights (``ac_gap``);
- GAE, from the program's rewards, dones and values (``gae_gap``);
- the PPO update, from the program's batch and the reference's own GAE,
  starting from the benchmark's weights in the first iteration and from
  the program's weights, Adam state, count and learning rate after the one
  before in the others: the loss (``loss_gap``) and the weights' change by
  the worst leaf (``dparam_gap``).

The adaptive learning rate moves by 1.5x after any grad step whose KL is
over twice or under half the desired one. Where a KL comes near one of
those thresholds, a rounding difference puts the program's on the other
side on some seeds, and the 200 Adam steps after it carry the weights
apart by as much as a fault does (PERF.md gives the readings). So the
update's numbers hold the updates in which every grad step's KL in the
reference kept ``KL_MARGIN`` of its value away from both thresholds; the
reference's KLs alone decide which. A leaf whose first gradient in the
reference is under a thousandth of the median leaf's is left out of
``dparam_gap``: it moves under Adam by rounding alone.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from benchmark.reference import actor_critic as ac
from benchmark.reference import gae as gae_mod
from benchmark.reference import ppo as ppo_mod
from benchmark.reference.actor_critic import layout
from benchmark.reference.env import RefEnv
from benchmark.reference.precision import BELOW, DTYPE, rounder

NUMBERS = ("env_off_pct", "ac_gap", "gae_gap", "loss_gap", "dparam_gap")
ENV_COMPARED = ("obs", "critic_obs", "rewards")
ENV_TOL = 1e-3    # an env is off where a value differs by more than this share of its field's rms
KL_MARGIN = 0.02  # an update whose KLs all kept this share away from the adaptive rule's thresholds
ROLLOUT_FIELDS = ("obs", "critic_obs", "actions", "rewards", "dones", "values", "log_prob", "mu", "sigma")
POLICY_FIELDS = ("mu", "sigma", "actions", "log_prob", "values")
UPDATE_METRICS = ("value_loss", "surrogate_loss", "kl", "lr")
BLOCK_ROWS = 65536
NAN_GAP = 1e30   # what a gap that is not a number reads as


def stated_precision(config: dict) -> Dict[str, str]:
    return dict(config["precision"]["stages"])


def control_precision(config: dict) -> Dict[str, str]:
    return {k: BELOW[v] for k, v in stated_precision(config).items()}


def snapshot(run, params_before: torch.Tensor, env_before: dict, env_ids, noise, u, perm, metrics) -> dict:
    """What one iteration of the program produced, copied to the host, with
    the env state of the sampled envs ``env_ids`` before it and the first
    step's uniform block."""
    host = lambda x: x.detach().to("cpu", copy=True)
    snap = {k: host(v) for k, v in run.collected().items()}
    snap["params_before"] = host(params_before)
    snap["noise"], snap["perm"] = host(noise), host(perm)
    snap["env_before"], snap["env_ids"] = env_before, env_ids.cpu()
    snap["u0"] = host(u[0].index_select(0, (env_ids % u.shape[1]).to(u.device)))
    snap["after"] = {k: host(v) for k, v in run.ppo().items()}
    snap["metrics"] = {k: float(metrics[k]) for k in UPDATE_METRICS}
    return snap


def join_ranks(snaps_by_rank: List[List[dict]]) -> List[dict]:
    """The ranks' snapshots of each iteration as one global batch, envs in
    rank order (each rank's envs are a contiguous shard); the weights and
    Adam state are rank 0's (every rank holds the same)."""
    out = []
    for it in zip(*snaps_by_rank):
        head = it[0]
        joined = dict(head)
        for k in (*ROLLOUT_FIELDS, "noise", "returns", "advantages"):
            joined[k] = torch.cat([s[k] for s in it], dim=1)
        for k in ("last_values", "final_critic_obs", "env_ids", "u0"):
            joined[k] = torch.cat([s[k] for s in it], dim=0)
        joined["env_before"] = {k: (v if v.dim() == 0 or k == "cmd_lin_vel_x_range" else
                                    torch.cat([s["env_before"][k] for s in it], dim=0))
                                for k, v in head["env_before"].items()}
        out.append(joined)
    return out


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:]) if x.dim() >= 2 else x


def step_envs(snap: dict, env: RefEnv, values0: torch.Tensor, gamma: float) -> Dict[str, torch.Tensor]:
    """The first env step of an iteration, of the sampled envs, from the
    program's env state and first actions: the observations and critic
    observations after it, the reward with the time-out bootstrap (as the
    rollout stores it, with the reference's values) and the reset."""
    ids = snap["env_ids"]
    out = env.step(snap["env_before"], snap["actions"][0].index_select(0, ids), snap["u0"], env_ids=ids)
    send = getattr(env.cfg.env, "send_timeouts", True)
    boot = gamma * values0.index_select(0, ids) * out["time_out"].to(torch.float32) if send else 0.0
    return {"obs": out["obs"], "critic_obs": out["critic_obs"], "rewards": out["rew"] + boot, "dones": out["reset"]}


def program_envs(snap: dict) -> Dict[str, torch.Tensor]:
    """What the program's rollout holds of the same envs after its first step."""
    ids = snap["env_ids"]
    return {"obs": snap["obs"][1].index_select(0, ids), "critic_obs": snap["critic_obs"][1].index_select(0, ids),
            "rewards": snap["rewards"][0].index_select(0, ids), "dones": snap["dones"][0].index_select(0, ids)}


def env_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each sampled env's largest gap: |got - want| over the field's rms in
    the reference, the largest over its values and fields; a reset that
    differs or a value that is not a number reads ``NAN_GAP``."""
    worst = torch.zeros(want["dones"].shape[0], dtype=torch.float64)
    for k in ENV_COMPARED:
        g, w = got[k].double().reshape(worst.shape[0], -1), want[k].double().reshape(worst.shape[0], -1)
        scale = float(torch.sqrt(torch.mean(w * w))) or 1.0
        gap = torch.nan_to_num(torch.abs(g - w) / scale, nan=NAN_GAP, posinf=NAN_GAP)
        worst = torch.maximum(worst, gap.max(dim=1).values)
    return torch.where(got["dones"] != want["dones"], torch.full_like(worst, NAN_GAP), worst)


def follow(snaps: List[dict], p0: torch.Tensor, config: dict, groups: int, precision: Dict[str, str],
           device, half_batch: bool = False, env_fault: Optional[dict] = None, env_step: bool = True,
           update: bool = True) -> List[dict]:
    """The reference (or, at the control's precision, the control) over the
    program's iterations: per iteration its first env step of the sampled
    envs, policy-step outputs, returns and advantages, update metrics and
    state after the update, the update starting from the benchmark's
    weights (the first) or from the program's state after the one before.
    ``half_batch`` and ``env_fault`` (``RefEnv``'s fault keywords) plant
    faults for the limits' readings: each grad step's mean over the first
    half of its minibatch only; the env's friction scaled, or a substep
    left out. ``env_step`` and ``update`` False leave those stages out (a
    fault's readings need only its own stage)."""
    fwd, gae_r = rounder(precision["rollout"]), rounder(precision["gae"])
    upd, store = rounder(precision["update"]), rounder(precision["storage"])
    alg = config["algorithm"]
    dev = torch.device(device)
    n_all = snaps[0]["rewards"].shape[1]
    env = RefEnv(config["env_cfg"], n_all, dtype=DTYPE[precision["env"]], **(env_fault or {}))
    state = {"params": p0.to(dev).float(), "m": torch.zeros_like(p0, device=dev),
             "v": torch.zeros_like(p0, device=dev), "count": 0,
             "lr": torch.tensor(alg["learning_rate"], dtype=torch.float32, device=dev)}
    out = []
    for i, snap in enumerate(snaps):
        if i > 0:   # the update from the program's state after the one before
            prev = snaps[i - 1]["after"]
            state = {"params": prev["params"].to(dev).float(), "m": prev["m"].to(dev), "v": prev["v"].to(dev),
                     "count": int(prev["count"]), "lr": prev["lr"].to(dev).float()}
        o: Dict[str, object] = {}
        # the policy step, from the program's observations and weights
        p_prog = snap["params_before"].to(dev)
        obs, cobs, noise = _rows(snap["obs"]), _rows(snap["critic_obs"]), _rows(snap["noise"])
        parts = {k: [] for k in POLICY_FIELDS}
        for r0 in range(0, obs.shape[0], BLOCK_ROWS):
            sl = slice(r0, r0 + BLOCK_ROWS)
            a, lp, mu, sd, val = ac.act(p_prog, config, fwd(obs[sl].to(dev)), fwd(cobs[sl].to(dev)),
                                        noise[sl].to(dev), fwd)
            for k, x in zip(("actions", "log_prob", "mu", "sigma", "values"), (a, lp, mu, sd, val)):
                parts[k].append(x.cpu())
        shape = snap["rewards"].shape
        for k, xs in parts.items():
            x = torch.cat(xs)
            o[k] = x.reshape(*shape, *x.shape[1:])
        o["last_values"] = ac.values(p_prog, config, fwd(snap["final_critic_obs"].to(dev)), fwd).cpu()
        if env_step:
            o["env"] = step_envs(snap, env, o["values"][0], alg["gamma"])
        # GAE from the program's rewards, dones and values
        ret, adv = gae_mod.gae(snap["rewards"].to(dev), snap["dones"].to(dev), snap["values"].to(dev),
                               snap["last_values"].to(dev), alg["gamma"], alg["lam"], gae_r)
        o["returns"], o["advantages"] = ret.cpu(), adv.cpu()
        if not update:
            out.append(o)
            continue
        # the update, from the program's batch and the reference's GAE
        batch = {k: snap[k].to(dev) for k in ROLLOUT_FIELDS}
        mbs = ppo_mod.pack(batch, ret, adv, snap["perm"].to(dev), groups, config, store)
        if half_batch:
            mbs = tuple(x[:, :x.shape[1] // 2] for x in mbs)
        del batch
        state, means, first, kls = ppo_mod.update(state, mbs, config, upd)
        del mbs
        o["metrics"] = {"value_loss": float(means[0]), "surrogate_loss": float(means[1]), "kl": float(means[2]),
                        "lr": float(state["lr"])}
        o["after"] = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in state.items()}
        o["first_grad"] = first.cpu()
        o["kl_margin"] = kl_margin(kls.cpu(), alg)
        out.append(o)
    return out


def _field_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    scale = float(torch.sqrt(torch.mean(want * want)))
    diff = torch.abs(got - want)
    if torch.isnan(diff).any():
        return NAN_GAP
    return float(diff.max()) / (scale if scale > 0 else 1.0)


def _leaf_norms(flat: torch.Tensor, config: dict) -> Dict[str, float]:
    return {name: float(torch.linalg.vector_norm(flat[off: off + math.prod(shape)].double()))
            for name, off, shape in layout(config)}


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], counted: List[str]):
    """(worst gap, its leaf): |got - want| of each leaf's norm over the
    larger of the reference's norm and the median leaf's."""
    med = statistics.median(want[k] for k in counted)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in counted}
    if any(math.isnan(g) for g in gaps.values()):
        return NAN_GAP, next(k for k, g in gaps.items() if math.isnan(g))
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def counted_leaves(first_grad: torch.Tensor, config: dict) -> List[str]:
    norms = _leaf_norms(first_grad, config)
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def loss_of(metrics: Dict[str, float], config: dict) -> float:
    return metrics["surrogate_loss"] + config["algorithm"]["value_loss_coef"] * metrics["value_loss"]


def kl_margin(kls: torch.Tensor, alg: dict) -> float:
    """How near the adaptive rule's thresholds (twice and half the desired
    KL) the reference's grad steps came: the least |KL / threshold - 1|."""
    if alg["schedule"] != "adaptive":
        return math.inf
    k = kls.double()
    return float(min(torch.min(torch.abs(k / (t * alg["desired_kl"]) - 1.0)) for t in (2.0, 0.5)))


def held_updates(want: List[dict], margin: float = KL_MARGIN) -> List[int]:
    """The iterations (from 1) whose update the numbers hold: those in
    which no grad step's KL in the reference came within ``margin`` of a
    threshold of the adaptive rule (the reference's alone decides, so no
    fault of the program can take an update out)."""
    return [i for i, w in enumerate(want, start=1) if w["kl_margin"] >= margin]


def compare(got: List[dict], want: List[dict], p0: torch.Tensor, config: dict) -> Dict[str, dict]:
    """The numbers compared, each with its value and where it was worst.
    ``got``: the program's iterations (snapshots) or the control's;
    ``want``: the reference's over the same iterations."""
    out: Dict[str, dict] = {}
    worst = lambda pairs: dict(zip(("value", "where"), max(pairs or [(0.0, "no update held")], key=lambda p: p[0])))
    pairs = list(enumerate(zip(got, want), start=1))
    if "env" in want[0]:
        gaps = torch.cat([env_gaps(g.get("env") or program_envs(g), w["env"]) for _, (g, w) in pairs])
        off = int((gaps > ENV_TOL).sum())
        out["env_off_pct"] = {"value": 100.0 * off / gaps.numel(),
                              "where": f"{off} of {gaps.numel()} env steps off, largest gap {float(gaps.max())!r}"}
    out["ac_gap"] = worst([(_field_gap(g[k], w[k]), f"iteration {i} {k}") for i, (g, w) in pairs
                           for k in (*POLICY_FIELDS, "last_values")])
    out["gae_gap"] = worst([(_field_gap(g[k], w[k]), f"iteration {i} {k}") for i, (g, w) in pairs
                            for k in ("returns", "advantages")])
    held = held_updates(want)
    losses = []
    for i, (g, w) in pairs:
        if i in held:
            lg, lw = loss_of(g["metrics"], config), loss_of(w["metrics"], config)
            gap = abs(lg - lw) / max(abs(lw), 1e-30)
            losses.append((NAN_GAP if math.isnan(gap) else gap, f"iteration {i}: {lg!r} against {lw!r}"))
    out["loss_gap"] = worst(losses)
    counted = counted_leaves(want[0]["first_grad"], config)
    moves = []
    starts = [p0.cpu()] + [g["after"]["params"] for g in got[:-1]]
    for (i, (g, w)), start in zip(pairs, starts):
        if i in held:
            value, leaf = _worst_leaf(_leaf_norms(g["after"]["params"] - start, config),
                                      _leaf_norms(w["after"]["params"] - start, config), counted)
            moves.append((value, f"iteration {i}, leaf {leaf}"))
    out["dparam_gap"] = worst(moves)
    left_out = [k for k, *_ in layout(config) if k not in counted]
    out["_held"] = {"value": float(len(held)), "where": f"updates held: iterations {held}; leaves left out of "
                                                        f"dparam_gap: {', '.join(left_out) or 'none'}"}
    return out


def verdict(numbers: Dict[str, dict], limits: Dict[str, float]) -> bool:
    return all(numbers[k]["value"] <= limits[k] for k in NUMBERS)


def lines(numbers: Dict[str, dict], limits: Optional[Dict[str, float]]) -> List[str]:
    out = []
    for k in NUMBERS:
        lim = None if limits is None else limits[k]
        out.append(f"check {k} {numbers[k]['value']!r} limit {lim!r} ({numbers[k]['where']})")
    out.append(f"check {numbers['_held']['where']}")
    return out
