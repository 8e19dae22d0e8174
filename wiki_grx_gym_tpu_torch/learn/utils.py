"""Learner-side utilities (port of ``wiki_grx_gym_tpu/learn/utils.py``, which
mirrors ``rsl_rl/utils/utils.py``):

- :class:`RunningMeanStd`: running mean and variance by the parallel
  (Chan) update, functional: ``update`` returns a new object;
- :func:`split_and_pad_trajectories` / :func:`unpad_trajectories`:
  trajectory padding for recurrent policies with static shapes (each env
  column split at its dones and re-based to row 0, plus validity masks);
- :func:`quaternion_slerp`, branchless;
- :func:`swap_lr`: left/right channel swap for mirror-symmetry losses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(shape: Tuple[int, ...] = (), epsilon: float = 1e-4, device=None) -> "RunningMeanStd":
        return RunningMeanStd(mean=torch.zeros(shape, device=device),
                              var=torch.ones(shape, device=device),
                              count=torch.tensor(epsilon, dtype=torch.float32, device=device))

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        batch_mean = torch.mean(batch, dim=0)
        batch_var = torch.var(batch, dim=0, correction=0)   # jnp.var: the population variance
        batch_count = batch.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m2 = (self.var * self.count + batch_var * batch_count
              + torch.square(delta) * self.count * batch_count / tot)
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = 10.0, epsilon: float = 1e-4) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + epsilon), -clip, clip)


class Normalizer(RunningMeanStd):
    """Alias with the reference's clip-on-normalize defaults."""


def split_and_pad_trajectories(tensor: torch.Tensor, dones: torch.Tensor):
    """(T, N, F) and dones (T, N) -> (T, N, F) with each env's trajectories
    re-based to row 0 (a later trajectory of the column overwrites the
    rows of an earlier one it reaches, as the JAX scatter does), and (T, N)
    validity masks. The last row counts as a done."""
    t, n = dones.shape
    dones = dones.clone().to(torch.bool)
    dones[-1] = True
    step_idx = torch.arange(t, device=dones.device)[:, None]
    first = torch.cat([torch.ones((1, n), dtype=torch.bool, device=dones.device), dones[:-1]], dim=0)
    start = torch.where(first, step_idx, torch.zeros_like(step_idx))
    start = torch.cummax(start, dim=0).values
    pos = step_idx - start
    out = torch.zeros_like(tensor)
    mask = torch.zeros((t, n), dtype=torch.bool, device=dones.device)
    env_idx = torch.arange(n, device=dones.device)[None, :].expand(t, n)
    out[pos, env_idx] = tensor
    mask[pos, env_idx] = True
    return out, mask


def unpad_trajectories(trajectories: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """The padded rows zeroed: the static-shape inverse for loss masking."""
    return trajectories * masks[..., None]


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, fraction: torch.Tensor,
                     spin: int = 0, shortestpath: bool = True) -> torch.Tensor:
    """Batched slerp, branchless; a lerp at tiny angles, q0 / q1 at fraction
    0 / 1 (``torch.isclose`` with numpy's tolerances, as ``jnp.isclose``)."""
    eps = 1e-7
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    if shortestpath:
        q1 = torch.where(d < 0, -q1, q1)
        d = torch.abs(d)
    d = torch.clamp(d, -1.0, 1.0)
    angle = torch.arccos(d) + spin * math.pi
    safe = torch.abs(angle) > eps
    isin = 1.0 / torch.where(safe, angle, torch.ones_like(angle))
    f = fraction[..., None] if fraction.dim() < q0.dim() else fraction
    s0 = torch.sin((1.0 - f) * angle) * isin
    s1 = torch.sin(f * angle) * isin
    blended = s0 * q0 + s1 * q1
    lerp = (1.0 - f) * q0 + f * q1
    out = torch.where(safe, blended, lerp)
    close = lambda x, v: torch.isclose(x, torch.full_like(x, v), rtol=1e-5, atol=1e-8)
    out = torch.where(close(f, 0.0), q0, out)
    out = torch.where(close(f, 1.0), q1, out)
    return out


def swap_lr(value: torch.Tensor, left_idx: Sequence[int], right_idx: Sequence[int]) -> torch.Tensor:
    """Swap left/right channels along the last axis (a new tensor)."""
    assert len(left_idx) == len(right_idx)
    swapped = value.clone()
    for l, r in zip(left_idx, right_idx):
        swapped[..., l] = value[..., r]
        swapped[..., r] = value[..., l]
    return swapped
