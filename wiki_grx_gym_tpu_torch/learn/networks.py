"""Actor-critic MLP (port of ``wiki_grx_gym_tpu/learn/networks.py``).

Separate actor and critic MLP stacks ([512, 256, 128] ELU for GR1T1), a
learnable per-dim raw std (not log-std), and torch-default ``nn.Linear``
initialization drawn from an explicit generator. Matrix products stay
``torch.matmul`` (``nn.Linear``), as the JAX package left them to XLA.

**Flat parameter buffer.** Every parameter lives in one contiguous float32
buffer, ``params_flat``; the ``nn.Linear`` weights and biases and
``std_param`` are views into it, so the PPO kernels and the optimizer
address each leaf by offset (``layout``). The leaves are ordered as JAX's
``ravel_pytree(ActorCriticParams)`` orders them: actor W0, b0, W1, b1, ...,
then the critic's, then std. **Weights are stored (out, in)**, as
``nn.Linear`` keeps them; JAX stores them (in, out), so ``convert.py``
transposes. :meth:`ActorCritic.bind` points the views at another flat
buffer (the optimizer's new params) without copying.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

_LOG_2PI = math.log(2.0 * math.pi)

_ACTIVATIONS = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "selu": nn.SELU,
    "lrelu": nn.LeakyReLU,
    "tanh": nn.Tanh,
    "sigmoid": nn.Sigmoid,
}


def get_activation(name):
    if name in (None, "none"):
        return nn.Identity()
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} is not ported")
    return _ACTIVATIONS[name]()


def make_mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str,
             out_activation=None) -> nn.Sequential:
    dims = [in_dim] + list(hidden) + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        layers.append(nn.Linear(dims[i], dims[i + 1]))
        if i < len(dims) - 2:
            layers.append(get_activation(activation))
    if out_activation:
        layers.append(get_activation(out_activation))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Actor and critic MLPs plus the learnable std."""

    def __init__(self, num_actor_input, num_critic_input, num_actions, policy_cfg,
                 generator: torch.Generator = None, prefix=()):
        """``prefix``: (name, shape) leaves that come before the heads in the
        flat buffer (the recurrent net's memories, ``learn/recurrent.py``)."""
        super().__init__()
        self.num_actor_input = num_actor_input
        self.num_critic_input = num_critic_input
        self.num_actions = num_actions
        self.actor_hidden = list(policy_cfg.actor_hidden_dims)
        self.critic_hidden = list(policy_cfg.critic_hidden_dims)
        self.activation = policy_cfg.activation
        self.actor_out_act = policy_cfg.actor_output_activation
        self.critic_out_act = policy_cfg.critic_output_activation
        self.actor = make_mlp(num_actor_input, self.actor_hidden, num_actions,
                              policy_cfg.activation, policy_cfg.actor_output_activation)
        self.critic = make_mlp(num_critic_input, self.critic_hidden, 1,
                               policy_cfg.activation, policy_cfg.critic_output_activation)
        self.fused = (
            self.actor_hidden == self.critic_hidden
            and not policy_cfg.actor_output_activation
            and not policy_cfg.critic_output_activation
        )
        self.fixed_std = bool(policy_cfg.fixed_std)
        self.init_noise_std = float(policy_cfg.init_noise_std)
        self.noise_std_floor = float(getattr(policy_cfg, "noise_std_floor", 0.0))
        if (getattr(policy_cfg, "compute_dtype", "float32") or "float32") != "float32":
            raise NotImplementedError("compute_dtype='bfloat16' (bf16 policy matmuls) is "
                                      "ROADMAP queue 1 item 16")
        # the flat buffer: (name, offset, shape) per leaf, ravel_pytree order
        self.layout = []
        off = 0
        for name, shape in prefix:
            self.layout.append((name, off, tuple(shape)))
            off += math.prod(shape)
        self.num_prefix = len(prefix)
        for stack, lins in (("actor", self._linears(self.actor)),
                            ("critic", self._linears(self.critic))):
            for i, lin in enumerate(lins):
                for kind in ("weight", "bias"):
                    shape = tuple(getattr(lin, kind).shape)
                    self.layout.append((f"{stack}.{i}.{kind}", off, shape))
                    off += math.prod(shape)
                    del lin._parameters[kind]   # becomes a view into params_flat
        self.layout.append(("std", off, (num_actions,)))
        self.num_params = off + num_actions
        self.register_buffer("params_flat", torch.zeros(self.num_params))
        self._bind_views()
        self.reset_parameters(generator)

    @staticmethod
    def _linears(seq):
        return [m for m in seq if isinstance(m, nn.Linear)]

    def _bind_views(self):
        flat = self.params_flat
        leaves = iter(self.layout[self.num_prefix:])
        for lin in self.linears():
            for kind in ("weight", "bias"):
                _, off, shape = next(leaves)
                setattr(lin, kind, flat[off: off + math.prod(shape)].view(shape))
        _, off, shape = next(leaves)
        self.std_param = flat[off: off + shape[0]]

    def _apply(self, fn, recurse=True):
        # .to()/.double() move params_flat; the views follow it
        super()._apply(fn, recurse)
        self._bind_views()
        return self

    def bind(self, flat: torch.Tensor):
        """Make ``flat`` (shape ``(num_params,)``, this module's device and
        dtype) the parameter buffer; the layer views point into it."""
        if flat.shape != (self.num_params,) or not flat.is_contiguous():
            raise ValueError(f"expected a contiguous ({self.num_params},) buffer, got {tuple(flat.shape)}")
        self.params_flat = flat
        self._bind_views()

    def leaves(self, flat: torch.Tensor):
        """``flat`` cut into the (actor pairs, critic pairs, std) views of this
        layout: ``([(W (out, in), b), ...], [(W, b), ...], std)``."""
        views = [flat[off: off + math.prod(shape)].view(shape)
                 for _, off, shape in self.layout[self.num_prefix:]]
        na = len(self._linears(self.actor))
        pairs = list(zip(views[:-1:2], views[1:-1:2]))
        return pairs[:na], pairs[na:], views[-1]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """torch.nn.Linear default init (kaiming-uniform(a=sqrt(5)) for W,
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for b) from ``generator``."""
        for lin in self.linears():
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator, device=p.device, dtype=p.dtype)
                p.copy_(-bound + 2.0 * bound * u)
        self.std_param.fill_(self.init_noise_std)

    def linears(self):
        return self._linears(self.actor) + self._linears(self.critic)

    # ---- distribution ops ----

    def action_mean(self, obs, flat=None):
        """The actor's mean; with ``flat``, as a function of that flat
        parameter vector (for autograd) instead of the bound buffer."""
        if flat is None:
            return self.actor(obs)
        pairs = self.leaves(flat)[0]
        act = get_activation(self.activation)
        x = obs
        for w, b in pairs[:-1]:
            x = act(x @ w.t() + b)
        w, b = pairs[-1]
        x = x @ w.t() + b
        return get_activation(self.actor_out_act)(x) if self.actor_out_act else x

    def std(self):
        if self.fixed_std:
            return torch.full((self.num_actions,), self.init_noise_std,
                              device=self.std_param.device)
        if self.noise_std_floor > 0.0:
            return torch.clamp(self.std_param, min=self.noise_std_floor)
        return self.std_param

    def act(self, obs, noise):
        """Sample actions with the given standard-normal ``noise`` (N, A);
        returns (actions, log_prob, mean, std)."""
        mean = self.action_mean(obs)
        std = self.std().expand_as(mean)
        actions = mean + std * noise
        return actions, self.log_prob(mean, std, actions), mean, std

    @staticmethod
    def log_prob(mean, std, actions):
        var = torch.square(std)
        lp = -0.5 * (torch.square(actions - mean) / var + _LOG_2PI) - torch.log(std)
        return torch.sum(lp, dim=-1)

    @staticmethod
    def entropy(std):
        return torch.sum(0.5 + 0.5 * _LOG_2PI + torch.log(std), dim=-1)

    def act_inference(self, obs):
        return self.action_mean(obs)

    def evaluate(self, critic_obs):
        return torch.squeeze(self.critic(critic_obs), dim=-1)

    def joint_mean_value(self, obs, critic_obs):
        """Actor mean and critic value as one stacked batched-matmul trunk
        (same math as the two stacks; used where ``algorithm.fused_trunk``
        selects it)."""
        if not self.fused:
            return self.action_mean(obs), self.evaluate(critic_obs)
        act = self.actor[1]
        la = [m for m in self.actor if isinstance(m, nn.Linear)]
        lc = [m for m in self.critic if isinstance(m, nn.Linear)]
        x = torch.stack([act(la[0](obs)), act(lc[0](critic_obs))])
        for a_l, c_l in zip(la[1:-1], lc[1:-1]):
            w = torch.stack([a_l.weight.t(), c_l.weight.t()])
            b = torch.stack([a_l.bias, c_l.bias])
            x = act(torch.bmm(x, w) + b[:, None, :])
        a = self.num_actions
        wo, wv = la[-1].weight.t(), lc[-1].weight.t()
        w_out = torch.stack([wo, torch.nn.functional.pad(wv, (0, a - 1))])
        b_out = torch.stack([la[-1].bias, torch.nn.functional.pad(lc[-1].bias, (0, a - 1))])
        y = torch.bmm(x, w_out) + b_out[:, None, :]
        return y[0], y[1][:, 0]
