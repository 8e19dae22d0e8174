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

**bf16 compute** (``policy.compute_dtype = "bfloat16"``, or ``dtype=`` on a
forward): :func:`apply_mlp`'s contract, JAX's ``apply_mlp``: the input is
cast to bf16; each hidden layer is a bf16 x bf16 product rounded to bf16,
plus the bf16-rounded bias, then the activation in bf16; the last layer
multiplies the bf16-rounded operands in float32 (``x.float() @
w.to(bf16).float().t()``: float32 products and sums, as JAX's
``preferred_element_type=float32``) and adds the float32 bias. The params
stay float32.

**Tensor parallelism** (``mp``, a ``parallel.mesh.TensorParallel``): JAX's
Megatron split (``parallel/sharding.py:shard_params``). Even layers of each
stack are column-parallel (a rank holds rows of W (out, in) and of b), odd
layers row-parallel (columns of W; b replicated, added after the sum);
``std`` and the recurrent net's memories are replicated. The buffer holds
only this rank's shard (``layout`` has the shard's shapes, ``full_layout``
the whole net's; ``parallel.sharding.shard_flat``/``gather_flat`` move
between them). The forward sums a row-parallel product over the mp group
(:class:`_ReduceFromMP`: all-reduce forward, identity backward) and, ahead
of a column-parallel layer whose input needs a gradient, all-reduces that
gradient (:class:`_CopyToMP`: identity forward, all-reduce backward); the
first layer's input is data, and gets none. A stack that ends on a
column-parallel layer gathers its output's columns (:class:`_GatherFromMP`).
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

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

_UNSET = object()   # sentinel: "use the network's configured compute_dtype"


def get_activation(name):
    if name in (None, "none"):
        return nn.Identity()
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} is not ported")
    return _ACTIVATIONS[name]()


def compute_dtype_of(name):
    """``"float32"`` -> None (float32 throughout), ``"bfloat16"`` ->
    ``torch.bfloat16``, as JAX's table (``networks.py:128-129``)."""
    name = str(name or "float32")
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def make_mlp(in_dim: int, hidden: Sequence[int], out_dim: int, activation: str,
             out_activation=None, num_mp: int = 1) -> nn.Sequential:
    """The stack's ``nn.Linear`` layers; with ``num_mp > 1`` each holds one
    rank's shard (:func:`shard_shape`)."""
    dims = [in_dim] + list(hidden) + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        out_f, in_f = shard_shape(i, (dims[i + 1], dims[i]), num_mp)
        layers.append(nn.Linear(in_f, out_f))
        if i < len(dims) - 2:
            layers.append(get_activation(activation))
    if out_activation:
        layers.append(get_activation(out_activation))
    return nn.Sequential(*layers)


def split_axis(name: str):
    """The axis of leaf ``name`` (a ``layout`` name) that tensor parallelism
    splits, or None for a replicated leaf: layer i's W (out, in) on axis 0
    for even i (column-parallel), on axis 1 for odd i (row-parallel); the
    bias of an even layer on axis 0; odd layers' biases, ``std`` and the
    memories are replicated."""
    parts = name.split(".")
    if len(parts) != 3 or parts[0] not in ("actor", "critic"):
        return None
    i, kind = int(parts[1]), parts[2]
    if i % 2 == 0:
        return 0
    return 1 if kind == "weight" else None


def shard_shape(layer: int, shape, num_mp: int):
    """Layer ``layer``'s W shape (out, in) on one of ``num_mp`` ranks."""
    out_f, in_f = shape
    if num_mp == 1:
        return out_f, in_f
    axis = 0 if layer % 2 == 0 else 1
    n = shape[axis]
    if n % num_mp:
        # as jax.device_put refuses a dimension the mp axis does not divide
        raise ValueError(f"layer {layer}'s dimension {n} is not divisible by num_mp={num_mp}")
    return (out_f // num_mp, in_f) if axis == 0 else (out_f, in_f // num_mp)


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient summed over the mp group (ahead of a
    column-parallel layer whose input is replicated)."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_reduce_sum(g.contiguous().clone()), None


class _ReduceFromMP(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the mp group
    (in float32); identity backward."""

    @staticmethod
    def forward(ctx, y, mp):
        return mp.all_reduce_sum(y.to(torch.float32).contiguous().clone()).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """The columns of a column-parallel output gathered in mp order; the
    backward keeps this rank's columns (every rank's loss is the same)."""

    @staticmethod
    def forward(ctx, y, mp):
        ctx.mp, ctx.width = mp, y.shape[-1]
        return torch.cat(list(mp.all_gather(y.contiguous())), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mp.rank * ctx.width
        return g[..., lo: lo + ctx.width], None


def _layer(x, w, b, i, n, dtype, mp):
    """Layer ``i`` of ``n``: ``x @ w^T + b`` with W (out, in) (or stacked
    (S, out, in) against x (S, B, in), b (S, 1, out)) under the bf16
    contract of :func:`apply_mlp` and, with ``mp``, the split of layer i."""
    last = i == n - 1
    if mp is not None and i % 2 == 0 and x.requires_grad:
        x = _CopyToMP.apply(x, mp)
    wt = w.transpose(-1, -2)
    if dtype is None:
        y = x @ wt
    elif last:
        y = x.float() @ wt.to(dtype).float()
    else:
        y = x @ wt.to(dtype)
    if mp is not None and i % 2 == 1:
        y = _ReduceFromMP.apply(y, mp)
    return y + (b if dtype is None or last else b.to(dtype))


def apply_mlp(pairs, x, activation, out_activation=None, dtype=None, mp=None):
    """MLP forward over ``pairs`` [(W (out, in), b), ...] (JAX ``apply_mlp``;
    the bf16 contract and the mp split are the module docstring's). Returns
    float32 with ``dtype`` bf16."""
    n = len(pairs)
    if dtype is not None:
        x = x.to(dtype)
    for i, (w, b) in enumerate(pairs):
        x = _layer(x, w, b, i, n, dtype, mp)
        if i < n - 1:
            x = activation(x)
    if mp is not None and (n - 1) % 2 == 0:
        x = _GatherFromMP.apply(x, mp)
    if out_activation is not None:
        x = out_activation(x)
    return x


class ActorCritic(nn.Module):
    """Actor and critic MLPs plus the learnable std."""

    def __init__(self, num_actor_input, num_critic_input, num_actions, policy_cfg,
                 generator: torch.Generator = None, prefix=(), mp=None):
        """``prefix``: (name, shape) leaves that come before the heads in the
        flat buffer (the recurrent net's memories, ``learn/recurrent.py``).
        ``mp``: this rank's ``parallel.mesh.TensorParallel`` (None: the whole
        net in one process)."""
        super().__init__()
        self.num_actor_input = num_actor_input
        self.num_critic_input = num_critic_input
        self.num_actions = num_actions
        self.actor_hidden = list(policy_cfg.actor_hidden_dims)
        self.critic_hidden = list(policy_cfg.critic_hidden_dims)
        self.activation = policy_cfg.activation
        self.actor_out_act = policy_cfg.actor_output_activation
        self.critic_out_act = policy_cfg.critic_output_activation
        self.mp = mp
        num_mp = 1 if mp is None else mp.world
        self.actor = make_mlp(num_actor_input, self.actor_hidden, num_actions,
                              policy_cfg.activation, policy_cfg.actor_output_activation, num_mp)
        self.critic = make_mlp(num_critic_input, self.critic_hidden, 1,
                               policy_cfg.activation, policy_cfg.critic_output_activation, num_mp)
        self.fused = (
            self.actor_hidden == self.critic_hidden
            and len(self.actor_hidden) >= 1
            and not policy_cfg.actor_output_activation
            and not policy_cfg.critic_output_activation
        )
        self.fixed_std = bool(policy_cfg.fixed_std)
        self.init_noise_std = float(policy_cfg.init_noise_std)
        self.noise_std_floor = float(getattr(policy_cfg, "noise_std_floor", 0.0))
        # bf16 policy matmuls (params, optimizer and distribution math stay f32)
        self.compute_dtype = compute_dtype_of(getattr(policy_cfg, "compute_dtype", "float32"))
        self._act = get_activation(self.activation)
        # the flat buffer: (name, offset, shape) per leaf, ravel_pytree order;
        # full_layout: the same leaves at the whole net's shapes
        self.layout, self.full_layout = [], []
        off = full_off = 0
        for name, shape in prefix:
            self.layout.append((name, off, tuple(shape)))
            self.full_layout.append((name, full_off, tuple(shape)))
            off += math.prod(shape)
            full_off += math.prod(shape)
        self.num_prefix = len(prefix)
        for stack, lins, dims in (("actor", self._linears(self.actor),
                                   [num_actor_input] + self.actor_hidden + [num_actions]),
                                  ("critic", self._linears(self.critic),
                                   [num_critic_input] + self.critic_hidden + [1])):
            for i, lin in enumerate(lins):
                for kind, full in (("weight", (dims[i + 1], dims[i])), ("bias", (dims[i + 1],))):
                    shape = tuple(getattr(lin, kind).shape)
                    self.layout.append((f"{stack}.{i}.{kind}", off, shape))
                    self.full_layout.append((f"{stack}.{i}.{kind}", full_off, full))
                    off += math.prod(shape)
                    full_off += math.prod(full)
                    del lin._parameters[kind]   # becomes a view into params_flat
        self.layout.append(("std", off, (num_actions,)))
        self.full_layout.append(("std", full_off, (num_actions,)))
        self.num_params = off + num_actions
        self.full_num_params = full_off + num_actions
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

    def split_mask(self) -> torch.Tensor:
        """(num_params,) bool on the buffer's device: True where the entry
        belongs to a leaf that tensor parallelism splits."""
        mask = torch.zeros(self.num_params, dtype=torch.bool, device=self.params_flat.device)
        for name, off, shape in self.layout:
            if self.mp is not None and split_axis(name) is not None:
                mask[off: off + math.prod(shape)] = True
        return mask

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """torch.nn.Linear default init (kaiming-uniform(a=sqrt(5)) for W,
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for b) from ``generator``, drawn
        at the whole net's shapes (a tensor-parallel rank keeps its shard of
        the same draws)."""
        fan_in = 1
        for (name, _, shape), (_, off, local) in zip(self.full_layout[self.num_prefix:-1],
                                                      self.layout[self.num_prefix:-1]):
            if name.endswith(".weight"):
                fan_in = shape[1]
            bound = 1.0 / math.sqrt(fan_in)
            u = torch.rand(shape, generator=generator, device=self.params_flat.device,
                           dtype=self.params_flat.dtype)
            u = self._shard_of(name, u)
            self.params_flat[off: off + math.prod(local)] = (-bound + 2.0 * bound * u).reshape(-1)
        self.std_param.fill_(self.init_noise_std)

    def _shard_of(self, name, x):
        """This rank's shard of leaf ``name`` given whole (``x`` itself
        without ``mp`` or for a replicated leaf)."""
        axis = split_axis(name)
        if self.mp is None or axis is None:
            return x
        return x.chunk(self.mp.world, dim=axis)[self.mp.rank]

    def linears(self):
        return self._linears(self.actor) + self._linears(self.critic)

    # ---- distribution ops ----

    def _dtype(self, dtype):
        return self.compute_dtype if dtype is _UNSET else dtype

    def _plain(self, flat, dt):
        """Whether the bound modules compute this forward as they are (the
        bound buffer, float32, one process)."""
        return flat is None and dt is None and self.mp is None

    def action_mean(self, obs, flat=None, dtype=_UNSET):
        """The actor's mean; with ``flat``, as a function of that flat
        parameter vector (for autograd) instead of the bound buffer.
        ``dtype``: the compute dtype (default the net's ``compute_dtype``)."""
        dt = self._dtype(dtype)
        if self._plain(flat, dt):
            return self.actor(obs)
        pairs = self.leaves(self.params_flat if flat is None else flat)[0]
        out_act = get_activation(self.actor_out_act) if self.actor_out_act else None
        return apply_mlp(pairs, obs, self._act, out_act, dt, self.mp)

    def std(self):
        if self.fixed_std:
            return torch.full((self.num_actions,), self.init_noise_std,
                              device=self.std_param.device)
        if self.noise_std_floor > 0.0:
            return torch.clamp(self.std_param, min=self.noise_std_floor)
        return self.std_param

    def act(self, obs, noise, dtype=_UNSET):
        """Sample actions with the given standard-normal ``noise`` (N, A);
        returns (actions, log_prob, mean, std)."""
        mean = self.action_mean(obs, dtype=dtype)
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

    def evaluate(self, critic_obs, dtype=_UNSET, flat=None):
        dt = self._dtype(dtype)
        if self._plain(flat, dt):
            return torch.squeeze(self.critic(critic_obs), dim=-1)
        pairs = self.leaves(self.params_flat if flat is None else flat)[1]
        out_act = get_activation(self.critic_out_act) if self.critic_out_act else None
        return torch.squeeze(apply_mlp(pairs, critic_obs, self._act, out_act, dt, self.mp), dim=-1)

    def joint_mean_value(self, obs, critic_obs, dtype=_UNSET, flat=None):
        """Actor mean and critic value as one stacked batched-matmul trunk
        (same math as the two stacks, JAX ``joint_mean_value``; used where
        ``algorithm.fused_trunk`` selects it): the first layers apart (their
        inputs differ in width), the hidden layers as (2, in, out) products,
        the heads padded to the actions' width and stacked."""
        dt = self._dtype(dtype)
        if not self.fused:
            return (self.action_mean(obs, flat=flat, dtype=dt),
                    self.evaluate(critic_obs, dtype=dt, flat=flat))
        la, lc, _ = self.leaves(self.params_flat if flat is None else flat)
        n, mp, act = len(la), self.mp, self._act
        if dt is not None:
            obs, critic_obs = obs.to(dt), critic_obs.to(dt)
        x = torch.stack([act(_layer(obs, *la[0], 0, n, dt, mp)),
                         act(_layer(critic_obs, *lc[0], 0, n, dt, mp))])
        for i in range(1, n - 1):
            w = torch.stack([la[i][0], lc[i][0]])
            b = torch.stack([la[i][1], lc[i][1]])[:, None, :]
            x = act(_layer(x, w, b, i, n, dt, mp))
        (wo, bo), (wv, bv) = la[-1], lc[-1]
        pad = wo.shape[0] - wv.shape[0]
        w_out = torch.stack([wo, torch.nn.functional.pad(wv, (0, 0, 0, pad))])
        b_out = torch.stack([bo, torch.nn.functional.pad(bv, (0, pad))])[:, None, :]
        # (under mp the last layer is row-parallel: the critic's single
        # output column cannot be split, so shard_shape refuses the other case)
        y = _layer(x, w_out, b_out, n - 1, n, dt, mp)
        return y[0], y[1][:, 0]
