"""Recurrent (LSTM) actor-critic (port of ``wiki_grx_gym_tpu/learn/recurrent.py``).

Two LSTM memories, one for the actor and one for the critic, feed the usual
MLP heads; the distribution (learnable per-dim std, log-prob, entropy) is
:class:`networks.ActorCritic`'s.

**Flat parameter buffer.** As the MLP net, every parameter lives in one
float32 buffer, ``params_flat``, in the order JAX's ``ravel_pytree``
(``RecurrentParams``) gives the leaves: each layer of ``memory_a`` as
``w_ih`` (I, 4H), ``w_hh`` (H, 4H), ``b_ih``, ``b_hh``, then ``memory_c``'s,
then the actor's and critic's (W, b) and ``std``. The memories keep JAX's
layout (the cell computes ``x @ w_ih``); the heads are ``nn.Linear`` views
with W (out, in), as in the MLP net (``convert.py`` transposes those only).
The flat clip and Adam of ``PPO._run_epochs`` apply unchanged.

**The cell** is JAX's ``_lstm_cell`` in torch ops, gate order i, f, g, o:
``gates = x @ w_ih + b_ih + h @ w_hh + b_hh``. The update's replay
(:meth:`ActorCriticRecurrent.features_seq`) zeroes the memory of an env in
the middle of a sequence where it was reset, so it runs the same cells, one
step at a time, as the rollout did; ``nn.LSTM`` cannot reset mid-sequence.
JAX computes the LSTM outside any Pallas kernel, and so does the port: plain
torch ops on the card and on the CPU.

Every method takes the parameters as an optional flat vector ``flat``
(default: the bound ``params_flat``), so that the update differentiates the
same code the rollout runs. The heads run in the net's ``compute_dtype``
(JAX ``recurrent.py:145-225``: ``apply_mlp`` with ``self.compute_dtype``;
the memories stay float32) and, under tensor parallelism, split as the MLP
net's with the memories replicated (``networks.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic, apply_mlp, get_activation


class Hidden(NamedTuple):
    """The memories' state, each (L, N, H): h and c of the actor's and of
    the critic's LSTM."""

    ha: torch.Tensor
    ca: torch.Tensor
    hc: torch.Tensor
    cc: torch.Tensor

    def masked(self, live):
        """Each env's state times ``live`` (N,): 0 zeroes a reset env's memory."""
        m = live[None, :, None]
        return Hidden(*(h * m for h in self))

    def select(self, idx):
        """The state of envs ``idx``."""
        return Hidden(*(h[:, idx] for h in self))


def lstm_cell(layer, x, h, c):
    """One LSTM cell (JAX ``_lstm_cell``): ``layer`` = (w_ih (I, 4H), w_hh
    (H, 4H), b_ih, b_hh), gate order i, f, g, o."""
    w_ih, w_hh, b_ih, b_hh = layer
    gates = x @ w_ih + b_ih + h @ w_hh + b_hh
    hd = h.shape[-1]
    i = torch.sigmoid(gates[..., 0 * hd: 1 * hd])
    f = torch.sigmoid(gates[..., 1 * hd: 2 * hd])
    g = torch.tanh(gates[..., 2 * hd: 3 * hd])
    o = torch.sigmoid(gates[..., 3 * hd: 4 * hd])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def memory_step(layers, x, h, c):
    """One step through a stacked LSTM; ``h``/``c`` are (L, N, H). Returns
    (the last layer's output, new h, new c)."""
    hs, cs = [], []
    out = x
    for li, layer in enumerate(layers):
        h_new, c_new = lstm_cell(layer, out, h[li], c[li])
        hs.append(h_new)
        cs.append(c_new)
        out = h_new
    return out, torch.stack(hs), torch.stack(cs)


class ActorCriticRecurrent(ActorCritic):
    """LSTM memories (actor and critic) feeding the MLP heads."""

    def __init__(self, num_actor_input, num_critic_input, num_actions, policy_cfg,
                 generator: torch.Generator = None, mp=None):
        if (getattr(policy_cfg, "rnn_type", None) or "lstm") != "lstm":
            raise NotImplementedError(f"rnn_type {policy_cfg.rnn_type!r}: the port has the LSTM")
        hd = int(policy_cfg.rnn_hidden_size)
        nl = int(policy_cfg.rnn_num_layers)
        prefix = []
        for stack, in_dim in (("memory_a", num_actor_input), ("memory_c", num_critic_input)):
            for li in range(nl):
                i = in_dim if li == 0 else hd
                prefix += [(f"{stack}.{li}.w_ih", (i, 4 * hd)), (f"{stack}.{li}.w_hh", (hd, 4 * hd)),
                           (f"{stack}.{li}.b_ih", (4 * hd,)), (f"{stack}.{li}.b_hh", (4 * hd,))]
        super().__init__(hd, hd, num_actions, policy_cfg, generator, prefix=prefix, mp=mp)
        self.num_actor_input = num_actor_input
        self.num_critic_input = num_critic_input
        self.rnn_hidden = hd
        self.rnn_layers = nl

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        """The heads as ``ActorCritic``'s; every memory tensor U(-1/sqrt(H),
        1/sqrt(H)), torch's LSTM default (JAX ``_init_lstm_layer``)."""
        super().reset_parameters(generator)
        flat = self.params_flat
        for _, off, shape in self.layout[: self.num_prefix]:
            bound = 1.0 / math.sqrt(shape[-1] // 4)
            n = math.prod(shape)
            u = torch.rand(n, generator=generator, device=flat.device, dtype=flat.dtype)
            flat[off: off + n] = -bound + 2.0 * bound * u

    # ---- the parameters as views of a flat vector ----

    def memories(self, flat: Optional[torch.Tensor] = None):
        """(actor layers, critic layers), each a list of (w_ih, w_hh, b_ih,
        b_hh) views of ``flat`` (default ``params_flat``)."""
        flat = self.params_flat if flat is None else flat
        views = [flat[off: off + math.prod(shape)].view(shape)
                 for _, off, shape in self.layout[: self.num_prefix]]
        layers = [tuple(views[4 * i: 4 * i + 4]) for i in range(len(views) // 4)]
        return layers[: self.rnn_layers], layers[self.rnn_layers:]

    def heads(self, feat_a, feat_c, flat: Optional[torch.Tensor] = None):
        """Actor mean and critic value (squeezed) on the memories' features,
        in the net's ``compute_dtype``."""
        flat = self.params_flat if flat is None else flat
        actor, critic, _ = self.leaves(flat)
        mean = v = None
        dt, mp = self.compute_dtype, self.mp
        if feat_a is not None:
            out_act = get_activation(self.actor_out_act) if self.actor_out_act else None
            mean = apply_mlp(actor, feat_a, self._act, out_act, dt, mp)
        if feat_c is not None:
            out_act = get_activation(self.critic_out_act) if self.critic_out_act else None
            v = apply_mlp(critic, feat_c, self._act, out_act, dt, mp)[..., 0]
        return mean, v

    # ---- the memory ----

    def initial_hidden(self, n: int, device=None) -> Hidden:
        device = self.params_flat.device if device is None else device
        z = lambda: torch.zeros((self.rnn_layers, n, self.rnn_hidden), device=device)
        return Hidden(ha=z(), ca=z(), hc=z(), cc=z())

    # ---- one step (rollout, play) ----

    def act_evaluate_rnn(self, obs, critic_obs, hidden: Hidden, noise):
        """Rollout step: both memories one cell, the actor's sample with the
        given standard-normal ``noise`` (N, A) and the critic's value.
        Returns (actions, log_prob, mean, std, value, new hidden)."""
        mem_a, mem_c = self.memories()
        feat_a, ha, ca = memory_step(mem_a, obs, hidden.ha, hidden.ca)
        feat_c, hc, cc = memory_step(mem_c, critic_obs, hidden.hc, hidden.cc)
        mean, v = self.heads(feat_a, feat_c)
        std = self.std().expand_as(mean)
        actions = mean + std * noise
        logp = self.log_prob(mean, std, actions)
        return actions, logp, mean, std, v, Hidden(ha, ca, hc, cc)

    def evaluate_rnn(self, critic_obs, hidden: Hidden):
        """The critic's value and the hidden state with its memory stepped."""
        _, mem_c = self.memories()
        feat, hc, cc = memory_step(mem_c, critic_obs, hidden.hc, hidden.cc)
        return self.heads(None, feat)[1], hidden._replace(hc=hc, cc=cc)

    def act_inference_rnn(self, obs, hidden: Hidden):
        """The actor's mean and the hidden state with its memory stepped."""
        mem_a, _ = self.memories()
        feat, ha, ca = memory_step(mem_a, obs, hidden.ha, hidden.ca)
        return self.heads(feat, None)[0], hidden._replace(ha=ha, ca=ca)

    # ---- sequence replay (update) ----

    @staticmethod
    def features_seq(layers, xs, done_prev, h0, c0):
        """Run one memory over (T, N, I), zeroing the state of the envs where
        ``done_prev[t]`` (reset after step t - 1): the rollout's per-step
        states, without padding. Returns the features (T, N, H)."""
        h, c = h0, c0
        feats = []
        for t in range(xs.shape[0]):
            live = (1.0 - done_prev[t])[None, :, None]
            out, h, c = memory_step(layers, xs[t], h * live, c * live)
            feats.append(out)
        return torch.stack(feats)

    def action_mean_seq(self, obs_seq, done_prev, hidden0: Hidden, flat=None):
        mem_a, _ = self.memories(flat)
        feats = self.features_seq(mem_a, obs_seq, done_prev, hidden0.ha, hidden0.ca)
        return self.heads(feats, None, flat)[0]

    def joint_mean_value_seq(self, obs_seq, cobs_seq, done_prev, hidden0: Hidden, flat=None):
        """The update's replay: both memories over T, the heads on all (T,
        N) features at once. Returns (mean (T, N, A), value (T, N))."""
        mem_a, mem_c = self.memories(flat)
        fa = self.features_seq(mem_a, obs_seq, done_prev, hidden0.ha, hidden0.ca)
        fc = self.features_seq(mem_c, cobs_seq, done_prev, hidden0.hc, hidden0.cc)
        return self.heads(fa, fc, flat)
