"""PPO: GAE, the minibatch shuffle and the update (port of
``wiki_grx_gym_tpu/learn/ppo.py``).

Semantics are the JAX package's, which mirror ``rsl_rl``'s PPO: timeout
bootstrapping in the rollout, GAE with advantage normalisation, the clipped
surrogate + clipped value loss + entropy bonus, the adaptive-KL learning
rate, the NaN-loss skip, clip by global norm and Adam.

``update`` has the JAX package's three paths, chosen by the same config keys
(``update_recurrent``, the LSTM net's, is the xla path's autograd over an
LSTM replay of whole env columns):

- **mega** (``fused_mega=True``, the default): the whole update as K3
  (``FusedPPOGrad.update_scan``, ``learn/fused_update.py``);
- **step** (``fused_mega=False``): K2 per grad step (through
  ``FusedPPOGrad.step_context``, K2's context made once an update), then
  clip and Adam in plain torch;
- **xla** (``fused_update=False``): ``torch.autograd`` of
  :meth:`PPO._minibatch_loss`, with the same clip and Adam. The loss runs
  the MLPs in ``algorithm.update_dtype`` (bf16 under JAX's contract,
  ``networks.apply_mlp``), as one stacked trunk with
  ``algorithm.fused_trunk`` (``networks.joint_mean_value``), and with
  ``algorithm.remat_update`` under ``torch.utils.checkpoint`` (its
  activations recomputed in the backward; JAX's ``jax.checkpoint``, on this
  path only). K2's operands are f32 only when both ``storage_dtype`` and
  ``update_dtype`` are f32 (``ppo.py:469-473``), else bf16.

``fused_update="auto"`` selects the kernel paths wherever
``FusedPPOGrad.supported`` holds (MLP, ELU, no extra loss), on any device:
CPU tensors run the kernels' plain versions. An extra loss term
(``extra_loss_fn(flat, minibatch)``, the symmetry loss of
``learn/symmetry.py``) therefore always takes the xla path. Each path
mirrors its own JAX counterpart, including where they differ: the step and
xla paths use optax's clip ``(g / norm) * max`` and bias correction
``1 - b**count``, K3 its own ``g * (max / norm)`` and ``1 - exp(count log
b)``; the xla loss differentiates through ``max(std, floor)``, the kernels
use the raw std.

**Data parallel** (``dp``, a ``parallel.mesh.DataParallel``): each rank
holds its shard of the envs and updates on its group-local minibatches; the
gradient, loss and metrics are all-reduced to their mean once a grad step,
between the gradient and the adaptive LR, the NaN skip, clip and Adam
(``ppo.py:600-640``), so every rank takes the same step. GAE's advantage
mean and std are over the global batch, and every rank uses rank 0's block
permutation. With ``perm_groups`` a multiple of the group's size each rank
shuffles its own groups; at the group's size the step path runs K2 per
shard (JAX turns the mega path off on a dp mesh, ``ppo.py:172-174``), and
``perm_groups > 1`` otherwise selects the xla path, as in JAX
(``ppo.py:166-169``).

**The global shuffle** (``perm_groups`` that the group's size does not
divide; 1 is the reference's shuffle, ``base_storage.py:157-198``, and the
run JAX's CLI makes on a mesh, ``scripts/train.py:25-26``): the update
first all-gathers its inputs over the dp group in global env order
(``parallel.sharding.gather_envs``, one buffer: the rollout fields, returns
and advantages, on the recurrent path also the dones and the start
memories), then every rank runs the one-process update on the global batch
with rank 0's permutation and no gradient all-reduce: every rank holds the
whole gradient, so the ranks stay bit-identical. This is what XLA does for
JAX: the kernels, which have no sharding rule, run on gathered operands on
every device. The paths are JAX's one-process rule: ``perm_groups == 1``
takes the kernels (mega, or step with ``fused_mega = False``), any other
count the xla path.

**Tensor parallel** (``dp.mp``, ``parallel.mesh.make_mesh``): the xla path
only, as JAX keeps its XLA update under mp (``ppo.py:153``); the flat
buffer, Adam's moments and the gradient are this rank's shard, and the
optimizer is elementwise on it, as JAX's leaf-by-leaf optax
(``flat_optimizer=False``). The gradient is averaged over the dp group;
clip by global norm sums the squares of the split entries over the mp
group and adds the replicated entries once. Losses, KL and the NaN skip are
the same on mp peers, which compute the same loss.

Clip by global norm and Adam are written out with optax's formulas (``eps``
outside the sqrt, ``eps_root`` 0, the count carried across updates); no
``torch.optim``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad, _jclip, _jmax, scalar
from wiki_grx_gym_tpu_torch.learn.networks import compute_dtype_of
from wiki_grx_gym_tpu_torch.parallel import sharding

_INT32_MAX = 2**31 - 1


def _long_on(x, device) -> torch.Tensor:
    """``x`` (a tensor or a sequence of indices) as an int64 tensor on
    ``device``; a tensor is moved, not rebuilt from the host."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x)
    if x.device != device:
        x = x.to(device)
    return x.to(torch.long)


@dataclasses.dataclass
class PPOState:
    params: torch.Tensor          # (P,) float32, networks.ActorCritic.layout
    m: torch.Tensor               # (P,) Adam first moment
    v: torch.Tensor               # (P,) Adam second moment
    count: torch.Tensor           # () int32 Adam step count
    learning_rate: torch.Tensor   # () float32, adapted by KL

    def replace(self, **kw) -> "PPOState":
        return dataclasses.replace(self, **kw)


class PPO:
    def __init__(self, net, alg_cfg, extra_loss_fn=None, perm_groups: int = 1,
                 shuffle_block: int = 16, dp=None):
        """``perm_groups``: env groups the block shuffle is local to, each
        minibatch drawing equally from every group (``ppo.py:61-67``); with
        ``dp`` each rank holds ``perm_groups / world`` of them where the
        group's size divides ``perm_groups``, else the update gathers the
        global batch (the module docstring's global shuffle). ``dp``: the
        run's ``DataParallel`` (its dp view and ``mp`` under tensor
        parallelism; ``net`` is then the rank's tensor-parallel net)."""
        world = 1 if dp is None else dp.world
        if int(perm_groups) < 1:
            raise ValueError(f"perm_groups must be >= 1, got {perm_groups}")
        # the global shuffle: every rank updates on the gathered global batch
        self.gathered = bool(int(perm_groups) % world)
        self.mp = None if dp is None else dp.mp
        if (self.mp is None) != (getattr(net, "mp", None) is None):
            raise ValueError("a tensor-parallel run needs the rank's tensor-parallel net, and only it")
        self.net = net
        self.cfg = alg_cfg
        # a dp group of one rank (mp alone) has nothing to average
        self.dp = dp if dp is not None and dp.world > 1 else None
        self.update_dtype = compute_dtype_of(getattr(alg_cfg, "update_dtype", "float32"))
        self.remat_update = bool(getattr(alg_cfg, "remat_update", False))
        self.fused_trunk = bool(getattr(alg_cfg, "fused_trunk", False))
        # under mp: the flat entries of the split leaves and of the replicated
        # ones, as index vectors on the net's device (gathered with no host read)
        self._split = None
        if self.mp is not None:
            split = net.split_mask()
            self._split = (torch.nonzero(split).flatten(), torch.nonzero(~split).flatten())
        self.extra_loss_fn = extra_loss_fn
        self.perm_groups = int(perm_groups)
        self.local_groups = self.perm_groups if self.gathered else self.perm_groups // world
        self.std_floor = 0.0 if net.fixed_std else float(net.noise_std_floor)
        self.shuffle_block = int(shuffle_block)
        self.gamma = float(alg_cfg.gamma)
        self.lam = float(alg_cfg.lam)
        self.clip_param = float(alg_cfg.clip_param)
        self.value_loss_coef = float(alg_cfg.value_loss_coef)
        self.entropy_coef = float(alg_cfg.entropy_coef)
        self.num_learning_epochs = int(alg_cfg.num_learning_epochs)
        self.num_mini_batches = int(alg_cfg.num_mini_batches)
        self.desired_kl = float(alg_cfg.desired_kl)
        self.adaptive = alg_cfg.schedule == "adaptive"
        self.lr_init = float(alg_cfg.learning_rate)
        self.lr_min = float(alg_cfg.learning_rate_min)
        self.lr_max = float(alg_cfg.learning_rate_max)
        self.max_grad_norm = float(alg_cfg.max_grad_norm)
        self.use_clipped_value_loss = bool(alg_cfg.use_clipped_value_loss)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        sd = str(getattr(alg_cfg, "storage_dtype", "bfloat16") or "float32")
        self.storage_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[sd]
        fu = getattr(alg_cfg, "fused_update", "auto")
        if fu == "auto" or fu:
            fu = FusedPPOGrad.supported(net, extra_loss_fn)
        # K2 per shard with the gradient mean between it and Adam (gathered:
        # the one-process rule on the global batch)
        dp_kernel = world > 1 and self.perm_groups == world and not self.gathered
        # under mp the xla update (ppo.py:153; runner.py:112 turns the flat
        # optimizer, and with it the kernels, off)
        self.fused_update = bool(fu) and (self.perm_groups == 1 or dp_kernel) and self.mp is None
        self.fused_mega = bool(getattr(alg_cfg, "fused_mega", True)) and not dp_kernel
        self.fused_update_tile = int(getattr(alg_cfg, "fused_update_tile", 512) or 512)
        self._fused_cache: Dict[int, FusedPPOGrad] = {}

    @property
    def path(self) -> str:
        if not self.fused_update:
            return "xla"
        return "mega" if self.fused_mega else "step"

    def init(self, params: torch.Tensor) -> PPOState:
        z = torch.zeros_like(params)
        return PPOState(params=params, m=z, v=z.clone(),
                        count=torch.zeros((), dtype=torch.int32, device=params.device),
                        learning_rate=torch.tensor(self.lr_init, dtype=torch.float32,
                                                   device=params.device))

    # ------------------------------------------------------------------

    def compute_returns(self, batch, last_values):
        """GAE (ppo.py:207). ``batch`` leaves are (T, N, ...). A reverse loop
        over T (the JAX package evaluates the same recurrence as a parallel
        prefix scan). Returns (returns, normalized advantages), each (T, N)."""
        not_terminal = 1.0 - batch.dones.to(torch.float32)
        next_values = torch.cat([batch.values[1:], last_values[None]], dim=0)
        delta = batch.rewards + not_terminal * self.gamma * next_values - batch.values
        coeff = not_terminal * (self.gamma * self.lam)
        adv_raw = torch.empty_like(delta)
        acc = torch.zeros_like(delta[0])
        for t in range(delta.shape[0] - 1, -1, -1):
            acc = delta[t] + coeff[t] * acc
            adv_raw[t] = acc
        returns = adv_raw + batch.values
        if self.dp is None:
            # jnp.std is the population std: correction=0, not torch's default 1
            adv = (adv_raw - adv_raw.mean()) / (adv_raw.std(correction=0) + 1e-8)
            return returns, adv
        # over the global (T, N) batch (ppo.py:232), in two passes as jnp's
        # mean and std: the mean, then the squared deviations from it
        total = float(adv_raw.numel() * self.dp.world)
        mean = self.dp.all_reduce_sum(adv_raw.sum().reshape(1))[0] / total
        sq = self.dp.all_reduce_sum(torch.square(adv_raw - mean).sum().reshape(1))[0]
        adv = (adv_raw - mean) / (torch.sqrt(sq / total) + 1e-8)
        return returns, adv

    # ------------------------------------------------------------------

    def _minibatch_loss(self, flat, mb):
        """The loss of ``ppo.py:_minibatch_loss`` as a function of the flat
        params, for torch.autograd: the MLPs in ``update_dtype``, as one
        stacked trunk with ``fused_trunk``. ``torch.maximum``/``minimum``
        give 0.5 at ties as ``jnp.maximum``/``clip`` do; a ``torch.clamp``
        would give 1 at the boundary."""
        net, dt = self.net, self.update_dtype
        obs, cobs = mb["obs"].to(torch.float32), mb["critic_obs"].to(torch.float32)
        if self.fused_trunk:
            mean, value = net.joint_mean_value(obs, cobs, dtype=dt, flat=flat)
        else:
            mean = net.action_mean(obs, flat=flat, dtype=dt)
            value = net.evaluate(cobs, dtype=dt, flat=flat)
        loss, aux = self._ppo_loss(net.leaves(flat)[2], mean, value, mb)
        return self._with_extra_loss(flat, mb, loss), aux

    def _ppo_loss(self, std_p, mean, value, mb):
        """The clipped PPO objective of the policy's ``mean`` and ``value``
        over a minibatch (any leading shape), with the std leaf ``std_p``
        (the floor as ``networks.py:148-153``'s max: gradient 0.5 at a tie).
        Returns (loss, aux)."""
        net = self.net
        if net.fixed_std:
            std1 = torch.full_like(std_p, net.init_noise_std)
        elif self.std_floor > 0.0:
            std1 = _jmax(std_p, self.std_floor)
        else:
            std1 = std_p
        std = std1.expand_as(mean)
        logp = net.log_prob(mean, std, mb["actions"])
        entropy = net.entropy(std)

        old_mu, old_sigma = mb["mu"], mb["sigma"]
        kl = torch.sum(
            torch.log(std / old_sigma + 1e-5)
            + (torch.square(old_sigma) + torch.square(old_mu - mean)) / (2.0 * torch.square(std))
            - 0.5,
            dim=-1,
        )
        kl_mean = torch.mean(kl).detach()

        ratio = torch.exp(logp - mb["log_prob"])
        adv = mb["advantages"]
        surrogate = -adv * ratio
        surrogate_clipped = -adv * _jclip(ratio, 1.0 - self.clip_param, 1.0 + self.clip_param)
        surrogate_loss = torch.mean(torch.maximum(surrogate, surrogate_clipped))

        if self.use_clipped_value_loss:
            value_clipped = mb["values"] + _jclip(value - mb["values"], -self.clip_param,
                                                  self.clip_param)
            value_loss = torch.mean(torch.maximum(torch.square(value - mb["returns"]),
                                                  torch.square(value_clipped - mb["returns"])))
        else:
            value_loss = torch.mean(torch.square(mb["returns"] - value))

        loss = (surrogate_loss + self.value_loss_coef * value_loss
                - self.entropy_coef * torch.mean(entropy))
        aux = {"value_loss": value_loss.detach(), "surrogate_loss": surrogate_loss.detach(),
               "kl": kl_mean}
        return loss, aux

    def _with_extra_loss(self, flat, mb, loss):
        """``loss`` plus the extra loss term (ppo.py:286-287, :767-768)."""
        if self.extra_loss_fn is None:
            return loss
        return loss + self.extra_loss_fn(flat, mb)

    def _adapt_lr(self, lr, kl_mean):
        """ppo.py:291 (rsl_rl ppo.py:207-213), on device scalars."""
        if not self.adaptive:
            return lr
        lr_down = _jmax(lr / 1.5, self.lr_min)
        lr_up = torch.minimum(lr * 1.5, scalar(self.lr_max, torch.float32, lr.device))
        return torch.where(
            kl_mean > self.desired_kl * 2.0, lr_down,
            torch.where((kl_mean < self.desired_kl / 2.0) & (kl_mean > 0.0), lr_up, lr),
        )

    def _project_std(self, flat):
        """ppo.py:650: the learnable std projected to its floor after each
        optimizer step (in place on ``flat``, a fresh tensor of this step)."""
        if self.std_floor > 0.0:
            off = self.net.layout[-1][1]
            flat[off:] = _jmax(flat[off:], self.std_floor)
        return flat

    def _optax_step(self, p, m, v, count, lr, g):
        """optax.clip_by_global_norm(max) + optax.adam(lr, 0.9, 0.999, 1e-8)
        on one flat vector, formula for formula. Under mp ``g`` is this
        rank's shard: the global norm adds the split entries' squares over
        the mp group to the replicated entries' (counted once)."""
        if self.mp is None:
            gnorm = torch.sqrt(torch.sum(g * g))
        else:
            split, replicated = self._split
            sq = self.mp.all_reduce_sum(torch.sum(torch.square(g.index_select(0, split))).reshape(1))[0]
            gnorm = torch.sqrt(sq + torch.sum(torch.square(g.index_select(0, replicated))))
        g = torch.where(gnorm < self.max_grad_norm, g, (g / gnorm) * self.max_grad_norm)
        count = torch.where(count < _INT32_MAX, count + 1, count)
        m = (1 - self.b1) * g + self.b1 * m
        v = (1 - self.b2) * (g * g) + self.b2 * v
        c = count.to(torch.float32)
        mu_hat = m / (1 - torch.pow(scalar(self.b1, torch.float32, c.device), c))
        nu_hat = v / (1 - torch.pow(scalar(self.b2, torch.float32, c.device), c))
        upd = mu_hat / (torch.sqrt(nu_hat + 0.0) + self.eps)
        return p + upd * (-lr), m, v, count

    # ------------------------------------------------------------------

    def shuffle_geometry(self, t: int, n: int) -> Tuple[int, int, int, int]:
        """(block, n_blocks, used blocks, rows per minibatch) of one group's
        block shuffle (ppo.py:322-332), for ``n`` envs a group:
        ``shuffle_block`` consecutive envs at one timestep, cut to a divisor
        of ``n`` that leaves every minibatch a block; the ``n_blocks - used``
        leftover blocks are dropped."""
        b = max(1, min(self.shuffle_block, n))
        while b > 1 and ((n % b) or (t * (n // b)) < self.num_mini_batches):
            b -= 1
        n_blocks = t * (n // b)
        mb_blocks = n_blocks // self.num_mini_batches
        if mb_blocks == 0:
            raise ValueError(f"{n_blocks} sample blocks cannot fill {self.num_mini_batches} minibatches")
        return b, n_blocks, mb_blocks * self.num_mini_batches, mb_blocks * b

    def _groups(self, n: int) -> Tuple[int, int]:
        """(groups, envs a group) of a batch of ``n`` envs on this rank."""
        g = self.local_groups
        if n % g:
            raise ValueError(f"num_envs {n} not divisible by the {g} permutation groups of this rank's update")
        return g, n // g

    def _pack_shuffle(self, batch, returns, advantages, perm):
        """Pack the nine rollout fields into the update's two buffers,
        shuffled once by the block permutation ``perm`` (ppo.py:303): the
        matmul inputs ``(MB, rows, O+P)`` in ``storage_dtype`` and the
        ratio/KL-critical scalars ``(MB, rows, 3A+4)`` in f32, in the lane
        order actions | log_prob | mu | sigma | values | returns | advantages.
        With G groups the one permutation of a group's blocks is applied to
        every group, and minibatch i holds each group's i-th slice, group by
        group: ``rows`` = G x the rows a group gives (ppo.py:361-383)."""
        t, n = batch.rewards.shape
        g, npg = self._groups(n)
        b, n_blocks, used, rows = self.shuffle_geometry(t, npg)
        perm = _long_on(perm, batch.rewards.device)
        if perm.shape != (used,):
            raise ValueError(f"perm must hold {used} block indices, got {tuple(perm.shape)}")
        col = lambda x: x[..., None]
        wide = torch.cat([batch.obs.to(self.storage_dtype),
                          batch.critic_obs.to(self.storage_dtype)], dim=-1)
        f32 = torch.cat([batch.actions, col(batch.log_prob), batch.mu, batch.sigma,
                         col(batch.values), col(returns), col(advantages)],
                        dim=-1).to(torch.float32)

        mb = self.num_mini_batches

        def shuffle(x):   # (T, N, F) -> (G, blocks, B, F), gathered -> (MB, G x rows, F)
            f = x.shape[-1]
            x = x.reshape(t, g, npg // b, b, f).transpose(0, 1).reshape(g, n_blocks, b, f)[:, perm]
            return x.reshape(g, mb, rows, f).transpose(0, 1).reshape(mb, g * rows, f)

        return shuffle(wide), shuffle(f32), g * rows

    def perm_size(self, t: int, n: int, recurrent: bool = False) -> Tuple[int, int]:
        """(n, used) of the update's permutation ``randperm(n)[:used]`` for
        a rank of ``n`` envs and ``t`` steps: a group's blocks
        (:meth:`shuffle_geometry`), or with ``recurrent`` a group's env
        columns (:meth:`recurrent_geometry`), of the global batch under the
        global shuffle."""
        per_group = self._groups(n * self.dp.world if self.gathered else n)[1]
        if recurrent:
            return per_group, self.recurrent_geometry(per_group)[1]
        _, n_blocks, used, _ = self.shuffle_geometry(t, per_group)
        return n_blocks, used

    def draw_perm(self, t: int, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """One block permutation per update (base_storage.py:169) of a
        group's blocks, cut to the used blocks: ``randperm(n_blocks)[:used]``
        (``n``: the envs the update shuffles)."""
        _, n_blocks, used, _ = self.shuffle_geometry(t, self._groups(n)[1])
        return torch.randperm(n_blocks, generator=generator, device=device)[:used]

    def _gather(self, batch, returns, advantages, hidden0=None):
        """The global shuffle's inputs: ``batch`` (the nine fields),
        ``returns``, ``advantages`` and ``hidden0`` (a ``recurrent.Hidden``,
        or None) of every dp rank in global env order, in one all-gather
        (``sharding.gather_envs``); as given where the update is not
        gathered."""
        if not self.gathered:
            return batch, returns, advantages, hidden0
        out = sharding.gather_envs(self.dp, [*batch, returns, advantages, *(hidden0 or ())])
        k = len(batch)
        return (type(batch)(*out[:k]), out[k], out[k + 1],
                None if hidden0 is None else type(hidden0)(*out[k + 2:]))

    def _shared_perm(self, perm, generator, draw, device) -> torch.Tensor:
        """The update's permutation: ``perm`` if given, else ``draw(generator)``;
        with ``dp``, rank 0's on every rank (one broadcast)."""
        if perm is None:
            if generator is None:
                raise ValueError("the update needs a generator or a permutation")
            perm = draw(generator)
        perm = _long_on(perm, device)
        if self.dp is not None:
            perm = self.dp.broadcast(perm.contiguous())
        return perm

    def prepare_update(self, batch, returns, advantages, generator: Optional[torch.Generator] = None,
                       perm=None):
        """The update's inputs: the block permutation (``perm``, or drawn
        from ``generator``) and the packed, shuffled buffers. Returns
        ``(shuf_w, shuf_f, rows)`` (:meth:`_pack_shuffle`), of the global
        batch under the global shuffle (gathered first)."""
        batch, returns, advantages, _ = self._gather(batch, returns, advantages)
        t, n = batch.rewards.shape
        dev = batch.rewards.device
        perm = self._shared_perm(perm, generator, lambda gen: self.draw_perm(t, n, gen, dev), dev)
        return self._pack_shuffle(batch, returns, advantages, perm)

    def update(self, ppo_state: PPOState, batch, returns, advantages,
               generator: Optional[torch.Generator] = None, perm=None):
        """Epochs x minibatches over the block-shuffled batch (ppo.py:400).

        ``perm``: optional block permutation (``used`` indices), instead of
        drawing one from ``generator``. Returns (new PPOState, metric means:
        value_loss, surrogate_loss, kl, lr); the inputs are not modified."""
        shuf_w, shuf_f, rows = self.prepare_update(batch, returns, advantages, generator, perm)
        obs_dim = batch.obs.shape[-1]
        if self.fused_update:
            fused = self._get_fused(rows)
            bufs = fused.split_buffers(shuf_w, shuf_f, obs_dim)
            if self.fused_mega:
                s = ppo_state
                p2, m2, v2, lr, metrics = fused.update_scan(s.params, s.m, s.v, s.count,
                                                            s.learning_rate, bufs)
                steps = self.num_learning_epochs * self.num_mini_batches
                return PPOState(params=p2, m=m2, v=v2, count=s.count + steps,
                                learning_rate=lr), metrics
            # K2's context made once an update; each step's params copied into it
            ctx = fused.step_context(ppo_state.params.clone(memory_format=torch.contiguous_format), bufs)
            return self._run_epochs(ppo_state, lambda p, i: ctx.grads(i, p))

        a = batch.actions.shape[-1]
        return self._run_epochs(
            ppo_state, lambda p, i: self.loss_and_grad(p, self.minibatch(shuf_w, shuf_f, obs_dim, a, i)))

    @staticmethod
    def minibatch(shuf_w, shuf_f, obs_dim: int, a: int, i: int):
        """Minibatch ``i`` of the packed shuffle buffers (:meth:`_pack_shuffle`)
        as the xla loss's dict of fields (``a``: the action width)."""
        fs = shuf_f[i]
        return {"obs": shuf_w[i, :, :obs_dim], "critic_obs": shuf_w[i, :, obs_dim:],
                "actions": fs[:, :a], "log_prob": fs[:, a], "mu": fs[:, a + 1:2 * a + 1],
                "sigma": fs[:, 2 * a + 1:3 * a + 1], "values": fs[:, 3 * a + 1],
                "returns": fs[:, 3 * a + 2], "advantages": fs[:, 3 * a + 3]}

    def loss_and_grad(self, p, mb):
        """The xla path's (loss, flat gradient, aux) of minibatch ``mb`` at
        ``p``; with ``remat_update`` the loss runs under
        ``torch.utils.checkpoint`` (``ppo.py:458-461``)."""
        with torch.enable_grad():
            pr = p.detach().requires_grad_(True)
            if self.remat_update:
                # the loss draws no random numbers: no RNG state to keep (reading
                # the CUDA RNG state is refused inside a CUDA graph's capture)
                loss, aux = torch.utils.checkpoint.checkpoint(self._minibatch_loss, pr, mb,
                                                              use_reentrant=False, preserve_rng_state=False)
            else:
                loss, aux = self._minibatch_loss(pr, mb)
            (g,) = torch.autograd.grad(loss, pr)
        return loss.detach(), g, aux

    # ------------------------------------------------------------------
    # the recurrent update (whole-trajectory minibatches, learn/recurrent.py)
    # ------------------------------------------------------------------

    def _minibatch_loss_recurrent(self, flat, mb):
        """``ppo.py:_minibatch_loss_recurrent``: the same clipped objective,
        the policy and value an LSTM replay over the minibatch's (T, M)
        sequence with the memory zeroed at done boundaries."""
        net = self.net
        mean, value = net.joint_mean_value_seq(mb["obs"], mb["critic_obs"], mb["done_prev"],
                                               mb["hidden0"], flat=flat)
        loss, aux = self._ppo_loss(net.leaves(flat)[2], mean, value, mb)
        return self._with_extra_loss(flat, mb, loss), aux

    def recurrent_geometry(self, n: int) -> Tuple[int, int]:
        """(envs a minibatch, envs used) of one group of ``n`` envs: whole
        env columns, the leftover ``n - used`` envs dropped
        (ppo.py:781-783)."""
        mb_envs = max(n // self.num_mini_batches, 1)
        return mb_envs, mb_envs * self.num_mini_batches

    def update_recurrent(self, ppo_state: PPOState, batch, returns, advantages, hidden0,
                         generator: Optional[torch.Generator] = None, perm=None):
        """Epochs x minibatches of whole env columns (= whole trajectories,
        ppo.py:772): one permutation of a group's envs,
        ``randperm(n / G)[:used]`` (or ``perm``), cut into ``num_mini_batches``
        rows, applied to every group and reused in every epoch; each grad
        step differentiates the LSTM replay from the rollout's start memory
        ``hidden0`` (a ``recurrent.Hidden``) with autograd. Returns (new
        PPOState, metric means) as :meth:`update`. ``FusedPPOGrad`` is not
        consulted: the kernels cover the MLP only."""
        minibatch = self.recurrent_minibatches(batch, returns, advantages, hidden0,
                                               generator=generator, perm=perm)
        return self._run_epochs(ppo_state, lambda p, i: self.recurrent_grad(p, minibatch(i)))

    def recurrent_grad(self, p, mb):
        """The recurrent update's (loss, flat gradient, aux) of minibatch
        ``mb`` at ``p`` (autograd over the LSTM replay)."""
        with torch.enable_grad():
            pr = p.detach().requires_grad_(True)
            loss, aux = self._minibatch_loss_recurrent(pr, mb)
            (g,) = torch.autograd.grad(loss, pr)
        return loss.detach(), g, aux

    def recurrent_inputs(self, batch, returns, advantages, hidden0,
                         generator: Optional[torch.Generator] = None, perm=None):
        """What the recurrent update's minibatches are gathered from, made
        once an update: the (T, N, ...) fields (obs and critic obs in f32,
        ``done_prev``: each env's done after the step before), the env
        columns of every minibatch, ``(MB, G x M)``, M a minibatch's columns
        of a group, group by group (ppo.py:789-824), and the start memories
        ``hidden0``; under the global shuffle all of the global batch
        (gathered first). Returns (data, cols, hidden0)."""
        batch, returns, advantages, hidden0 = self._gather(batch, returns, advantages, hidden0)
        t, n = batch.rewards.shape
        g, per_group = self._groups(n)
        mb_envs, used = self.recurrent_geometry(per_group)
        dev = batch.rewards.device
        perm = self._shared_perm(
            perm, generator, lambda gen: torch.randperm(per_group, generator=gen, device=dev)[:used], dev)
        if perm.shape != (used,):
            raise ValueError(f"perm must hold {used} env indices, got {tuple(perm.shape)}")
        # minibatch i: the same env columns of every group, group by group
        starts = torch.arange(g, device=dev)[:, None] * per_group
        cols = (starts[None] + perm.reshape(self.num_mini_batches, 1, mb_envs)).reshape(
            self.num_mini_batches, g * mb_envs)
        done_prev = torch.cat([torch.zeros((1, n), device=dev),
                               batch.dones[:-1].to(torch.float32)], dim=0)
        data = {"obs": batch.obs.to(torch.float32), "critic_obs": batch.critic_obs.to(torch.float32),
                "actions": batch.actions, "log_prob": batch.log_prob, "mu": batch.mu,
                "sigma": batch.sigma, "values": batch.values, "returns": returns,
                "advantages": advantages, "done_prev": done_prev}
        return data, cols, hidden0

    @staticmethod
    def recurrent_minibatch(data, cols, hidden0, i):
        """Minibatch ``i`` of :meth:`recurrent_inputs`: its dict of (T, M,
        ...) fields and ``hidden0``, the start memory of its columns. ``i``:
        a host int, or a one-element int64 tensor on the device (a CUDA
        graph's step index: row ``i`` gathered on the device, nothing read
        back)."""
        idx = cols[i] if isinstance(i, int) else cols.index_select(0, i.reshape(1))[0]
        mb = {k: v.index_select(1, idx) for k, v in data.items()}
        mb["hidden0"] = hidden0.select(idx)
        return mb

    def recurrent_minibatches(self, batch, returns, advantages, hidden0,
                              generator: Optional[torch.Generator] = None, perm=None):
        """The recurrent update's minibatches: a function of the minibatch
        index ``i`` to :meth:`recurrent_minibatch` over
        :meth:`recurrent_inputs`."""
        data, cols, hidden0 = self.recurrent_inputs(batch, returns, advantages, hidden0,
                                                    generator=generator, perm=perm)
        return lambda i: self.recurrent_minibatch(data, cols, hidden0, i)

    def _get_fused(self, rows: int) -> FusedPPOGrad:
        if rows not in self._fused_cache:
            # f32 operands only when the whole update is pinned f32 (the exact
            # check), else bf16 (ppo.py:468-474, less its TPU clause)
            op = (torch.float32 if self.storage_dtype == torch.float32 and self.update_dtype is None
                  else torch.bfloat16)
            self._fused_cache[rows] = FusedPPOGrad(
                self.net, clip_param=self.clip_param, value_loss_coef=self.value_loss_coef,
                entropy_coef=self.entropy_coef, use_clipped_value_loss=self.use_clipped_value_loss,
                rows=rows, num_mini_batches=self.num_mini_batches,
                num_epochs=self.num_learning_epochs, tile=self.fused_update_tile, op_dtype=op,
                max_grad_norm=self.max_grad_norm, adaptive_lr=self.adaptive,
                desired_kl=self.desired_kl, lr_min=self.lr_min, lr_max=self.lr_max,
            )
        return self._fused_cache[rows]

    def _run_epochs(self, ppo_state: PPOState, grad_fn, steps: Optional[int] = None):
        """The per-grad-step loop of the step, xla and recurrent paths
        (ppo.py:600, :664): :meth:`grad_step` for minibatch ``s % MB`` of
        each step. ``grad_fn(p, i)`` -> (loss, flat gradient, aux) for
        minibatch ``i``. ``steps``: stop after that many grad steps (a check
        of the first steps of an update); default all."""
        p, m, v = ppo_state.params, ppo_state.m, ppo_state.v
        count, lr = ppo_state.count, ppo_state.learning_rate
        hist = []
        total = self.num_learning_epochs * self.num_mini_batches
        for s in range(total if steps is None else min(int(steps), total)):
            p, m, v, count, lr, row = self.grad_step(p, m, v, count, lr, grad_fn, s % self.num_mini_batches)
            hist.append(row)
        means = torch.stack(hist).mean(dim=0)
        metrics = {"value_loss": means[0], "surrogate_loss": means[1], "kl": means[2], "lr": lr}
        return PPOState(params=p, m=m, v=v, count=count, learning_rate=lr), metrics

    def grad_step(self, p, m, v, count, lr, grad_fn, i):
        """One grad step on minibatch ``i``: the gradient, with ``dp`` its
        all-reduced mean (:meth:`reduce`), the adaptive-KL LR from this
        minibatch's KL, the NaN-loss skip, clip + Adam, the std projection.
        Returns (p, m, v, count, lr, this step's (value loss, surrogate
        loss, KL)); the inputs are not modified. The eager loop
        (:meth:`_run_epochs`) and the compiled iteration's update graphs
        (``learn/graphs.py``) run this same body."""
        loss, g, aux = self.reduce(*grad_fn(p, i))
        lr = self._adapt_lr(lr, aux["kl"])
        g = torch.where(torch.isfinite(loss), g, torch.zeros_like(g))   # NaN-loss skip
        p, m, v, count = self._optax_step(p, m, v, count, lr, g)
        p = self._project_std(p)
        return p, m, v, count, lr, torch.stack([aux["value_loss"], aux["surrogate_loss"], aux["kl"]])

    def reduce(self, loss, g, aux):
        """One grad step's (loss, flat gradient, aux) as the mean over the
        ranks, in one all-reduce (the pmean of ppo.py:617; every rank holds as
        many rows, so it is the global minibatch's mean); unchanged without
        ``dp`` and under the global shuffle (every rank's is the global
        minibatch's already)."""
        if self.dp is None or self.gathered:
            return loss, g, aux
        keys = ("value_loss", "surrogate_loss", "kl")
        buf = torch.cat([g.reshape(-1), torch.stack([loss.detach(), *(aux[k] for k in keys)]).to(g.dtype)])
        buf = self.dp.all_reduce_sum(buf) / self.dp.world
        n = g.numel()
        return buf[n], buf[:n].reshape(g.shape), dict(zip(keys, buf[n + 1:]))
