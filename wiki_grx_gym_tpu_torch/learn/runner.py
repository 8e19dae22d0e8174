"""On-policy runner (port of ``wiki_grx_gym_tpu/learn/runner.py``).

One training iteration (:meth:`OnPolicyRunner.iteration`, the counterpart of
the JAX ``_iteration``) is: the rollout (a Python loop over T steps filling
a preallocated ``Transition`` buffer and the per-env accumulators), the last
values, GAE, the PPO update (``learn/ppo.py``; K3 on the default path) and
the metrics dict with the JAX package's keys. :meth:`OnPolicyRunner._train_iter`
is the same iteration compiled, the counterpart of JAX's
``jax.jit(self._iteration, donate_argnums=(0,))``: CUDA graph replays over
static, donated buffers (``learn/graphs.py``): the collection, then the
update, one graph on the mega path (K3's), the step path (K2 a grad step)
and the xla path (autograd of the loss, with an extra loss term such as
the symmetry loss, ``remat_update`` or the bf16 update dtype), and one
grad step's graph replayed epochs x minibatches times on the recurrent
path. On K1 the collection is one graph; on the engine (a step is ~26k
kernels) one rollout step's graph replayed T times, then a graph of the
collection's tail. The rule for which configs take it is static
(:attr:`OnPolicyRunner.eager_reason`): a CUDA device, K1 or the engine as
the physics backend, and data or tensor parallelism only over NCCL, whose
collectives the graphs capture (across ranks, the collections and updates
runs on several cards have held: ``parallel/mesh.COMPILED_COLLECTIONS``,
``COMPILED_UPDATES``).
Every other config (the CPU, the lane backend, dp and mp over gloo, the
runs across ranks outside that set) runs ``iteration``, eagerly.
``learn`` runs iterations,
logs the reference's scalars and writes ``model_<it>.pt`` checkpoints into
the reference's run-dir layout; ``load`` restores one exactly.

The recurrent policy (``policy_class_name`` ActorCriticRecurrent or a
``policy.rnn_type``, as the GR1T1_lstm task sets it) runs the same
iteration with the LSTM net (``learn/recurrent.py``): the rollout steps both
memories each env step and zeroes the memory of reset envs after it, the
update replays whole env columns from the memory at the rollout's start
(``PPO.update_recurrent``), and the inference policy is stateful.

``algorithm.symmetry_coef > 0`` adds the mirror-symmetry loss
(``learn/symmetry.py``) to PPO's objective through its ``extra_loss_fn``.

**Data parallel** (``dp``, a ``parallel.mesh.DataParallel``): the env is
this rank's shard of the envs (``parallel.sharding.shard_bounds``), its
generators are seeded from ``(seed, rank)``, the learner state is broadcast
from rank 0 at init and after a load and is checked bit-identical on every
rank after every update (eagerly, between the compiled iteration's
replays too), the iteration's metric sums are all-reduced once
(:meth:`OnPolicyRunner.global_sums`), and only rank 0 writes TensorBoard events and checkpoints (JAX
``runner.py:326-356``). ``permutation_groups = 0`` resolves to the group's
size, as JAX's does to the dp mesh size (``runner.py:99-108``); a count
the group's size does not divide (1: JAX's CLI run, which sets the mesh
after the runner) takes the global shuffle (``learn/ppo.py``).
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from collections import deque
from typing import Dict, NamedTuple, Optional

import torch

from wiki_grx_gym_tpu_torch.device import resolve_device
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO, PPOState
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent, Hidden
from wiki_grx_gym_tpu_torch.parallel import sharding


# the compiled iteration's spans and launch time (learn/spans.py, CompiledIteration):
# (last_timing key, TensorBoard tag under Perf/)
PERF_SPANS = (("entry_s", "collection_entry_time"), ("actor_s", "collection_actor_time"),
              ("env_s", "collection_env_time"), ("k1_s", "collection_k1_time"),
              ("gae_s", "collection_gae_time"), ("stage_s", "collection_stage_time"),
              ("launch_s", "graph_launch_time"))


class Transition(NamedTuple):
    """Rollout storage, (T, N, ...) per field."""

    obs: torch.Tensor
    critic_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_prob: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


@dataclasses.dataclass
class RunnerState:
    env_state: object          # EnvState
    obs: torch.Tensor          # (N, O)
    critic_obs: torch.Tensor   # (N, OP)
    rng: torch.Generator       # action-noise and shuffle generator
    ppo: Optional[PPOState] = None
    hidden: Optional[Hidden] = None   # the LSTM memory (recurrent policy)

    def replace(self, **kw) -> "RunnerState":
        return dataclasses.replace(self, **kw)


class OnPolicyRunner:
    spans = None   # the collection graph's marks while it is captured (learn/spans.py), else None

    def __init__(self, env, train_cfg, device="cuda", log_dir: Optional[str] = None, dp=None):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, runner asked for {self.device}")
        self.dp = dp
        self.mp = None if dp is None else dp.mp
        if dp is not None:
            if dp.device != self.device:
                raise ValueError(f"rank {dp.rank} runs on {dp.device}, the runner on {self.device}")
            want = sharding.shard_bounds(env.num_envs_global, dp.world, dp.rank)
            if env.shard != want:
                raise ValueError(f"rank {dp.rank} of {dp.world} must hold envs {want}, its env holds "
                                 f"{env.shard}")
        self.env = env
        self.cfg = train_cfg.runner
        self.alg_cfg = train_cfg.algorithm
        self.policy_cfg = train_cfg.policy
        self.log_dir = log_dir
        self.num_steps_per_env = int(self.cfg.num_steps_per_env)
        self.save_interval = int(self.cfg.save_interval)
        self.seed = int(getattr(train_cfg, "seed", 1))

        pcn = str(getattr(self.cfg, "policy_class_name", "ActorCritic"))
        if pcn not in ("ActorCritic", "ActorCriticMLP", "ActorCriticRecurrent"):
            raise ValueError(f"unknown policy_class_name {pcn!r}")
        acn = str(getattr(self.alg_cfg, "algorithm_class_name", "PPO"))
        if acn != "PPO":
            raise ValueError(f"unknown algorithm_class_name {acn!r}")
        scn = str(getattr(self.alg_cfg, "storage_class", "RolloutStorage"))
        if scn != "RolloutStorage":
            raise ValueError(f"unknown storage_class {scn!r}")
        # rnn_type also selects the recurrent net (runner.py:70-80)
        self.recurrent = pcn == "ActorCriticRecurrent" or bool(getattr(self.policy_cfg, "rnn_type", None))
        num_pri_obs = env.pri_obs_dim if env.cfg.env.num_pri_obs else env.obs_dim
        self.gamma = float(self.alg_cfg.gamma)
        self.fused_trunk = bool(getattr(self.alg_cfg, "fused_trunk", False))
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        net_cls = ActorCriticRecurrent if self.recurrent else ActorCritic
        self.net = net_cls(
            env.obs_dim, num_pri_obs, env.num_actions, self.policy_cfg, mp=self.mp,
        ).to(self.device)
        self.net.reset_parameters(g)
        # the mirror-symmetry loss through PPO's extra_loss_fn (runner.py:87-98)
        extra_loss_fn = None
        symmetry_coef = float(getattr(self.alg_cfg, "symmetry_coef", 0.0))
        if symmetry_coef > 0.0:
            from wiki_grx_gym_tpu_torch.learn.symmetry import make_mirror_loss, make_mirror_loss_recurrent

            make = make_mirror_loss_recurrent if self.recurrent else make_mirror_loss
            extra_loss_fn = make(env, self.net, symmetry_coef)
        # 0 = auto: the run's rank count
        pg = int(getattr(self.alg_cfg, "permutation_groups", 0) or 0) or (1 if dp is None else dp.world)
        self.alg = PPO(self.net, self.alg_cfg, extra_loss_fn=extra_loss_fn, perm_groups=pg,
                       shuffle_block=int(getattr(self.alg_cfg, "shuffle_block", 16) or 16), dp=dp)
        if not getattr(env, "reward_names", ("_",)):
            print("WARNING: env has ZERO active reward terms (all scales are 0) "
                  "— training will not learn anything. Check cfg.rewards.scales.", flush=True)

        self.writer = None
        self.current_learning_iteration = 0
        self.lenbuffer = deque(maxlen=100)
        self.last_timing: Dict[str, float] = {}
        self.log_history = []   # per iteration: its index, time, fps, timing and metrics
        self.replica_digests = []   # with dp, per iteration: every rank's learner-state digest
        self._loaded_state: Optional[RunnerState] = None   # set by load()
        self.compiled = None   # _train_iter's graphs and static state (graphs.CompiledIteration)

    @property
    def is_lead(self) -> bool:
        """Whether this process writes logs and checkpoints (rank 0)."""
        return self.dp is None or self.dp.is_lead

    @property
    def _saves(self) -> bool:
        """Whether this rank calls :meth:`save` in ``learn``: the lead, and
        under mp every peer (the save gathers over the mp group)."""
        return self.log_dir is not None and (self.is_lead or self.mp is not None)

    @property
    def rank_seed(self) -> int:
        return self.seed if self.dp is None else sharding.rank_seed(self.seed, self.dp.rank)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def eager_reason(self) -> Optional[str]:
        """None where the iteration is compiled (:meth:`_train_iter`),
        else why it runs eagerly. The rule is static: a CUDA device, K1 or
        the engine as the physics backend, and under data or tensor
        parallelism process groups whose collectives a CUDA graph captures
        (NCCL's), across ranks the collections and updates runs on several
        cards have held (``DataParallel.eager_reason`` over the policy net
        and :attr:`rule_path`); in one process every update path (mega, step,
        xla, recurrent; an extra loss term) is compiled.
        The lane program (K1's plain version, ~157k single-op launches a
        policy step on the card) stays eager, and so do groups over gloo,
        whose collectives run on the host."""
        if self.device.type != "cuda":
            return f"device {self.device} (CUDA graphs need a CUDA device)"
        if self.env.backend == "lanes":
            return "the physics backend is 'lanes' (K1's plain version), not K1 or the engine"
        if self.dp is not None:
            return self.dp.eager_reason(self.env.backend, "lstm" if self.recurrent else "mlp", self.rule_path)
        return None

    @property
    def rule_path(self) -> str:
        """The update's path as the rule across ranks names it
        (``parallel/mesh.COMPILED_UPDATES``): ``"recurrent"`` or PPO's
        (``"mega"``, ``"step"``, ``"xla"``), with ``"+symmetry"`` where the
        symmetry loss is an extra loss term and ``"+global"`` under the
        global shuffle (``PPO.gathered``)."""
        path = "recurrent" if self.recurrent else self.alg.path
        return (path + ("+symmetry" if self.alg.extra_loss_fn is not None else "")
                + ("+global" if self.alg.gathered else ""))

    # ------------------------------------------------------------------

    def init_state(self, init_at_random_ep_len: bool = False) -> RunnerState:
        """Env init + one zero-action step for the first observations."""
        env = self.env
        g_env = env.make_generator(self.rank_seed)
        g_run = env.make_generator(self.rank_seed + 1)
        env_state = env.init_state(g_env)
        if init_at_random_ep_len:
            env_state = env_state.replace(
                episode_length=torch.randint(
                    0, env.max_episode_length, (env.num_envs,), generator=g_run,
                    device=self.device, dtype=torch.int32,
                )
            )
        zeros = torch.zeros((env.num_envs, env.num_actions), device=self.device)
        env_state, out = env.step(env_state, zeros)
        ppo = self.alg.init(self.net.params_flat)
        if self.dp is not None:
            ppo = sharding.broadcast_ppo_state(self.dp, ppo)
            self.net.bind(ppo.params)
        return RunnerState(env_state=env_state, obs=out.obs, critic_obs=out.pri_obs, rng=g_run, ppo=ppo,
                           hidden=self.net.initial_hidden(env.num_envs) if self.recurrent else None)

    def rollout_buffers(self, state: RunnerState):
        """(Transition of empty (T, N, ...) fields, acc of zero per-env sums)
        for a rollout from ``state``."""
        env = self.env
        n, a, t_len = env.num_envs, env.num_actions, self.num_steps_per_env
        dev = self.device
        e = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
        buf = Transition(
            obs=e(t_len, n, state.obs.shape[1]),
            critic_obs=e(t_len, n, state.critic_obs.shape[1]),
            actions=e(t_len, n, a), rewards=e(t_len, n),
            dones=e(t_len, n, dtype=torch.bool), values=e(t_len, n),
            log_prob=e(t_len, n), mu=e(t_len, n, a), sigma=e(t_len, n, a),
        )
        acc = {
            "rew": torch.zeros(n, device=dev),
            "done": torch.zeros(n, device=dev),
            "ep_sums": torch.zeros((n, len(env.all_reward_names)), device=dev),
            "ep_len_done": torch.zeros(n, device=dev),
        }
        return buf, acc

    @torch.no_grad()
    def rollout_step(self, state: RunnerState, buf: Transition, acc, t, eps=None, u=None) -> RunnerState:
        """One rollout step: act -> ``env.step`` -> store at step ``t`` of
        ``buf`` -> add to ``acc`` (in place); ``t`` is an int (the eager
        loop) or a (1,) int64 index on the device (the engine's per-step
        graph, ``learn/graphs.py``). ``eps``: (N, A) action noise instead of
        a draw from ``state.rng``; ``u``: the step's (N, K) uniform block
        instead of a draw from the env's generator. Returns the state after
        the step (the LSTM memory of reset envs zeroed)."""
        env, net, spans = self.env, self.net, self.spans
        if spans is not None:
            spans("actor")
        obs, critic_obs, hidden = state.obs, state.critic_obs, state.hidden
        if eps is None:
            eps = torch.randn((env.num_envs, env.num_actions), generator=state.rng, device=self.device)
        if self.recurrent:
            # both memories stepped in one dispatch chain
            actions, logp, mu, sigma, values, hidden = net.act_evaluate_rnn(obs, critic_obs, hidden, eps)
        elif self.fused_trunk:
            mu, values = net.joint_mean_value(obs, critic_obs)
            sigma = net.std().expand_as(mu)
            actions = mu + sigma * eps
            logp = net.log_prob(mu, sigma, actions)
        else:
            actions, logp, mu, sigma = net.act(obs, eps)
            values = net.evaluate(critic_obs)
        env_state, out = env.step(state.env_state, actions, u=u)
        if spans is not None:
            spans("actor")
        # timeout bootstrapping
        rewards = out.rew + self.gamma * values * out.extras["time_outs"]
        for field, val in (("obs", obs), ("critic_obs", critic_obs), ("actions", actions),
                           ("rewards", rewards), ("dones", out.reset), ("values", values),
                           ("log_prob", logp), ("mu", mu), ("sigma", sigma)):
            dst = getattr(buf, field)
            if torch.is_tensor(t):
                dst.index_copy_(0, t, val[None])
            else:
                dst[t] = val
        acc["rew"] += out.rew
        acc["done"] += out.reset.to(torch.float32)
        acc["ep_sums"] += out.extras["episode_done_sums"]
        acc["ep_len_done"] += out.extras["ep_len_done"]
        if self.recurrent:
            # the memory of reset envs is zeroed (rsl_rl reset semantics)
            hidden = hidden.masked(1.0 - out.reset.to(torch.float32))
        return state.replace(env_state=env_state, obs=out.obs, critic_obs=out.pri_obs, hidden=hidden)

    @torch.no_grad()
    def rollout(self, state: RunnerState, noise: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None):
        """T = num_steps_per_env steps of :meth:`rollout_step`.

        ``noise``: optional (T, N, A) standard-normal action noise and ``u``:
        optional (T, N, K) per-step uniform blocks, used instead of drawing
        from ``state.rng`` and ``env_state.rng``.

        Returns (new state, Transition with (T, N, ...) fields, acc) where acc
        holds the per-env sums of reward, dones, episode sums at done and
        episode lengths at done."""
        buf, acc = self.rollout_buffers(state)
        for t in range(self.num_steps_per_env):
            state = self.rollout_step(state, buf, acc, t, None if noise is None else noise[t],
                                      None if u is None else u[t])
        return state, buf, acc

    # ------------------------------------------------------------------
    # one training iteration (the JAX _iteration, runner.py:256)
    # ------------------------------------------------------------------

    def _collect(self, state: RunnerState, noise=None, u=None):
        """The iteration up to the update: the rollout, the last values and
        GAE. Returns (rollout state, Transition, acc, last values, returns,
        advantages)."""
        rs, batch, acc = self.rollout(state, noise=noise, u=u)
        last_values, returns, advantages = self._returns(rs, batch)
        return rs, batch, acc, last_values, returns, advantages

    def _returns(self, rs: RunnerState, batch: Transition):
        """The collection's tail after the rollout: (last values, returns,
        advantages) by GAE."""
        net = self.net
        if self.spans is not None:
            self.spans("gae")
        with torch.no_grad():
            if self.recurrent:
                # the critic's memory after the rollout
                last_values, _ = net.evaluate_rnn(rs.critic_obs, rs.hidden)
            else:
                last_values = net.evaluate(rs.critic_obs)
        returns, advantages = self.alg.compute_returns(batch, last_values)
        return last_values, returns, advantages

    def iteration(self, state: RunnerState, noise: Optional[torch.Tensor] = None,
                  u: Optional[torch.Tensor] = None, perm=None, out: Optional[dict] = None):
        """Rollout, last values, GAE, PPO update, eagerly. ``noise``/``u`` as
        for :meth:`rollout`; ``perm``: the update's block permutation instead
        of one drawn from ``state.rng``. Returns (new state, metrics dict of
        0-d tensors with the JAX package's keys); the times of collection and
        update land in ``last_timing``. ``out``: a dict that receives the
        collection's batch, acc, last_values, returns and advantages (for
        checks)."""
        net, alg = self.net, self.alg
        net.bind(state.ppo.params)
        t0 = time.perf_counter()
        rs, batch, acc, last_values, returns, advantages = self._collect(state, noise=noise, u=u)
        if out is not None:
            out.update(batch=batch, acc=acc, last_values=last_values, returns=returns, advantages=advantages)
        self._sync()
        t1 = time.perf_counter()
        if self.recurrent:
            # the replay starts from the memory at the rollout's start
            ppo, update_metrics = alg.update_recurrent(state.ppo, batch, returns, advantages,
                                                       state.hidden, generator=state.rng, perm=perm)
        else:
            ppo, update_metrics = alg.update(state.ppo, batch, returns, advantages,
                                             generator=state.rng, perm=perm)
        net.bind(ppo.params)
        self._sync()
        self.last_timing = {"collection_s": t1 - t0, "update_s": time.perf_counter() - t1}
        sums = self.global_sums(self._collection_sums(rs, acc))
        return rs.replace(ppo=ppo), self._metrics(sums, rs.env_state, update_metrics)

    def _collection_sums(self, rs: RunnerState, acc) -> torch.Tensor:
        """The (4 + R,) sums of the metrics over this rank's envs: reward,
        dones, episode lengths at done, terrain levels, then each reward's
        episode sums at done."""
        return torch.cat([torch.stack([torch.sum(acc["rew"]), torch.sum(acc["done"]),
                                       torch.sum(acc["ep_len_done"]),
                                       torch.sum(rs.env_state.terrain_levels.to(torch.float32))]),
                          torch.sum(acc["ep_sums"], dim=0)])

    def global_sums(self, sums: torch.Tensor) -> torch.Tensor:
        """The collection's sums over every rank's envs: with ``dp`` one
        all-reduce of a copy (after the update's collectives, in the eager
        iteration and in the compiled one alike); ``sums`` otherwise."""
        if self.dp is None:
            return sums
        return self.dp.all_reduce_sum(sums.clone())

    def _metrics(self, sums: torch.Tensor, env_state, update_metrics) -> Dict[str, torch.Tensor]:
        """The iteration's metrics dict from the (global) sums, the env state
        after the rollout and the update's metrics: per-reward episode means
        over done envs (runner.py:284-301), the mean action std of the bound
        params."""
        env = self.env
        n_global = env.num_envs_global
        total_done = torch.clamp(sums[1], min=1.0)
        ep_metrics = {
            name: sums[4 + i] / total_done / env.max_episode_length_s
            for i, name in enumerate(env.all_reward_names)
        }
        if env.custom_origins and env.cfg.terrain.curriculum:
            ep_metrics["terrain_level"] = sums[3] / n_global
        if env.cfg.commands.curriculum:
            ep_metrics["max_command_x"] = env_state.cmd_lin_vel_x_range[1]
        with torch.no_grad():
            std_mean = torch.mean(self.net.std())
        return {
            "mean_step_reward": sums[0] / (self.num_steps_per_env * n_global),
            "done_count": sums[1],
            "mean_ep_len_done": sums[2] / total_done,
            "mean_action_std": std_mean,
            **{f"episode/{k}": v for k, v in ep_metrics.items()},
            **update_metrics,
        }

    def _train_iter(self, state: RunnerState, noise: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None, perm=None):
        """The iteration compiled (JAX ``runner.py:134``): the collection
        graph (on the engine one rollout step's graph replayed T times, then
        the collection's tail) and the update's graph replayed over the static state
        (``graphs.CompiledIteration``, made at the first call; each graph's
        first call is its warm-up, the body run eagerly, then its capture). ``state`` is
        copied in where it is not the static state itself; the returned
        state IS the static state, which the next call overwrites in place
        (donation: clone what must outlive it). ``noise``, ``u`` and
        ``perm`` together replace the draws, as for :meth:`iteration`
        (their own collection graph). Returns (the static state, metrics of
        0-d tensors with :meth:`iteration`'s keys, views of the update
        graph's output that the next call overwrites too); ``last_timing``
        from CUDA events between the replays; one synchronize at the end.
        Raises where :attr:`eager_reason` is not None, and on any failure
        to warm up, capture or replay (nothing runs eagerly instead)."""
        why = self.eager_reason
        if why is not None:
            raise ValueError(f"this config's iteration is not compiled: {why}")
        if self.compiled is None:
            from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration

            self.compiled = CompiledIteration(self, state)
        return self.compiled(state, noise=noise, u=u, perm=perm)

    def _rollout_graph(self, state: RunnerState):
        """The rollout alone as a CUDA graph over the compiled iteration's
        static state (not donated; the bench's counterpart of JAX's
        ``rollout_jit``). Returns (state, Transition, acc) as :meth:`rollout`.
        On K1 only: on the engine it raises (``CompiledIteration.rollout``)."""
        why = self.eager_reason
        if why is not None:
            raise ValueError(f"this config's rollout is not compiled: {why}")
        if self.compiled is None:
            from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration

            self.compiled = CompiledIteration(self, state)
        return self.compiled.rollout(state)

    # ------------------------------------------------------------------
    # host loop (on_policy_runner.learn; runner.py:312)
    # ------------------------------------------------------------------

    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = True,
              state: Optional[RunnerState] = None, profile_dir: Optional[str] = None) -> RunnerState:
        """Train for ``num_learning_iterations`` iterations; checkpoints every
        ``save_interval`` iterations and at the end when ``log_dir`` is set
        (rank 0 only). With ``dp`` every update ends with the check that the
        ranks' learner states are bit-identical (``replica_digests`` holds
        each iteration's digests).

        ``profile_dir``: trace iterations 2-4 of this call (counted from 0)
        with ``torch.profiler`` (the CPU, and the card's kernels when the
        runner is on CUDA) and write them as one Chrome trace
        ``<profile_dir>/trace_<pid>.json`` (JAX ``runner.py:312-346``
        writes a jax.profiler trace of the same iterations); each iteration
        is the range ``OnPolicyRunner.iteration <it>``. Open it in Perfetto
        or ``chrome://tracing``.

        Where :attr:`eager_reason` is None each iteration is
        :meth:`_train_iter` (graph replays), else :meth:`iteration`;
        the first call prints which and why. The metrics leave the device in
        one copy an iteration."""
        if state is None:
            state = self._loaded_state   # the resume path (task_registry.make_alg_runner)
        if state is None:
            state = self.init_state(init_at_random_ep_len)
        if self.log_dir is not None and self.is_lead:
            os.makedirs(self.log_dir, exist_ok=True)
        if self.log_dir is not None and self.writer is None and self.is_lead:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("tensorboard is not installed: no event files are written", flush=True)
                self.writer = False
            else:
                self.writer = SummaryWriter(log_dir=self.log_dir, flush_secs=10)

        steps_per_iter = self.num_steps_per_env * self.env.num_envs_global
        start_iter = self.current_learning_iteration
        why = self.eager_reason
        step = self.iteration if why else self._train_iter
        if self.is_lead:
            path = "recurrent" if self.recurrent else self.alg.path
            mesh = ("" if self.dp is None else
                    f"; dp {self.dp.world} x mp {1 if self.mp is None else self.mp.world} over "
                    f"{self.dp.backend}, the collectives captured")
            print("iteration: " + (f"eager ({why})" if why else
                                   f"compiled, CUDA graph replays over the static state (_train_iter; the "
                                   f"{path} update{mesh})"), flush=True)
        prof = None
        for it in range(start_iter, start_iter + num_learning_iterations):
            rel = it - start_iter
            if profile_dir is not None and rel == 2:
                prof = self._start_profile()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"OnPolicyRunner.iteration {it}"):
                state, metrics = step(state)
                self._sync()
            elapsed = time.perf_counter() - t0
            if prof is not None and rel == 4:
                self._stop_profile(prof, profile_dir)
                prof = None
            metrics = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            if self.dp is not None:
                self.replica_digests.append(sharding.check_replicas_identical(
                    self.dp, state.ppo, f"update of iteration {it}", net=self.net,
                    replicated=(state.env_state, torch.tensor([metrics[k] for k in sorted(metrics)],
                                                              dtype=torch.float64))))
            self.current_learning_iteration = it + 1
            self._log(it, metrics, elapsed, steps_per_iter)
            if self._saves and (it + 1) % self.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it + 1}.pt"), state)
        if prof is not None:   # fewer than 5 iterations: the trace ends with the last
            self._stop_profile(prof, profile_dir)
        if self._saves:
            self.save(os.path.join(self.log_dir, f"model_{self.current_learning_iteration}.pt"),
                      state)
        return state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir: str):
        self._sync()
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        print(f"wrote the profiler trace to {path}", flush=True)

    def _log(self, it: int, m: Dict[str, float], elapsed: float, steps_per_iter: int):
        # Perf/total_fps: the reference's FPS, env steps of the iteration over
        # its wall time (ended by a synchronize on the card)
        fps = steps_per_iter / elapsed
        self.log_history.append(dict(it=it, elapsed_s=elapsed, fps=fps, **self.last_timing,
                                     metrics=m))
        if m["done_count"] > 0:
            self.lenbuffer.append(m["mean_ep_len_done"])
        if self.writer:
            w = self.writer
            w.add_scalar("Loss/value_function", m["value_loss"], it)
            w.add_scalar("Loss/surrogate", m["surrogate_loss"], it)
            w.add_scalar("Loss/learning_rate", m["lr"], it)
            w.add_scalar("Loss/kl_mean", m["kl"], it)
            w.add_scalar("Policy/mean_noise_std", m["mean_action_std"], it)
            w.add_scalar("Perf/total_fps", fps, it)
            w.add_scalar("Perf/iteration_time", elapsed, it)
            w.add_scalar("Perf/collection_time", self.last_timing["collection_s"], it)
            w.add_scalar("Perf/learning_time", self.last_timing["update_s"], it)
            for key, tag in PERF_SPANS:
                if key in self.last_timing:
                    w.add_scalar(f"Perf/{tag}", self.last_timing[key], it)
            w.add_scalar("Train/mean_reward", m["mean_step_reward"], it)
            if self.lenbuffer:
                w.add_scalar("Train/mean_episode_length", statistics.mean(self.lenbuffer), it)
            for k, v in m.items():
                if k.startswith("episode/"):
                    w.add_scalar("Episode/" + k.split("/", 1)[1], v, it)
        if not self.is_lead:
            return
        print(
            f"it {it:5d} | fps {fps:9.0f} | rew {m['mean_step_reward']:7.3f} "
            f"| vloss {m['value_loss']:7.3f} | sloss {m['surrogate_loss']:7.4f} "
            f"| kl {m['kl']:6.4f} | lr {m['lr']:.2e} "
            f"| std {m['mean_action_std']:5.3f} | dones {m['done_count']:6.0f}",
            flush=True,
        )

    # ------------------------------------------------------------------
    # checkpoints (runner.py:395/:407): model_<it>.pt
    # ------------------------------------------------------------------

    def save(self, path: str, state: RunnerState):
        """Params, Adam moments and count, LR and iteration (the whole net's,
        gathered over the mp group first: every mp peer calls this), written
        by the lead rank only; the LSTM memory is not saved, as in JAX
        (runner.py:395-405)."""
        ppo = self.gathered(state.ppo)
        if not self.is_lead:
            return
        torch.save({
            "params": ppo.params.detach().cpu(), "m": ppo.m.cpu(), "v": ppo.v.cpu(),
            "count": ppo.count.cpu(), "learning_rate": ppo.learning_rate.cpu(),
            "iter": self.current_learning_iteration,
        }, path)

    def gathered(self, ppo: PPOState) -> PPOState:
        """``ppo`` with params, m and v of the whole net (under mp one
        all-gather over the mp group; ``ppo`` itself otherwise)."""
        if self.mp is None:
            return ppo
        n = self.net.num_params
        parts = self.mp.all_gather(torch.cat([ppo.params.detach(), ppo.m, ppo.v]))
        full = [sharding.gather_flat(self.net, parts[:, k * n:(k + 1) * n]) for k in range(3)]
        return ppo.replace(params=full[0], m=full[1], v=full[2])

    def full_net(self, state: Optional[RunnerState] = None):
        """A one-process net bound to the whole parameters of ``state``
        (default: the bound buffer); under mp gathered first (every mp peer
        calls this), so an export of a tensor-parallel run writes what a
        one-process run with those weights writes."""
        if self.mp is None:
            if state is not None:
                self.net.bind(state.ppo.params)
            return self.net
        params = self.net.params_flat if state is None else state.ppo.params
        n = self.net.num_params
        full = sharding.gather_flat(self.net, self.mp.all_gather(params.detach())[:, :n])
        net = type(self.net)(self.net.num_actor_input, self.net.num_critic_input, self.env.num_actions,
                             self.policy_cfg, generator=torch.Generator()).to(self.device)
        net.bind(full.contiguous())
        return net

    def load(self, path: Optional[str], state: Optional[RunnerState] = None, load_optimizer: bool = True):
        """Restore params, LR (and with ``load_optimizer`` m, v and the count)
        and the iteration from ``path`` (the whole net's, at any ``num_mp``);
        the next ``learn`` resumes from it. With ``dp`` the lead rank reads
        ``path`` and the others take what it read (their ``path`` is not
        read and may be None): under mp the whole state is broadcast over
        the lead's mp group and each rank keeps its shard, then each dp
        group takes its dp rank 0's."""
        if state is None:
            state = self.init_state()
        it = 0
        ppo = self.gathered(state.ppo)
        if self.is_lead:
            ck = torch.load(path, map_location=self.device, weights_only=True)
            ppo = ppo.replace(params=ck["params"].contiguous(), learning_rate=ck["learning_rate"])
            if load_optimizer:
                ppo = ppo.replace(m=ck["m"], v=ck["v"], count=ck["count"])
            it = int(ck["iter"])
        it = torch.tensor([it], dtype=torch.int64, device=self.device)
        if self.mp is not None:
            mp, net = self.mp, self.net
            full = mp.broadcast(torch.cat([ppo.params.reshape(-1), ppo.m.reshape(-1), ppo.v.reshape(-1),
                                           ppo.learning_rate.reshape(1).to(torch.float32)]).to(mp.device))
            count = mp.broadcast(ppo.count.reshape(1).to(device=mp.device, dtype=torch.int32).clone())
            it = mp.broadcast(it.to(mp.device))
            n = net.full_num_params
            shard = lambda k: sharding.shard_flat(net, full[k * n:(k + 1) * n], mp.world, mp.rank).contiguous()
            ppo = ppo.replace(params=shard(0), m=shard(1), v=shard(2), learning_rate=full[3 * n].clone(),
                              count=count[0].clone())
        if self.dp is not None:
            ppo = sharding.broadcast_ppo_state(self.dp, ppo)
            it = self.dp.broadcast(it.to(self.dp.device))
        self.current_learning_iteration = int(it[0])
        self.net.bind(ppo.params)
        state = state.replace(ppo=ppo)
        self._loaded_state = state
        return state

    def get_inference_policy(self):
        """Deterministic policy: obs -> action mean. The recurrent policy is
        stateful: it carries the LSTM memory across calls (zeros at the
        first), and ``policy.reset()`` zeroes it (runner.py:437-466). It does
        not zero the memory of an env that resets, as the reference's
        ``PolicyExporterLSTM`` does not."""
        net = self.net
        if not self.recurrent:
            @torch.no_grad()
            def policy(obs):
                return net.act_inference(obs)

            return policy
        cell = {"hidden": None}

        @torch.no_grad()
        def policy(obs):
            if cell["hidden"] is None:
                cell["hidden"] = net.initial_hidden(obs.shape[0], obs.device)
            actions, cell["hidden"] = net.act_inference_rnn(obs, cell["hidden"])
            return actions

        policy.reset = lambda: cell.update(hidden=None)
        return policy
