"""On-policy runner, rollout half (port of ``wiki_grx_gym_tpu/learn/runner.py``).

Slice 1 ports what collects experience and runs a policy: the constructor's
rollout fields, ``init_state``, ``rollout`` (the JAX ``_rollout`` scan as a
Python loop over T steps filling a preallocated ``Transition`` buffer and
the per-env accumulators) and ``get_inference_policy``. ``learn``, GAE, the
PPO update and checkpoints are slice 2.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from wiki_grx_gym_tpu_torch.device import resolve_device
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic


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
    rng: torch.Generator       # action-noise generator

    def replace(self, **kw) -> "RunnerState":
        return dataclasses.replace(self, **kw)


class OnPolicyRunner:
    def __init__(self, env, train_cfg, device="cuda"):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env is on {env.device}, runner asked for {self.device}")
        self.env = env
        self.cfg = train_cfg.runner
        self.alg_cfg = train_cfg.algorithm
        self.policy_cfg = train_cfg.policy
        self.num_steps_per_env = int(self.cfg.num_steps_per_env)
        self.seed = int(getattr(train_cfg, "seed", 1))

        pcn = str(getattr(self.cfg, "policy_class_name", "ActorCritic"))
        if pcn not in ("ActorCritic", "ActorCriticMLP", "ActorCriticRecurrent"):
            raise ValueError(f"unknown policy_class_name {pcn!r}")
        if pcn == "ActorCriticRecurrent" or getattr(self.policy_cfg, "rnn_type", None):
            raise NotImplementedError("recurrent policies are ROADMAP queue 1 item 12")
        num_pri_obs = env.pri_obs_dim if env.cfg.env.num_pri_obs else env.obs_dim
        self.gamma = float(self.alg_cfg.gamma)
        self.fused_trunk = bool(getattr(self.alg_cfg, "fused_trunk", False))
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        self.net = ActorCritic(
            env.obs_dim, num_pri_obs, env.num_actions, self.policy_cfg,
        ).to(self.device)
        self.net.reset_parameters(g)

    # ------------------------------------------------------------------

    def init_state(self, init_at_random_ep_len: bool = False) -> RunnerState:
        """Env init + one zero-action step for the first observations."""
        env = self.env
        g_env = env.make_generator(self.seed)
        g_run = env.make_generator(self.seed + 1)
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
        return RunnerState(env_state=env_state, obs=out.obs, critic_obs=out.pri_obs, rng=g_run)

    @torch.no_grad()
    def rollout(self, state: RunnerState, noise: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None):
        """T = num_steps_per_env steps of act -> env.step -> store.

        ``noise``: optional (T, N, A) standard-normal action noise and ``u``:
        optional (T, N, K) per-step uniform blocks, used instead of drawing
        from ``state.rng`` and ``env_state.rng``.

        Returns (new state, Transition with (T, N, ...) fields, acc) where acc
        holds the per-env sums of reward, dones, episode sums at done and
        episode lengths at done."""
        env, net = self.env, self.net
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
        env_state, obs, critic_obs = state.env_state, state.obs, state.critic_obs
        for t in range(t_len):
            eps = noise[t] if noise is not None else torch.randn(
                (n, a), generator=state.rng, device=dev)
            if self.fused_trunk:
                mu, values = net.joint_mean_value(obs, critic_obs)
                sigma = net.std().expand_as(mu)
                actions = mu + sigma * eps
                logp = net.log_prob(mu, sigma, actions)
            else:
                actions, logp, mu, sigma = net.act(obs, eps)
                values = net.evaluate(critic_obs)
            env_state, out = env.step(env_state, actions, u=None if u is None else u[t])
            # timeout bootstrapping
            rewards = out.rew + self.gamma * values * out.extras["time_outs"]
            for field, val in (("obs", obs), ("critic_obs", critic_obs), ("actions", actions),
                               ("rewards", rewards), ("dones", out.reset), ("values", values),
                               ("log_prob", logp), ("mu", mu), ("sigma", sigma)):
                getattr(buf, field)[t] = val
            acc["rew"] += out.rew
            acc["done"] += out.reset.to(torch.float32)
            acc["ep_sums"] += out.extras["episode_done_sums"]
            acc["ep_len_done"] += out.extras["ep_len_done"]
            obs, critic_obs = out.obs, out.pri_obs
        new_state = state.replace(env_state=env_state, obs=obs, critic_obs=critic_obs)
        return new_state, buf, acc

    def get_inference_policy(self):
        """Deterministic policy: obs -> action mean."""
        net = self.net

        @torch.no_grad()
        def policy(obs):
            return net.act_inference(obs)

        return policy
