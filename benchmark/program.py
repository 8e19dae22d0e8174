"""The system under test: the compiled training iteration of
``wiki_grx_gym_tpu_torch`` (``OnPolicyRunner._train_iter``: the
collection's CUDA graph, then the update's), built through the task
registry as the port's ``scripts/train.py`` and ``scripts/bench.py`` build
it. This is the only module of the benchmark that imports the port; what it
reads back is the iteration's outputs, its CUDA-event timing and its graph
reports.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import torch

from benchmark.reference.actor_critic import layout


ENV_PHYSICS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor")
ENV_RAND = ("friction", "restitution", "base_mass_scale", "base_com_offset")
ENV_FIELDS = ("episode_length", "common_step", "commands", "last_actions", "last_last_actions", "last_dof_vel",
              "feet_air_time", "feet_land_time", "feet_contact_last", "motor_strength", "cmd_lin_vel_x_range")


def _stated(config: dict, env_cfg, train_cfg) -> List[str]:
    """Where the program's configuration differs from what the
    configuration file states."""
    out = []

    def same(what, have, want):
        if isinstance(want, float) or isinstance(have, float):
            ok = float(have) == float(want)
        else:
            ok = (list(have) if isinstance(have, (list, tuple)) else have) == want
        if not ok:
            out.append(f"{what}: the program runs {have!r}, the configuration states {want!r}")

    for k, want in config["algorithm"].items():
        same(f"algorithm.{k}", getattr(train_cfg.algorithm, k), want)
    for k, want in config["policy"].items():
        same(f"policy.{k}", getattr(train_cfg.policy, k), want)
    same("runner.num_steps_per_env", train_cfg.runner.num_steps_per_env, config["runner"]["num_steps_per_env"])
    env = config["env"]
    for k in ("num_obs", "num_pri_obs", "num_actions", "episode_length_s"):
        same(f"env.{k}", getattr(env_cfg.env, k), env[k])
    same("control.decimation", env_cfg.control.decimation, env["decimation"])
    same("sim.dt", env_cfg.sim.dt, env["dt"])
    same("asset.file", env_cfg.asset.file, env["asset"])
    from wiki_grx_gym_tpu_torch.envs.base_config import class_to_dict

    have = json.loads(json.dumps(class_to_dict(env_cfg)))
    for group in sorted(set(have) | set(config["env_cfg"])):
        if have.get(group) != config["env_cfg"].get(group):
            out.append(f"env_cfg.{group}: the program runs {have.get(group)!r}, the configuration states "
                       f"{config['env_cfg'].get(group)!r}")
    return out


def _with_traffic(env_cfg: dict, traffic: dict, ranks: int) -> dict:
    """The configuration's env settings as the traffic runs them: its envs
    and its terrain keys."""
    out = json.loads(json.dumps(env_cfg))
    out["env"]["num_envs"] = int(traffic["envs_per_rank"]) * ranks
    out["terrain"].update(traffic.get("terrain", {}))
    return out


def init_group(rank: int, world: int, init_method: str):
    """This rank's NCCL group, as the port's train script makes it under
    ``--distributed`` (``parallel.mesh.init_distributed``)."""
    from wiki_grx_gym_tpu_torch.parallel import mesh

    return mesh.init_distributed(init_method=init_method, world_size=world, rank=rank, device="cuda")


def destroy_group(dp):
    from wiki_grx_gym_tpu_torch.parallel import mesh

    mesh.destroy(dp)


class Run:
    """One rank's training run of a cell: the env, the runner and the
    runner's state."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda", dp=None):
        from wiki_grx_gym_tpu_torch.envs import task_registry

        task = config["task"]
        env_cfg, train_cfg = task_registry.get_cfgs(task)
        ranks = 1 if dp is None else dp.world
        env_cfg.env.num_envs = int(traffic["envs_per_rank"]) * ranks
        for k, v in traffic.get("terrain", {}).items():
            setattr(env_cfg.terrain, k, v)
        config = dict(config, env_cfg=_with_traffic(config["env_cfg"], traffic, ranks))
        train_cfg.seed = int(seed)
        wrong = _stated(config, env_cfg, train_cfg)
        if wrong:
            raise ValueError("the program's configuration is not the stated one:\n  " + "\n  ".join(wrong))
        self.config, self.traffic, self.dp = config, traffic, dp
        self.env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device, dp=dp)
        self.runner, _ = task_registry.make_alg_runner(self.env, task, train_cfg=train_cfg, log_root=None, dp=dp)
        mine = [(n, o, tuple(s)) for n, o, s in self.runner.net.layout]
        if mine != layout(config):
            raise ValueError(f"the program's parameter layout {mine} is not the configuration's {layout(config)}")
        self.state = self.runner.init_state(init_at_random_ep_len=True)
        self.last: Optional[dict] = None

    @property
    def eager_reason(self) -> Optional[str]:
        return self.runner.eager_reason

    def geometry(self) -> Dict[str, int]:
        """The shapes of one iteration's draws on this rank: steps ``t``,
        envs ``n``, actions ``a``, the env step's uniform columns ``k``, and
        the update's permutation groups, blocks and used blocks."""
        env, alg = self.env, self.runner.alg
        t, n = self.runner.num_steps_per_env, env.num_envs
        groups = alg.local_groups
        _, blocks, used, rows = alg.shuffle_geometry(t, n // groups)
        return {"t": t, "n": n, "a": env.num_actions, "k": env._step_u_cols[1], "groups": groups,
                "blocks": blocks, "used": used, "rows": rows * groups}

    def set_params(self, flat: torch.Tensor):
        self.state.ppo.params.copy_(flat)
        self.runner.net.bind(self.state.ppo.params)

    def step(self, noise, u, perm) -> Dict[str, torch.Tensor]:
        """One compiled iteration on the given draws; each call ends in the
        iteration's own synchronize. Returns its metrics (0-d tensors on the
        card, overwritten by the next call)."""
        self.state, metrics = self.runner._train_iter(self.state, noise=noise, u=u, perm=perm)
        self.last = self.runner.compiled.last
        return metrics

    def timing(self) -> Dict[str, float]:
        """The last iteration's collection and update seconds (CUDA events)."""
        return dict(self.runner.last_timing)

    def collected(self) -> Dict[str, torch.Tensor]:
        """The last iteration's collection: the nine rollout fields (T, N,
        ...), the last values, returns and advantages, and the critic
        observations after the rollout (views the next call overwrites)."""
        batch = self.last["batch"]
        out = {f: getattr(batch, f) for f in batch._fields}
        out.update(last_values=self.last["last_values"], returns=self.last["returns"],
                   advantages=self.last["advantages"], final_critic_obs=self.state.critic_obs)
        return out

    def env_state(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The env's state before the next iteration, of the envs ``ids``
        (this rank's indices), one field a key (the physics and the body
        randomization flattened; ``common_step`` and the command range are
        the batch's), copied to the host."""
        es = self.state.env_state
        out = {k: getattr(es.physics, k) for k in ENV_PHYSICS}
        out.update({k: getattr(es.rand, k) for k in ENV_RAND})
        out.update({k: getattr(es, k) for k in ENV_FIELDS})
        rows = ids.to(es.commands.device)
        whole = ("common_step", "cmd_lin_vel_x_range")
        return {k: (v if k in whole else v.index_select(0, rows)).detach().to("cpu", copy=True)
                for k, v in out.items()}

    def ppo(self) -> Dict[str, torch.Tensor]:
        p = self.state.ppo
        return {"params": p.params, "m": p.m, "v": p.v, "count": p.count, "lr": p.learning_rate}

    def reports(self) -> List[dict]:
        compiled = self.runner.compiled
        return [] if compiled is None else compiled.reports()

    def release(self):
        if self.runner.compiled is not None:
            self.runner.compiled.release()
