"""Task registry + env factory (port of ``wiki_grx_gym_tpu/utils/task_registry.py``).

``make_env`` resolves the compiled robot spec from the port's own copy of the
resources and returns a :class:`LeggedEnv` on the requested device (default
``"cuda"``). ``make_alg_runner`` and the checkpoint path helpers wait for the
learner (slice 2).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple, Type

from wiki_grx_gym_tpu_torch.envs.base_config import LeggedRobotCfg, LeggedRobotCfgPPO
from wiki_grx_gym_tpu_torch.models.serialize import RESOURCES

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TaskRegistry:
    def __init__(self):
        self.task_classes: Dict[str, type] = {}
        self.env_cfgs: Dict[str, Type[LeggedRobotCfg]] = {}
        self.train_cfgs: Dict[str, Type[LeggedRobotCfgPPO]] = {}

    def register(self, name: str, task_class, env_cfg_class, train_cfg_class) -> None:
        self.task_classes[name] = task_class
        self.env_cfgs[name] = env_cfg_class
        self.train_cfgs[name] = train_cfg_class

    def get_task_names(self):
        return list(self.task_classes.keys())

    def get_cfgs(self, name: str) -> Tuple[LeggedRobotCfg, LeggedRobotCfgPPO]:
        return self.env_cfgs[name](), self.train_cfgs[name]()

    def make_env(self, name: str, args=None, env_cfg: LeggedRobotCfg = None, device="cuda"):
        """Build the env. Returns (env, env_cfg)."""
        from wiki_grx_gym_tpu_torch.models.serialize import load_robot

        if name not in self.task_classes:
            raise ValueError(f"Task {name!r} not registered. Available: {self.get_task_names()}")
        task_class = self.task_classes[name]
        if env_cfg is None:
            env_cfg, _ = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(env_cfg, None, args)
        model = load_robot(os.path.join(RESOURCES, env_cfg.asset.file + ".json"))
        env = task_class(env_cfg, model, device=device)
        return env, env_cfg


def update_cfg_from_args(env_cfg, cfg_train, args):
    """CLI overrides."""
    if env_cfg is not None:
        if getattr(args, "num_envs", None) is not None:
            env_cfg.env.num_envs = args.num_envs
    if cfg_train is not None:
        if getattr(args, "seed", None) is not None:
            cfg_train.seed = args.seed
        if getattr(args, "max_iterations", None) is not None:
            cfg_train.runner.max_iterations = args.max_iterations
        if getattr(args, "resume", False):
            cfg_train.runner.resume = args.resume
        if getattr(args, "experiment_name", None) is not None:
            cfg_train.runner.experiment_name = args.experiment_name
        if getattr(args, "run_name", None) is not None:
            cfg_train.runner.run_name = args.run_name
        if getattr(args, "load_run", None) is not None:
            cfg_train.runner.load_run = args.load_run
        if getattr(args, "checkpoint", None) is not None:
            cfg_train.runner.checkpoint = args.checkpoint


task_registry = TaskRegistry()
