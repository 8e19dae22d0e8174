"""Task registry + env factory (port of ``wiki_grx_gym_tpu/utils/task_registry.py``).

``make_env`` resolves the compiled robot spec from the port's own copy of the
resources, builds the terrain grid for ``mesh_type`` heightfield or trimesh,
and returns a :class:`LeggedEnv` on the requested device (default
``"cuda"``); ``make_alg_runner`` builds the PPO runner on the env's device,
with the reference's log layout ``logs/<experiment_name>/<date>_<run_name>``,
and resumes from a ``model_<it>.pt`` checkpoint found by ``get_load_path``.
"""

from __future__ import annotations

import os
from datetime import datetime
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

    def make_env(self, name: str, args=None, env_cfg: LeggedRobotCfg = None, device="cuda", dp=None):
        """Build the env. With ``dp`` (a ``parallel.mesh.DataParallel``) it is
        that rank's shard of ``env_cfg.env.num_envs`` envs on the rank's
        device. Returns (env, env_cfg)."""
        from wiki_grx_gym_tpu_torch.models.serialize import load_robot

        if name not in self.task_classes:
            raise ValueError(f"Task {name!r} not registered. Available: {self.get_task_names()}")
        task_class = self.task_classes[name]
        if env_cfg is None:
            env_cfg, _ = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(env_cfg, None, args)
        model = load_robot(os.path.join(RESOURCES, env_cfg.asset.file + ".json"))
        shard = None
        if dp is not None:
            from wiki_grx_gym_tpu_torch.parallel.sharding import shard_bounds

            device = dp.device
            shard = shard_bounds(env_cfg.env.num_envs, dp.world, dp.rank)
        terrain = None
        if env_cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            from wiki_grx_gym_tpu_torch.device import resolve_device
            from wiki_grx_gym_tpu_torch.terrain.composer import Terrain

            terrain = Terrain(env_cfg.terrain, device=resolve_device(device))
        env = task_class(env_cfg, model, terrain=terrain, device=device, shard=shard, dp=dp)
        return env, env_cfg

    def make_alg_runner(self, env, name: str, args=None, train_cfg=None, log_root="default", dp=None):
        """Build the PPO runner on ``env.device`` (with ``dp``, for that rank's
        env: only rank 0 writes, and only rank 0 looks for the checkpoint to
        resume from). ``log_root="default"`` is ``logs/<experiment_name>``
        under the checkout; None writes nothing. Returns (runner, train_cfg)."""
        from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

        if train_cfg is None:
            _, train_cfg = self.get_cfgs(name)
        if args is not None:
            update_cfg_from_args(None, train_cfg, args)
        if log_root == "default":
            log_root = os.path.join(ROOT_DIR, "logs", train_cfg.runner.experiment_name)
        log_dir = None if log_root is None else os.path.join(
            log_root, datetime.now().strftime("%b%d_%H-%M-%S") + "_" + train_cfg.runner.run_name)
        rcn = str(getattr(train_cfg, "runner_class_name", "OnPolicyRunner"))
        if rcn != "OnPolicyRunner":
            raise ValueError(f"unknown runner_class_name {rcn!r}")
        runner = OnPolicyRunner(env, train_cfg, device=env.device, log_dir=log_dir, dp=dp)
        if train_cfg.runner.resume:
            resume_path = None
            if runner.is_lead:
                resume_path = get_load_path(log_root, load_run=train_cfg.runner.load_run,
                                            checkpoint=train_cfg.runner.checkpoint)
                print(f"Loading model from: {resume_path}")
            runner.load(resume_path)
        return runner, train_cfg


def get_load_path(root, load_run=-1, checkpoint=-1):
    """The latest run and checkpoint, or the ones named (helpers.py:108-130):
    runs are the directories under ``root``, checkpoints ``model_<it>.pt``."""
    try:
        runs = sorted(
            (x for x in os.listdir(root) if os.path.isdir(os.path.join(root, x))),
            key=lambda x: os.path.getmtime(os.path.join(root, x)),
        )
        if "exported" in runs:
            runs.remove("exported")
        last_run = os.path.join(root, runs[-1])
    except (IndexError, FileNotFoundError):
        raise ValueError(f"No runs in this directory: {root}")
    load_run = last_run if load_run == -1 else os.path.join(root, load_run)
    if checkpoint == -1:
        models = [f for f in os.listdir(load_run) if "model" in f]
        models.sort(key=lambda m: f"{m:0>15}")
        if not models:
            raise ValueError(f"No checkpoints in run directory: {load_run}")
        model = models[-1]
    else:
        model = f"model_{checkpoint}.pt"
        if not os.path.isfile(os.path.join(load_run, model)):
            available = sorted(f for f in os.listdir(load_run) if f.startswith("model_"))
            raise ValueError(f"Checkpoint {checkpoint!r} not found in {load_run}; "
                             f"available: {available}")
    return os.path.join(load_run, model)


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
