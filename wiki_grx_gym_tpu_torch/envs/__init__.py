"""Task registration (port of ``wiki_grx_gym_tpu/envs/__init__.py``): the same
seven names and aliases. ``GR1T1``/``GR1T2`` are the lower-limb tasks,
``GR1T1_full``/``GR1T2_full`` the 32-DOF full bodies, and ``GR1T1_lstm`` the
lower limb with the recurrent (LSTM) policy; each trains in one process,
data parallel or tensor parallel, with the bf16 policy and update options.
What still raises ``NotImplementedError`` names its ROADMAP item: models of
more than 32 dofs on K1."""

from wiki_grx_gym_tpu_torch.envs.legged_env import EnvState, LeggedEnv, StepOutput  # noqa: F401
from wiki_grx_gym_tpu_torch.envs.gr1t1_config import (  # noqa: F401
    GR1T1Cfg,
    GR1T1CfgPPO,
    GR1T1FullCfg,
    GR1T1FullCfgPPO,
    GR1T1LowerLimbCfg,
    GR1T1LowerLimbCfgPPO,
    GR1T1LowerLimbCfgPPOLstm,
)
from wiki_grx_gym_tpu_torch.envs.gr1t2_config import (  # noqa: F401
    GR1T2Cfg,
    GR1T2CfgPPO,
    GR1T2FullCfg,
    GR1T2FullCfgPPO,
    GR1T2LowerLimbCfg,
    GR1T2LowerLimbCfgPPO,
)
from wiki_grx_gym_tpu_torch.utils.task_registry import task_registry

task_registry.register("GR1T1", LeggedEnv, GR1T1LowerLimbCfg, GR1T1LowerLimbCfgPPO)
task_registry.register("GR1T2", LeggedEnv, GR1T2LowerLimbCfg, GR1T2LowerLimbCfgPPO)
task_registry.register("GR1T1_lower_limb", LeggedEnv, GR1T1LowerLimbCfg, GR1T1LowerLimbCfgPPO)
task_registry.register("GR1T2_lower_limb", LeggedEnv, GR1T2LowerLimbCfg, GR1T2LowerLimbCfgPPO)
task_registry.register("GR1T1_full", LeggedEnv, GR1T1FullCfg, GR1T1FullCfgPPO)
task_registry.register("GR1T2_full", LeggedEnv, GR1T2FullCfg, GR1T2FullCfgPPO)
task_registry.register("GR1T1_lstm", LeggedEnv, GR1T1LowerLimbCfg, GR1T1LowerLimbCfgPPOLstm)
