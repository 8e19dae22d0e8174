"""GR1T2 = GR1T1 with a different robot spec (`gr1t2_config.py:7-14`,
`envs/gr1t2/gr1t2.py:4-5` — the env class is a pure alias)."""

from wiki_grx_gym_tpu_torch.envs.gr1t1_config import (
    GR1T1Cfg,
    GR1T1CfgPPO,
    GR1T1LowerLimbCfg,
    GR1T1LowerLimbCfgPPO,
)  # noqa: F401 (GR1T1LowerLimbCfg also feeds the full-body scales below)


class GR1T2Cfg(GR1T1Cfg):
    class asset(GR1T1Cfg.asset):
        file = "gr1t2"
        name = "GR1T2"


class GR1T2CfgPPO(GR1T1CfgPPO):
    class runner(GR1T1CfgPPO.runner):
        experiment_name = "GR1T2"
        run_name = "gr1t2"


class GR1T2LowerLimbCfg(GR1T1LowerLimbCfg):
    class asset(GR1T1LowerLimbCfg.asset):
        file = "gr1t2_lower_limb"
        name = "GR1T2"


class GR1T2LowerLimbCfgPPO(GR1T1LowerLimbCfgPPO):
    class runner(GR1T1LowerLimbCfgPPO.runner):
        experiment_name = "GR1T2"
        run_name = "gr1t2_lower_limb"


class GR1T2FullCfg(GR1T2Cfg):
    """Trainable full-body GR1T2 — same extension as GR1T1FullCfg (the
    reference registers only lower-limb tasks and ships no full-body
    reward scales)."""

    class rewards(GR1T2Cfg.rewards):
        class scales(GR1T1LowerLimbCfg.rewards.scales):
            pass


class GR1T2FullCfgPPO(GR1T2CfgPPO):
    class runner(GR1T2CfgPPO.runner):
        run_name = "gr1t2_full"

    class algorithm(GR1T2CfgPPO.algorithm):
        # validated lower-limb recipe, see GR1T1FullCfgPPO.algorithm
        desired_kl = 0.03
