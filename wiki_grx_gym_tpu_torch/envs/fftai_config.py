"""FFTAI config level (`legged_gym/envs/fftai/legged_robot_fftai_config.py`)."""

from wiki_grx_gym_tpu_torch.envs.base_config import LeggedRobotCfg, LeggedRobotCfgPPO


class LeggedRobotFFTAICfg(LeggedRobotCfg):
    class sim(LeggedRobotCfg.sim):
        dt = 0.001

    class env(LeggedRobotCfg.env):
        num_obs = 1
        num_actions = 1

    class control(LeggedRobotCfg.control):
        # the FFTAI env family uses the actuation-delay model
        # (legged_robot_fftai.py:51-61)
        actuation_delay = True

    class rewards(LeggedRobotCfg.rewards):
        sigma_action_diff = -0.1
        sigma_action_diff_diff = -1.0


class LeggedRobotFFTAICfgPPO(LeggedRobotCfgPPO):
    pass
