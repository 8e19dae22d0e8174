"""The port's ``EvalLogger`` against the JAX package's (``utils/logger.py``).

Both loggers take the same seeded channel values, as play logs them (eleven
scalar channels and the feet's vertical contact forces a step, and a total
reward with the episodes that ended at the step). Their ``state_log``,
``rew_log`` (each value times the step's ended episodes), ``num_episodes``
and the text of ``print_rewards`` (summed and divided by ``max(episodes,
1)``) must be equal, and the two dashboards (``save_plots``, Agg) must
decode to equal pixels. Only the pixel comparison needs matplotlib; it
skips, saying so, where matplotlib is not installed.
"""

import numpy as np
import pytest

from wiki_grx_gym_tpu.utils.logger import EvalLogger as JaxEvalLogger
from wiki_grx_gym_tpu_torch.utils.logger import EvalLogger

SCALARS = ("dof_pos_target", "dof_pos", "dof_vel", "dof_torque", "command_x", "command_y",
           "command_yaw", "base_vel_x", "base_vel_y", "base_vel_z", "base_vel_yaw")
DT = 0.02


def fill(logger, steps=40, seed=0, feet=2):
    rng = np.random.RandomState(seed)
    for t in range(steps):
        row = {k: float(v) for k, v in zip(SCALARS, rng.randn(len(SCALARS)))}
        row["contact_forces_z"] = (rng.rand(feet) * 400).astype(np.float32)
        logger.log_states(row)
        logger.log_rewards({"rew_total": float(rng.randn()), "not_logged": 1.0}, int(t % 7 == 6))
    return logger


@pytest.fixture(scope="module")
def loggers():
    return fill(EvalLogger(DT)), fill(JaxEvalLogger(DT))


def test_logs_are_equal(loggers):
    port, jax_ = loggers
    assert list(port.state_log) == list(jax_.state_log) == list(SCALARS) + ["contact_forces_z"]
    for k in port.state_log:
        assert np.array_equal(np.asarray(port.state_log[k]), np.asarray(jax_.state_log[k])), k
    assert dict(port.rew_log) == dict(jax_.rew_log) and list(port.rew_log) == ["rew_total"]
    assert port.num_episodes == jax_.num_episodes == 5
    # a value is stored times the episodes that ended at its step
    assert port.rew_log["rew_total"][0] == 0.0 and port.rew_log["rew_total"][6] != 0.0


@pytest.mark.parametrize("steps,seed", [(40, 0), (5, 1)], ids=["episodes", "no-episode"])
def test_print_rewards_text_is_equal(capsys, steps, seed):
    fill(EvalLogger(DT), steps, seed).print_rewards()
    got = capsys.readouterr().out
    fill(JaxEvalLogger(DT), steps, seed).print_rewards()
    want = capsys.readouterr().out
    assert got == want and "Total number of episodes:" in got


def test_reset_clears_the_logs():
    lg = fill(EvalLogger(DT), 3)
    lg.reset()
    assert not lg.state_log and not lg.rew_log


def test_dashboards_decode_to_equal_pixels(loggers, tmp_path):
    pytest.importorskip("matplotlib", reason="matplotlib is not installed: the dashboards are not drawn")
    import matplotlib.image as mpimg

    port, jax_ = loggers
    port.save_plots(str(tmp_path / "port.png"))
    jax_.save_plots(str(tmp_path / "jax.png"))
    got, want = mpimg.imread(str(tmp_path / "port.png")), mpimg.imread(str(tmp_path / "jax.png"))
    assert got.shape == want.shape == (1000, 1500, 4)
    assert np.array_equal(got, want)
    assert got[..., :3].std() > 0   # something was drawn
