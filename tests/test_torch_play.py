"""The port's play from the port's own checkpoints, and its policy export.

The port trains GR1T1 on the CPU (4 envs, 2 iterations, 8 steps per env and
one epoch of one minibatch, so the test stays short) into a temporary log
root, which writes ``model_2.pt``. ``scripts/play.py`` then loads the
latest checkpoint of the latest run through ``get_load_path`` and
``runner.load``, exports ``exported/policies/policy.npz`` and plays. The
JAX package's ``load_policy_npz`` reads that file, and its actor's outputs
equal the port's actor on the checkpoint's params at rtol 1e-5. A named
``--checkpoint`` that does not exist raises, and ``--policy`` still plays
a ``policy.npz`` without a checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu.utils.helpers import load_policy_npz as jax_load_policy_npz
from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.scripts.play import play
from wiki_grx_gym_tpu_torch.utils.helpers import get_args

ARGS = ["--task", "GR1T1", "--device", "cpu", "--num_envs", "4"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(log root, the trained runner, its final state): model_2.pt written by
    the port's runner on the CPU."""
    root = str(tmp_path_factory.mktemp("logs"))
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 4
    train_cfg.runner.num_steps_per_env = 8
    train_cfg.algorithm.num_learning_epochs = 1
    train_cfg.algorithm.num_mini_batches = 1
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=root)
    state = runner.learn(2)
    assert os.path.isfile(os.path.join(runner.log_dir, "model_2.pt"))
    return root, runner, state


def test_play_loads_the_latest_checkpoint_and_exports_policy_npz(trained):
    root, runner, state = trained
    before = dict(LAUNCHES)
    logger = play(get_args(ARGS), num_steps=3, log_root=root)
    assert LAUNCHES == before   # CPU tensors launch no kernel
    assert len(logger.rew_log["rew_total"]) == 3
    assert all(np.isfinite(v).all() for vals in {**logger.state_log, **logger.rew_log}.values()
               for v in vals)
    path = os.path.join(root, "exported", "policies", "policy.npz")
    blob = np.load(path)
    assert sorted(blob.files) == sorted([f"actor_{k}{i}" for k in "wb" for i in range(4)] + ["std", "activation"])
    assert blob["actor_w0"].shape == (39, 512) and blob["actor_w3"].shape == (128, 10)
    np.testing.assert_array_equal(blob["std"], runner.net.std_param.numpy())
    assert os.path.isfile(os.path.join(root, "exported", "policies", "policy.grxpolicy"))


def test_exported_policy_matches_the_port_in_the_jax_loader(trained):
    root, runner, state = trained
    path = os.path.join(root, "exported", "policies", "policy.npz")
    if not os.path.isfile(path):
        play(get_args(ARGS), num_steps=1, log_root=root)
    jax_policy = jax_load_policy_npz(path)
    runner.net.bind(state.ppo.params)
    obs = np.random.RandomState(3).randn(16, 39).astype(np.float32)
    with torch.no_grad():
        want = runner.net.act_inference(torch.from_numpy(obs)).numpy()
    got = np.asarray(jax_policy(obs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_play_names_a_missing_checkpoint(trained):
    root, _, _ = trained
    with pytest.raises(ValueError, match="model_2.pt"):
        play(get_args(ARGS + ["--checkpoint", "7"]), num_steps=1, log_root=root)


def test_play_from_policy_npz_exports_nothing(trained, tmp_path):
    root, _, _ = trained
    path = os.path.join(root, "exported", "policies", "policy.npz")
    if not os.path.isfile(path):
        play(get_args(ARGS), num_steps=1, log_root=root)
    logger = play(get_args(ARGS + ["--policy", path]), num_steps=2, log_root=str(tmp_path))
    assert len(logger.rew_log["rew_total"]) == 2
    assert not os.path.exists(tmp_path / "exported")
