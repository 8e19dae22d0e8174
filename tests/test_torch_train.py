"""The port's training entry point end to end on the CPU.

``scripts/train.py`` with ``--device cpu --num_envs 4 --max_iterations 2``
(the GR1T1 config otherwise as shipped: full-width networks, 64 steps per
env, 8 epochs x 25 minibatches, the default whole-update path, whose plain
version runs on CPU tensors) into a temporary log root. Checks: finite
losses, ``model_2.pt`` in the reference's run-dir layout, a resume with
``--resume --checkpoint 2`` that restores params, Adam moments, count, LR
and iteration exactly, and the registry's ValueError, listing what is
there, for a checkpoint that does not exist.
"""

import math
import os

import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.scripts.train import train
from wiki_grx_gym_tpu_torch.utils.helpers import get_args
from wiki_grx_gym_tpu_torch.utils.task_registry import get_load_path

ARGS = ["--task", "GR1T1", "--device", "cpu", "--num_envs", "4", "--max_iterations", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("logs"))
    before = dict(LAUNCHES)
    runner, state = train(get_args(ARGS), log_root=root)
    assert LAUNCHES == before   # CPU tensors launch no kernel
    return root, runner, state


def test_train_writes_model_2_in_the_run_dir_layout(trained):
    root, runner, state = trained
    runs = os.listdir(root)
    assert len(runs) == 1 and runs[0].endswith("_gr1t1_lower_limb")
    assert os.path.isfile(os.path.join(root, runs[0], "model_2.pt"))
    assert runner.current_learning_iteration == 2
    assert runner.alg.path == "mega"
    assert int(state.ppo.count) == 2 * 8 * 25
    assert all(torch.isfinite(x).all() for x in (state.ppo.params, state.ppo.m, state.ppo.v))
    assert math.isfinite(float(state.ppo.learning_rate))


def test_resume_restores_the_checkpoint_exactly(trained):
    root, _, state = trained
    run = os.listdir(root)[0]
    args = get_args(ARGS + ["--resume", "--load_run", run, "--checkpoint", "2"])
    env, _ = task_registry.make_env("GR1T1", args=args, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", args=args, log_root=root)
    loaded = runner._loaded_state.ppo
    assert runner.current_learning_iteration == 2
    for name in ("params", "m", "v", "count", "learning_rate"):
        a, b = getattr(loaded, name), getattr(state.ppo, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # the network runs on the restored params
    assert runner.net.params_flat.data_ptr() == loaded.params.data_ptr()


def test_missing_checkpoint_raises_listing_what_is_there(trained):
    root, _, _ = trained
    run = os.listdir(root)[0]
    with pytest.raises(ValueError, match=r"model_2\.pt"):
        get_load_path(root, load_run=run, checkpoint=7)
    assert get_load_path(root).endswith(os.path.join(run, "model_2.pt"))
    with pytest.raises(ValueError, match="No runs"):
        get_load_path(os.path.join(root, "nowhere"))


def test_train_defaults_to_the_card():
    args = get_args(["--task", "GR1T1"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return   # with a card the default would start a full training run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(args, log_root=None)
