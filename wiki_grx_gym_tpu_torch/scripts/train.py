"""Training entry point (port of ``wiki_grx_gym_tpu/scripts/train.py``).

    python -m wiki_grx_gym_tpu_torch.scripts.train --task=GR1T1 [--num_envs N]
        [--seed S] [--max_iterations K] [--resume [--load_run R] [--checkpoint C]]
        [--device cuda|cpu]

Runs on the card by default and raises without one; ``--device cpu`` runs
the kernels' plain versions on the CPU. ``--task GR1T1_lstm`` trains the
recurrent policy (its update replays the LSTM with autograd; K2 and K3 are
the MLP's). One device: multi-GPU training is
ROADMAP queue 1 item 14. Checkpoints and TensorBoard events go to
``logs/<experiment_name>/<date>_<run_name>/``.
"""

from __future__ import annotations

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.utils.helpers import get_args, set_seed


def train(args, log_root="default"):
    """Returns (runner, final RunnerState)."""
    _, train_cfg = task_registry.get_cfgs(args.task)
    args.seed = set_seed(args.seed if args.seed is not None else train_cfg.seed)
    env, _ = task_registry.make_env(args.task, args=args, device=args.device)
    runner, train_cfg = task_registry.make_alg_runner(env, args.task, args=args,
                                                      log_root=log_root)
    state = runner.learn(num_learning_iterations=train_cfg.runner.max_iterations,
                         init_at_random_ep_len=True)
    return runner, state


if __name__ == "__main__":
    train(get_args())
