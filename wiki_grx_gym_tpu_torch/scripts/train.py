"""Training entry point (port of ``wiki_grx_gym_tpu/scripts/train.py``).

    python -m wiki_grx_gym_tpu_torch.scripts.train --task=GR1T1 [--num_envs N]
        [--seed S] [--max_iterations K] [--resume [--load_run R] [--checkpoint C]]
        [--device cuda|cpu]

Runs on the card by default and raises without one; ``--device cpu`` runs
the kernels' plain versions on the CPU. ``--task GR1T1_lstm`` trains the
recurrent policy (its update replays the LSTM with autograd; K2 and K3 are
the MLP's). Checkpoints and TensorBoard events go to
``logs/<experiment_name>/<date>_<run_name>/``.

Data parallel over K GPUs of one host, each rank stepping ``num_envs / K``
envs and all-reducing the gradient once a grad step:

    torchrun --nproc_per_node=K -m wiki_grx_gym_tpu_torch.scripts.train --distributed ...
        [--dist_backend nccl|gloo]

Without ``--distributed`` the run is one process, and torchrun's variables
in the environment are refused. ``--num_mp`` > 1 (tensor parallelism) is
ROADMAP queue 1 item 14b and is refused. Unlike JAX's CLI, which sets
``runner.mesh`` after building the runner (so its PPO keeps
``perm_groups = 1``), the runner here is built with the data-parallel
group: ``permutation_groups = 0`` resolves to the group's size.
"""

from __future__ import annotations

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.parallel import mesh
from wiki_grx_gym_tpu_torch.utils.helpers import get_args, set_seed


def train(args, log_root="default", dp=None):
    """Returns (runner, final RunnerState). ``dp``: this rank's
    ``DataParallel`` (:func:`main` forms it for ``--distributed``)."""
    mesh.make_mesh(num_mp=args.num_mp)
    if dp is None and (args.distributed or mesh.launched_by_torchrun()):
        raise RuntimeError("a data-parallel run (--distributed, or torchrun's RANK/WORLD_SIZE/LOCAL_RANK "
                           "set) needs its process group: run main() with --distributed")
    _, train_cfg = task_registry.get_cfgs(args.task)
    args.seed = set_seed(args.seed if args.seed is not None else train_cfg.seed)
    device = args.device if dp is None else dp.device
    env, _ = task_registry.make_env(args.task, args=args, device=device, dp=dp)
    runner, train_cfg = task_registry.make_alg_runner(env, args.task, args=args,
                                                      log_root=log_root, dp=dp)
    state = runner.learn(num_learning_iterations=train_cfg.runner.max_iterations,
                         init_at_random_ep_len=True)
    return runner, state


def main(argv=None):
    args = get_args(argv)
    mesh.make_mesh(num_mp=args.num_mp)   # refuses tensor parallelism before a group forms
    dp = mesh.init_distributed(backend=args.dist_backend, device=args.device) if args.distributed else None
    try:
        train(args, dp=dp)
    finally:
        mesh.destroy(dp)


if __name__ == "__main__":
    main()
