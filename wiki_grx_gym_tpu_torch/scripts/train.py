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

Over NCCL (the default on GPUs) the iteration is compiled: CUDA graph
replays with the collectives captured (``learn/graphs.py``). Across ranks
that holds for the graphs that runs on several cards have held against the
eager iteration (``parallel/mesh.COMPILED_COLLECTIONS`` and
``COMPILED_UPDATES``), which is every run a mesh selects: data
parallelism, tensor parallelism (``--num_mp``) and both, on K1 and on the
engine (``use_pallas = False``), with the MLP or the LSTM, on every update
path, with or without the symmetry loss and the global shuffle. Over
gloo, and with the ``"lanes"`` physics backend, it runs eagerly
(``OnPolicyRunner.eager_reason``). ``learn`` prints which, and the update
path, before the first iteration.

Tensor parallel: ``--num_mp M`` splits the MLP hidden layers over M
consecutive ranks (Megatron, as JAX's ``shard_params``) and data-parallels
over the ``K / M`` groups of them:

    torchrun --nproc_per_node=K -m wiki_grx_gym_tpu_torch.scripts.train --distributed --num_mp M ...

Without ``--distributed`` the run is one process: torchrun's variables in
the environment, and ``--num_mp`` > 1, are refused. Unlike JAX's CLI, which
sets ``runner.mesh`` after building the runner (so its PPO keeps
``perm_groups = 1`` and its flat optimizer), the mesh here is built before
the runner and passed at construction: ``permutation_groups = 0`` resolves
to the dp group's size, and under mp PPO takes the xla path. JAX's CLI run,
the reference's global shuffle across ranks, is ``algorithm.permutation_groups
= 1`` (``learn/ppo.py``'s global shuffle: each rank updates on the gathered
global batch, on the kernels' paths; under ``--num_mp`` on the xla path).
"""

from __future__ import annotations

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.parallel import mesh
from wiki_grx_gym_tpu_torch.utils.helpers import get_args, set_seed


def train(args, log_root="default", dp=None):
    """Returns (runner, final RunnerState). ``dp``: this rank's
    ``DataParallel`` with its ``mp`` for ``--num_mp`` > 1 (:func:`main` forms
    them for ``--distributed``)."""
    if int(args.num_mp) < 1:
        raise ValueError(f"--num_mp must be >= 1, got {args.num_mp}")
    if dp is None and (args.distributed or mesh.launched_by_torchrun()):
        raise RuntimeError("a data-parallel run (--distributed, or torchrun's RANK/WORLD_SIZE/LOCAL_RANK "
                           "set) needs its process group: run main() with --distributed")
    if int(args.num_mp) != (1 if dp is None or dp.mp is None else dp.mp.world):
        raise ValueError(f"--num_mp {args.num_mp} needs --distributed and the mesh of make_mesh(num_mp, dp)"
                         " (tensor parallelism splits the net over the ranks of a process group)")
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
    if args.num_mp != 1 and not args.distributed:
        raise ValueError(f"--num_mp {args.num_mp} needs --distributed (run under torchrun)")
    dp = mesh.init_distributed(backend=args.dist_backend, device=args.device) if args.distributed else None
    try:
        # the mesh before the runner, passed at construction
        train(args, dp=mesh.make_mesh(args.num_mp, dp))
    finally:
        mesh.destroy(dp)


if __name__ == "__main__":
    main()
