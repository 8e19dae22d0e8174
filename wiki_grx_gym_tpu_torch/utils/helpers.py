"""CLI arguments + seeding + policy-archive helpers (port of
``wiki_grx_gym_tpu/utils/helpers.py``: ``export_policy_npz`` writes and
``load_policy_npz`` reads the deploy ``.npz``)."""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="wiki-grx-gym PyTorch port")
    parser.add_argument("--task", type=str, default="GR1T1")
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--experiment_name", type=str, default=None)
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--load_run", type=str, default=None)
    parser.add_argument("--checkpoint", type=int, default=None)
    parser.add_argument("--headless", action="store_true", default=True)
    parser.add_argument("--num_envs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max_iterations", type=int, default=None)
    # port additions
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain lane program")
    parser.add_argument("--policy", type=str, default=None,
                        help="play.py: policy.npz to run (the export_policy_npz format) instead of "
                             "the run's latest checkpoint")
    parser.add_argument("--steps", type=int, default=500, help="play.py: policy steps")
    parser.add_argument("--record", action="store_true", default=False,
                        help="play.py: dump a replayable trajectory artifact "
                             "(traj.npz; animate with python -m "
                             "wiki_grx_gym_tpu_torch.tools.visualize --replay)")
    # data parallel (train.py)
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="one rank of a data-parallel group (run under torchrun)")
    parser.add_argument("--num_mp", type=int, default=1,
                        help="tensor-parallel ways: the MLP hidden layers split over this many "
                             "consecutive ranks (needs --distributed)")
    parser.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend: nccl on CUDA, gloo on the CPU by default")
    return parser.parse_args(argv)


def set_seed(seed: int) -> int:
    """Seed the host RNGs and torch's default generators."""
    if seed == -1:
        seed = np.random.randint(0, 10000)
    print(f"Setting seed: {seed}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def export_policy_npz(net, path: str) -> None:
    """Deploy-format export of the port's ``ActorCritic`` or
    ``ActorCriticRecurrent`` (the format of the JAX package's
    ``export_policy_npz``): the actor's weights as ``actor_w{i}`` (in, out)
    and ``actor_b{i}``, for a recurrent actor its LSTM layers as
    ``lstm{i}_w_ih`` (I, 4H), ``lstm{i}_w_hh`` (H, 4H), ``lstm{i}_b_ih`` and
    ``lstm{i}_b_hh`` (JAX's layout, gate order i, f, g, o), the raw ``std``
    parameter and ``activation`` "elu", float32 whatever the net's
    ``compute_dtype`` (as JAX's), in one ``.npz``. A tensor-parallel rank's
    net is refused: export ``OnPolicyRunner.full_net()``."""
    if getattr(net, "mp", None) is not None:
        raise ValueError("a tensor-parallel shard: export the gathered net (OnPolicyRunner.full_net())")
    blob = {}
    for i, lin in enumerate(m for m in net.actor if isinstance(m, torch.nn.Linear)):
        blob[f"actor_w{i}"] = lin.weight.detach().cpu().numpy().T.astype(np.float32)
        blob[f"actor_b{i}"] = lin.bias.detach().cpu().numpy().astype(np.float32)
    memory_a = net.memories()[0] if hasattr(net, "memories") else ()
    for i, layer in enumerate(memory_a):
        for k, t in zip(("w_ih", "w_hh", "b_ih", "b_hh"), layer):
            blob[f"lstm{i}_{k}"] = t.detach().cpu().numpy().astype(np.float32)
    blob["std"] = net.std_param.detach().cpu().numpy().astype(np.float32)
    blob["activation"] = np.asarray("elu")
    np.savez(path, **blob)


def load_policy_npz(path: str):
    """Numpy-only policy loader for deployment targets: the MLP actor. A
    recurrent actor's file (``lstm*`` keys) is refused with a ValueError; the
    JAX loader ignores those keys and fails at the first product instead."""
    blob = np.load(path, allow_pickle=False)
    lstm = sorted(k for k in blob.files if k.startswith("lstm"))
    if lstm:
        raise ValueError(f"{path} holds a recurrent actor (LSTM keys {lstm}); this loader runs "
                         "the MLP actor only")
    n_layers = sum(1 for k in blob.files if k.startswith("actor_w"))
    weights = [(blob[f"actor_w{i}"], blob[f"actor_b{i}"]) for i in range(n_layers)]

    def elu(x):
        return np.where(x > 0, x, np.expm1(x))

    def policy(obs):
        x = np.asarray(obs, np.float32)
        for w, b in weights[:-1]:
            x = elu(x @ w + b)
        w, b = weights[-1]
        return x @ w + b

    return policy
