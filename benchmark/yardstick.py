"""The yardstick: the H100's published peaks and the work of each kernel
and of a whole iteration, from counts frozen in the benchmark's files.

Peaks (NVIDIA's H100 SXM data sheet, dense, at its 700 W limit): 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s FP32 outside them, 3.35 TB/s
of HBM3. A least time is the larger of operations over the peak rate and
bytes over the memory rate; a share of it (a ``_roofline`` or an ``mfu``)
is least time over measured time, so it cannot pass 100% unless the work
is counted too high.

The counts never read the port: K1's operations per env step and its
input and output words per env are frozen in a file of each K1 program,
``benchmark/work/<config>.<program>.json`` (counted once from the lane
program, as chip_smoke.py's ``count_plain_ops`` counts them); K2's and
K3's follow from the configuration's widths.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16_TC = 989e12     # FLOP/s
FP32 = 67e12         # FLOP/s
HBM = 3.35e12        # bytes/s


def mlp_dims(config: dict) -> Tuple[List[int], List[int]]:
    """(actor dims, critic dims), inputs first, outputs last."""
    env, pol = config["env"], config["policy"]
    actor = [env["num_obs"], *pol["actor_hidden_dims"], env["num_actions"]]
    critic = [env["num_pri_obs"], *pol["critic_hidden_dims"], 1]
    return actor, critic


def macs(dims: List[int]) -> int:
    """Multiply-adds of one row through an MLP of ``dims``."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def num_params(config: dict) -> int:
    actor, critic = mlp_dims(config)
    per = lambda d: sum(a * b + b for a, b in zip(d[:-1], d[1:]))
    return per(actor) + per(critic) + config["env"]["num_actions"]


def k1_least_s(work: dict, envs: int, launches: int) -> float:
    """K1's least time for ``launches`` policy steps of ``envs`` envs: its
    frozen operations at the FP32 peak, or its input and output words read
    and written once, whichever is longer."""
    ops = work["k1_ops_per_env_step"] * envs
    nbytes = work["k1_io_words_per_env"] * 4 * envs
    return launches * max(ops / FP32, nbytes / HBM)


def k2_work(config: dict, rows: int, op_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one K2 grad step over ``rows`` rows: the
    forward, weight-gradient and input-gradient products (none for the
    input layers), 2 a multiply-add; the minibatch's obs and critic obs
    read once in the operand type, its 3A + 4 f32 scalars, the f32 params
    read and the f32 gradient written (chip_smoke.py ``k2_work``)."""
    actor, critic = mlp_dims(config)
    w = macs(actor) + macs(critic)
    w_in = actor[0] * actor[1] + critic[0] * critic[1]
    ops = 2 * rows * w + 2 * rows * w + 2 * rows * (w - w_in)
    env = config["env"]
    nbytes = (rows * (env["num_obs"] + env["num_pri_obs"]) * op_bytes
              + rows * (3 * env["num_actions"] + 4) * 4 + 2 * num_params(config) * 4)
    return ops, nbytes


def k2_least_s(config: dict, rows: int, steps: int) -> float:
    ops, nbytes = k2_work(config, rows)
    return steps * max(ops / BF16_TC, nbytes / HBM)


def k3_step_bytes(config: dict) -> int:
    """One K3 step's bytes: p, m and v read and written, g read, f32."""
    return 7 * 4 * num_params(config)


def k3_least_s(config: dict, steps: int) -> float:
    return steps * k3_step_bytes(config) / HBM


def update_rows(config: dict, envs: int) -> Tuple[int, int]:
    """(rows a minibatch, grad steps an update) of the block shuffle at
    ``envs`` envs in one permutation group (``reference.ppo.shuffle_geometry``)."""
    from benchmark.reference.ppo import shuffle_geometry

    alg = config["algorithm"]
    t = config["runner"]["num_steps_per_env"]
    _, _, _, rows = shuffle_geometry(t, envs, alg["shuffle_block"], alg["num_mini_batches"])
    return rows, alg["num_learning_epochs"] * alg["num_mini_batches"]


def iteration_least_s(config: dict, work: dict, envs: int) -> Dict[str, float]:
    """The least time of one training iteration on one card holding
    ``envs`` envs: the actor-critic's products (each rollout step's actor
    and critic forward, the last values, and each grad step's rows at three
    times a forward) at the bf16 peak, plus K1's frozen operations at the
    FP32 peak. ``total`` and its parts."""
    actor, critic = mlp_dims(config)
    t = config["runner"]["num_steps_per_env"]
    rows, steps = update_rows(config, envs)
    rollout = 2 * (t * envs * (macs(actor) + macs(critic)) + envs * macs(critic))
    update = 3 * 2 * steps * rows * (macs(actor) + macs(critic))
    k1 = t * envs * work["k1_ops_per_env_step"]
    parts = {"actor_critic": (rollout + update) / BF16_TC, "k1": k1 / FP32}
    parts["total"] = parts["actor_critic"] + parts["k1"]
    return parts
