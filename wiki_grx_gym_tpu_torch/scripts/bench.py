"""Headline benchmark of the port (port of the root ``bench.py``): training
throughput of a whole PPO iteration on GR1T1.

    python -m wiki_grx_gym_tpu_torch.scripts.bench              # the card: main, envs8192
    python -m wiki_grx_gym_tpu_torch.scripts.bench --full       # + five more cells
    python -m wiki_grx_gym_tpu_torch.scripts.bench --device cpu # main only, 256 envs, 3 iterations

The metric is the reference's FPS (``rsl_rl/runners/on_policy_runner.py:235,242``):
``num_steps_per_env * num_envs / (collection_time + learning_time)``, env
steps per wall-clock second with the PPO update included.

As the root bench times the compiled ``runner._train_iter`` and a jitted
rollout (``bench.py:108-134``), a cell whose config the runner compiles
(``OnPolicyRunner.eager_reason`` is None: GR1T1, the subset, terrain, the
full body) times ``_train_iter`` (two CUDA graph replays) and
``_rollout_graph``; the others (the LSTM, the CPU) time the eager
``iteration`` and ``rollout``.

On the card: ``main`` (GR1T1 at 4096 envs, 30 timed iterations) and
``envs8192`` (the reference's default env count, ``envs/gr1t1_config.py``, 15
iterations); ``--full`` adds ``ref_equiv_subset`` (viscous friction, no
self-collision), ``heightfield``, ``trimesh``, ``full_body`` (GR1T1_full) and
``lstm`` (GR1T1_lstm) at 4096 envs, 15 iterations each. Without a card the
default run exits with an error; it never falls back to the CPU.

The earlier lines of the output name the device (the card's name and power
limit, as ``nvidia-smi`` gives them) and each cell's per-iteration
wall-clock times, each ended by a synchronize (min / median / max; host
times vary between calls). The last line is one JSON object with the root
``bench.py``'s keys; ``platform`` is ``cuda`` or ``cpu`` and the MFU share
is against the H100's dense bf16 peak (null on the CPU, where no device is
timed).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

BASELINE_ENV_STEPS_PER_S = 100_000.0
H100_BF16_PEAK = 989e12   # FLOP/s, one H100 SXM, dense bf16 (NVIDIA's data sheet)


def _mlp_flops(dims):
    return 2 * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def flops_per_iteration(env, runner):
    """Analytic FLOPs of one PPO iteration from static shapes (matmul 2mnk
    convention; physics counted as ~10k scalar FLOPs per env-substep); the
    root ``bench.py``'s formula."""
    t, n = runner.num_steps_per_env, env.num_envs
    pcfg = runner.policy_cfg
    actor = _mlp_flops([env.obs_dim] + list(pcfg.actor_hidden_dims) + [env.num_actions])
    critic = _mlp_flops([env.pri_obs_dim] + list(pcfg.critic_hidden_dims) + [1])
    if getattr(pcfg, "rnn_type", None):  # LSTM memory ahead of each head
        h, nl = pcfg.rnn_hidden_size, pcfg.rnn_num_layers
        cell = 2 * 4 * h * (env.obs_dim + h) + (nl - 1) * 2 * 4 * h * (2 * h)
        cell_c = 2 * 4 * h * (env.pri_obs_dim + h) + (nl - 1) * 2 * 4 * h * (2 * h)
        actor += cell
        critic += cell_c
    rollout = t * n * (actor + 2 * critic)   # act + evaluate + last_values amortized
    alg = runner.alg
    samples = alg.num_learning_epochs * (t * n)
    update = samples * 3 * (actor + critic)  # fwd + bwd (~2x fwd)
    physics = t * n * env.decimation * 10_000
    return rollout + update + physics


def ref_equiv_subset(cfg):
    """The reference-equivalent contact subset (root ``bench.py:98-102``):
    viscous friction (no anchored stick spring) and no self-collision."""
    cfg.sim.contact_tangent_stiffness = 0.0
    cfg.asset.self_collisions = -1


def build_run(num_envs, subset=False, device="cuda", task="GR1T1", mesh_type=None, train_hook=None,
              env_hook=None):
    """(env, runner, state) of one cell through the registry's entry points,
    the state from ``init_state(init_at_random_ep_len=True)``."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    env_cfg, train_cfg = task_registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    if train_hook is not None:
        train_hook(train_cfg)
    if env_hook is not None:
        env_hook(env_cfg)
    if mesh_type is not None:
        env_cfg.terrain.mesh_type = mesh_type
        env_cfg.terrain.curriculum = True
    if subset:
        ref_equiv_subset(env_cfg)
    env, _ = task_registry.make_env(task, env_cfg=env_cfg, device=device)
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
    return env, runner, runner.init_state(init_at_random_ep_len=True)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_config(num_envs, iters, subset=False, device="cuda", task="GR1T1", mesh_type=None,
                 train_hook=None, env_hook=None):
    """One cell: :func:`build_run`, then :func:`time_run`. Returns the
    latter's result."""
    env, runner, state = build_run(num_envs, subset, device, task, mesh_type, train_hook, env_hook)
    return time_run(env, runner, state, iters, device)[0]


# the untimed calls of time_run: one iteration before the timed ones, two
# rollouts before the timed rollouts
WARMUP_ITERATIONS = 1
WARMUP_ROLLOUTS = 2


def rollout_count(iters):
    """The timed rollouts of a cell of ``iters`` timed iterations."""
    return max(iters // 2, 5)


def time_run(env, runner, state, iters, device="cuda"):
    """Times one cell's run: ``WARMUP_ITERATIONS`` untimed iteration (on
    the card it builds the kernels and captures the update's CUDA graph),
    ``iters`` timed iterations (each fed the state the last returned, each
    ended by a synchronize on the card, so that each time is that
    iteration's own), then the rollout alone after ``WARMUP_ROLLOUTS``
    untimed calls, ``rollout_count(iters)`` times. Returns (result, the last
    iteration's state): env-steps/s, the mean iteration, collection and
    learn ms, each timed iteration's ms, whether K1 ran (``pallas``), the
    FLOPs of an iteration and, on the card, their share of the H100's bf16
    peak (None on the CPU: no device was timed), the iterations and
    rollouts run in all (``calls``), the path (``graphed``, or ``eager``
    and why) and, graphed, each graph's warm-up, capture and instantiate
    times (``graphs``). Graphed, the first iteration and the first rollout
    are the graphs' warm-ups and captures."""
    import torch

    num_envs = env.num_envs
    why = runner.eager_reason
    step = runner.iteration if why else runner._train_iter
    roll = runner.rollout if why else runner._rollout_graph
    for _ in range(WARMUP_ITERATIONS):
        state, _ = step(state)
    _sync(device)
    each = []
    for _ in range(iters):
        t = time.perf_counter()
        state, _ = step(state)
        _sync(device)
        each.append(time.perf_counter() - t)
    iter_time = sum(each) / iters
    result = {
        "fps": runner.num_steps_per_env * num_envs / iter_time,
        "iter_ms": iter_time * 1e3,
        "iter_ms_each": [s * 1e3 for s in each],
        "pallas": env.backend == "kernel",
        "path": f"eager ({why})" if why else "graphed",
    }

    # collection/learn split (on_policy_runner.py:235-244 parity): time the
    # rollout alone; learn = iteration - collection
    for _ in range(WARMUP_ROLLOUTS):
        roll(state)
    _sync(device)
    n_coll = rollout_count(iters)
    t0 = time.perf_counter()
    for _ in range(n_coll):
        roll(state)
    _sync(device)
    coll_time = (time.perf_counter() - t0) / n_coll
    result["collection_ms"] = coll_time * 1e3
    result["learn_ms"] = max(iter_time - coll_time, 0.0) * 1e3

    flops = flops_per_iteration(env, runner)
    result["flops_per_iter"] = flops
    on_card = torch.device(device).type == "cuda"
    result["mfu_vs_bf16_peak"] = flops / iter_time / H100_BF16_PEAK if on_card else None
    result["calls"] = {"iterations": WARMUP_ITERATIONS + iters, "rollouts": WARMUP_ROLLOUTS + n_coll}
    result["graphs"] = [] if why else runner.compiled.reports()
    return result, state


def cell_summary(r):
    """One cell's entry of the JSON line (the root ``bench.py``'s keys)."""
    return {
        "env_steps_per_s": round(r["fps"], 1),
        "iter_ms": round(r["iter_ms"], 2),
        "collection_ms": round(r["collection_ms"], 2),
        "learn_ms": round(r["learn_ms"], 2),
        "pallas_kernel": r["pallas"],
        "flops_per_iter": r["flops_per_iter"],
        "mfu_vs_h100_bf16_peak": None if r["mfu_vs_bf16_peak"] is None else round(r["mfu_vs_bf16_peak"], 4),
    }


def result_line(breakdown, num_envs, iters, platform):
    """The JSON object of the last line: the headline from ``main``."""
    fps = breakdown["main"]["fps"]
    return {
        "metric": "gr1t1_train_env_steps_per_s",
        "value": round(fps, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(fps / BASELINE_ENV_STEPS_PER_S, 3),
        "config": {
            "num_envs": num_envs,
            "num_steps_per_env": 64,
            "platform": platform,
            "physics_substeps_per_env_step": 10,
            "contact_fidelity": "full (self-collision + stick friction)",
            "iters_timed": iters,
        },
        "breakdown": {k: cell_summary(v) for k, v in breakdown.items()},
    }


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cells(on_card, full=False):
    """[(name, bench_config keywords)] of a run: on the card ``main`` (4096
    envs, 30 timed iterations) and ``envs8192``, with ``full`` the terrain
    and model matrix too (root ``bench.py:147-172``); on the CPU ``main``
    alone at 256 envs and 3 iterations."""
    n_main = 4096 if on_card else 256
    iters = 30 if on_card else 3
    half = max(iters // 2, 10)
    out = [("main", dict(num_envs=n_main, iters=iters))]
    if on_card:
        out.append(("envs8192", dict(num_envs=8192, iters=half)))
    if on_card and full:
        out += [
            ("ref_equiv_subset", dict(num_envs=n_main, iters=half, subset=True)),
            # terrain modes (the reference's curriculum path and the trimesh
            # stair-riser semantics, terrain_utils.py:286-361)
            ("heightfield", dict(num_envs=n_main, iters=half, mesh_type="heightfield")),
            ("trimesh", dict(num_envs=n_main, iters=half, mesh_type="trimesh")),
            # model-family matrix: the 32-DOF full body and the recurrent policy
            ("full_body", dict(num_envs=n_main, iters=half, task="GR1T1_full")),
            ("lstm", dict(num_envs=n_main, iters=half, task="GR1T1_lstm")),
        ]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the terrain / model matrix as well (slower)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False (pass --device cpu for the CPU run)")
    print(f"bench: device {card_line() if on_card else 'cpu'}", flush=True)
    cell_list = cells(on_card, args.full)
    n_main, iters = cell_list[0][1]["num_envs"], cell_list[0][1]["iters"]
    breakdown = {}
    for name, kw in cell_list:
        r = bench_config(device=args.device, **kw)
        each = r["iter_ms_each"]
        graphs = "".join(f"; {g['name']} captured in {g['capture_ms']:.1f} ms, instantiated in "
                         f"{g['instantiate_ms']:.1f} ms" for g in r["graphs"])
        print(f"bench: {name}: {kw['num_envs']} envs, {kw['iters']} timed iterations, {r['path']}{graphs}: "
              f"iteration ms min {min(each):.2f} / median {statistics.median(each):.2f} / max {max(each):.2f}; "
              f"collection {r['collection_ms']:.2f} ms; {r['fps']:.1f} env-steps/s", flush=True)
        breakdown[name] = r
    print(json.dumps(result_line(breakdown, n_main, iters, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
