"""The spans inside the compiled collection on the card (``learn/spans.py``):

- the mark itself: two stamps captured in a CUDA graph around a matrix
  product, replayed, read the product's time as CUDA events around the
  replay read it (the stamps are one-thread ``%globaltimer`` kernels);
- at 512 envs, GR1T1 and GR1T1_full compiled with injected draws over three
  iterations: the first (the warm-up and the captures) holds no phase; in
  the second and third the six phases are each > 0 and sum to within 0.5%
  of ``collection_s``, and in the third (under ``torch.profiler``) ``k1_s``
  is at least the traced time of K1's ``decimation_team_kernel``.

Each test prints what it read. Needs a CUDA card; marked ``gpu``, elsewhere
each test skips. On the card, from the checkout's root:

    python -m pytest --noconftest -m gpu -q -s tests/test_torch_spans_cuda.py
"""

import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn import spans

pytestmark = pytest.mark.gpu

N = 512
PHASE_KEYS = [f"{p}_s" for p in spans.PHASES]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the marks are CUDA kernels in a CUDA graph")


def test_stamps_time_a_replayed_graph():
    needs_card()
    slots = torch.zeros(3, dtype=torch.int64, device="cuda")
    x = torch.randn(4096, 4096, device="cuda")
    y = torch.empty_like(x)
    spans.stamp(slots, 0)   # the library loaded before the capture
    torch.mm(x, x, out=y)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        spans.stamp(slots, 1)
        for _ in range(20):
            torch.mm(x, x, out=y)
        spans.stamp(slots, 2)
    for _ in range(3):
        slots.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        events_ms = a.elapsed_time(b)
        t = slots.tolist()
        stamps_ms = (t[2] - t[1]) / 1e6
        print(f"[spans probe] torch {torch.__version__}: 20 products {stamps_ms:.4f} ms by the stamps, "
              f"{events_ms:.4f} ms by events around the replay")
        assert t[0] == 0 and t[1] > 0 and 0.9 * events_ms < stamps_ms <= events_ms


def make_runner(task):
    needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cuda")
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
    assert runner.eager_reason is None and env.backend == "kernel"
    return runner


def draws(runner, seed):
    env, t = runner.env, runner.num_steps_per_env
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((t, N, env.num_actions), generator=g, device="cuda")
    u = torch.rand((t, N, env._step_u_cols[1]), generator=g, device="cuda")
    _, n_blocks, used, _ = runner.alg.shuffle_geometry(t, N)
    return noise, u, torch.randperm(n_blocks, generator=g, device="cuda")[:used]


def k1_kernel_s(prof) -> float:
    total_us = 0.0
    for e in prof.key_averages():
        if "decimation_team_kernel" in e.key:
            total_us += getattr(e, "device_time_total", None) or e.cuda_time_total
    return total_us / 1e6


@pytest.mark.parametrize("task", ["GR1T1", "GR1T1_full"])
def test_spans_tile_the_collection(task):
    from torch.profiler import ProfilerActivity, profile

    runner = make_runner(task)
    state = runner.init_state()
    for it in range(3):
        noise, u, perm = draws(runner, 300 + it)
        if it == 2:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, _ = runner._train_iter(state, noise=noise, u=u, perm=perm)
        else:
            state, _ = runner._train_iter(state, noise=noise, u=u, perm=perm)
        t = dict(runner.last_timing)
        print(f"[spans {task} {N} envs, call {it}] " + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in t.items()))
        if it == 0:   # the warm-up and the captures: no replay, no marks
            assert list(t) == ["collection_s", "update_s", "launch_s"]
            continue
        assert list(t) == ["collection_s", "update_s", *PHASE_KEYS, "launch_s"]
        total = sum(t[k] for k in PHASE_KEYS)
        print(f"[spans {task}, call {it}] the six phases {total * 1e3:.4f} ms, collection_s "
              f"{t['collection_s'] * 1e3:.4f} ms ({100 * (total / t['collection_s'] - 1):+.4f}%)")
        assert abs(total - t["collection_s"]) <= 0.005 * t["collection_s"]
        assert all(t[k] > 0 for k in PHASE_KEYS) and t["launch_s"] > 0
    k1 = k1_kernel_s(prof)
    print(f"[spans {task}, call 2] k1_s {t['k1_s'] * 1e3:.4f} ms, decimation_team_kernel traced {k1 * 1e3:.4f} ms")
    assert k1 > 0 and t["k1_s"] >= k1
