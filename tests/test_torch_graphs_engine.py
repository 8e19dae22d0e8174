"""The compiled iteration on the engine path, on the CPU
(``learn/graphs.py``: ``CompiledIteration``'s per-step collection, A1 one
rollout step's graph replayed T times with the step index on the device,
then A2 the collection's tail; ``LeggedEnv.step_graph`` on the engine).

The graphs are stood in as in tests/test_torch_graphs.py (section 4: a
replay runs the graph's body again, K3's donated update runs its plain
version, the streams, events and synchronize are no-ops), with
``cfg.sim.use_pallas = False`` (the engine), at 4 envs, decimation 2, 3
steps, 2 minibatches x 1 epoch: GR1T1 (the mega update) and GR1T1_lstm (the
recurrent A1: the memory of reset envs masked each step, the start memory
copied before the first replay).

1. ``_train_iter`` equals the eager ``iteration`` bit for bit over two
   iterations, with injected noise, u and permutation and with generator
   draws: the Transition, the acc sums, last values, returns, advantages,
   the state (env state, observations, the LSTM memory, the PPO state, the
   generators) and the metrics. A1 is replayed T - 1 times a call after
   its warm-up and capture, A2 once a call after its own.
2. A planted fault: A1 replayed without advancing its device index (every
   step stored at row 0 and, injected, reading row 0's noise and u) must
   fail 1's check.
3. ``step_graph`` equals ``step`` over five engine steps.
4. Capture hygiene of the per-step collection: the second ``_train_iter``
   call (A1's and A2's bodies run again after the first call's warm-ups
   filled the caches) makes no host copy and reads nothing from the device
   (tests/test_torch_graphs.py's ``host_traffic``).
"""

import pytest
import torch

from test_torch_graphs import _draws, _same, graphs_on_cpu, host_traffic, on_engine, small  # noqa: F401 (a fixture)
from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration

N = 4
TASKS = {"mega": "GR1T1", "recurrent": "GR1T1_lstm"}


def make(path, n=N):
    env, runner = small(TASKS[path], mutate=on_engine(), n=n)
    assert env.backend == "engine"
    assert ("recurrent" if runner.recurrent else runner.alg.path) == path
    return env, runner


def compare(env, runner, draws, iterations=2):
    """The per-call differences of ``_train_iter`` against ``iteration``."""
    s_eager, s_graph = runner.init_state(), runner.init_state()
    out = []
    for it in range(iterations):
        kw = dict(zip(("noise", "u", "perm"), _draws(env, runner, it))) if draws == "injected" else {}
        want = {}
        s_eager, m_eager = runner.iteration(s_eager, out=want, **kw)
        s_graph, m_graph = runner._train_iter(s_graph, **kw)
        assert s_graph is runner.compiled.static and runner.compiled.per_step
        got = runner.compiled.last
        d = [f"batch.{f}" for f in want["batch"]._fields
             if not torch.equal(getattr(got["batch"], f), getattr(want["batch"], f))]
        d += [f"acc.{k}" for k in want["acc"] if not torch.equal(got["acc"][k], want["acc"][k])]
        d += [k for k in ("last_values", "returns", "advantages") if not torch.equal(got[k], want[k])]
        d += [f"metric {k}" for k in m_eager if not torch.equal(m_graph[k], m_eager[k])]
        try:
            _same(s_graph, s_eager)   # env state, obs, memory, PPOState, the generators
        except AssertionError as e:
            d.append(f"state {e}")
        out.append(d)
    return out


@pytest.mark.parametrize("draws", ["injected", "generators"])
@pytest.mark.parametrize("path", sorted(TASKS))
def test_per_step_train_iter_equals_iteration(graphs_on_cpu, path, draws):
    env, runner = make(path)
    assert compare(env, runner, draws) == [[], []]
    ci = runner.compiled
    mode = "inject" if draws == "injected" else "draw"
    t = runner.num_steps_per_env
    assert ci.collect[mode].replays == 2 * t - 1 and ci.tail[mode].replays == 1
    assert int(ci.rollout_index) == 0 and all(not v.any() for v in ci.acc.values())


@pytest.mark.parametrize("draws", ["injected", "generators"])
def test_index_not_advanced_is_caught(graphs_on_cpu, monkeypatch, draws):
    monkeypatch.setattr(CompiledIteration, "_advance_rollout", lambda self: None)
    env, runner = make("mega")
    diffs = compare(env, runner, draws, iterations=1)[0]
    assert any(d.startswith("batch.") for d in diffs), diffs


def test_engine_step_graph_equals_step(graphs_on_cpu):
    env, runner = make("mega")
    s_eager = runner.init_state().env_state
    s_graph = env.init_state(runner.rank_seed)   # same values, its own generator
    s_graph = env.step(s_graph, torch.zeros(N, env.num_actions))[0]
    g = torch.Generator().manual_seed(5)
    for t in range(5):
        actions = 0.3 * torch.randn(N, env.num_actions, generator=g)
        s_eager, o_eager = env.step(s_eager, actions)
        s_graph, o_graph = env.step_graph(s_graph, actions)
        _same(s_graph, s_eager)
        for name in ("obs", "pri_obs", "rew", "reset"):
            assert torch.equal(getattr(o_graph, name), getattr(o_eager, name)), (t, name)
    graph = env._step_graphs[((N, env.num_actions), torch.float32)]
    assert graph.graph.replays == 4 and s_graph is graph.static


@pytest.mark.parametrize("path", sorted(TASKS))
def test_per_step_collection_has_no_host_traffic(graphs_on_cpu, monkeypatch, path):
    env, runner = make(path)
    state = runner.init_state()
    state, _ = runner._train_iter(state)   # the warm-ups and captures: every cache filled
    with host_traffic(monkeypatch) as calls:
        runner._train_iter(state)
    assert calls == [], sorted(set(calls))
