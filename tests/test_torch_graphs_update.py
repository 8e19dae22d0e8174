"""The compiled iteration's update on the step, xla and recurrent paths, on
the CPU (``learn/graphs.py``: the update graphs of ``CompiledIteration``;
the mega path's is tests/test_torch_graphs.py's).

The graphs are stood in as in tests/test_torch_graphs.py (section 4: a
replay runs the graph's body again, the streams, events and synchronize are
no-ops), on GR1T1 at 8 envs, decimation 2, 3 steps, 2 minibatches x 1
epoch, and on GR1T1_lstm likewise. The paths: ``lstm`` (the registry's
GR1T1_lstm: ``PPO.update_recurrent``, one grad step's graph replayed
epochs x minibatches times, the step index on the device), ``xla``
(``fused_update = False``: autograd of the loss, the whole update one
graph), ``symmetry`` (``symmetry_coef = 0.5``: the xla path with the mirror
loss), ``step`` (``fused_mega = False``: K2's plain version a grad step,
through the persistent context ``FusedPPOGrad.step_context``), and for the
hygiene also ``remat`` (the xla path under ``remat_update``) and
``lstm_symmetry`` (the recurrent update with the recurrent mirror loss).

1. ``_train_iter`` equals the eager ``iteration`` bit for bit over two
   iterations, with injected noise, u and permutation and with generator
   draws: the Transition, last values, returns, advantages, the state
   (env state, observations, the LSTM memory, the PPO state, the
   generators) and the metrics.
2. Capture hygiene: the second ``_train_iter`` call (every graph's body
   run again after the first call's warm-ups filled the caches: the
   collection, the recurrent collection's memory copy, every grad step and
   the metrics) makes no host copy and reads nothing from the device
   (tests/test_torch_graphs.py's ``host_traffic``); the check catches a
   learning-rate bound made from a host number each step, as the adaptive
   LR once made it.
3. ``remat_update`` checkpoints the loss without keeping the RNG state
   (``preserve_rng_state=False``: the loss draws no random numbers, and a
   capture refuses the read of the CUDA RNG state), with the same gradient
   as without it, bit for bit.
"""

import pytest
import torch
import torch.utils.checkpoint

from test_torch_graphs import _draws, _same, graphs_on_cpu, host_traffic, small  # noqa: F401 (a fixture)
from wiki_grx_gym_tpu_torch.learn.fused_update import _jmax
from wiki_grx_gym_tpu_torch.learn.ppo import PPO

XLA = lambda t: setattr(t.algorithm, "fused_update", False)

PATHS = {
    "lstm": ("GR1T1_lstm", None, "recurrent"),
    "xla": ("GR1T1", XLA, "xla"),
    "symmetry": ("GR1T1", lambda t: setattr(t.algorithm, "symmetry_coef", 0.5), "xla"),
    "step": ("GR1T1", lambda t: setattr(t.algorithm, "fused_mega", False), "step"),
    "remat": ("GR1T1", lambda t: (XLA(t), setattr(t.algorithm, "remat_update", True)), "xla"),
    "lstm_symmetry": ("GR1T1_lstm", lambda t: setattr(t.algorithm, "symmetry_coef", 0.5), "recurrent"),
}


def make(path):
    task, train, want = PATHS[path]
    env, runner = small(task, train_mutate=train)
    assert ("recurrent" if runner.recurrent else runner.alg.path) == want, path
    return env, runner


@pytest.mark.parametrize("draws", ["injected", "generators"])
@pytest.mark.parametrize("path", ["lstm", "step", "symmetry", "xla"])
def test_train_iter_equals_iteration(graphs_on_cpu, path, draws):
    env, runner = make(path)
    s_eager, s_graph = runner.init_state(), runner.init_state()
    for it in range(2):
        kw = dict(zip(("noise", "u", "perm"), _draws(env, runner, it))) if draws == "injected" else {}
        want = {}
        s_eager, m_eager = runner.iteration(s_eager, out=want, **kw)
        s_graph, m_graph = runner._train_iter(s_graph, **kw)
        assert s_graph is runner.compiled.static
        got = runner.compiled.last
        for field in want["batch"]._fields:
            assert torch.equal(getattr(got["batch"], field), getattr(want["batch"], field)), (it, field)
        for k in ("last_values", "returns", "advantages"):
            assert torch.equal(got[k], want[k]), (it, k)
        _same(s_graph, s_eager)   # env state, obs, the new memory, PPOState, the generators
        assert list(m_graph) == list(m_eager)
        for k in m_eager:
            assert torch.equal(m_graph[k], m_eager[k]), (it, k)
    ci = runner.compiled
    assert ci.collect["inject" if draws == "injected" else "draw"].replays == 1
    if path == "lstm":   # one grad step's graph: its warm-up, then a replay a step
        assert ci.update.replays == 2 * ci.steps - 1 and ci.epilogue.replays == 1
        assert int(ci.step_index) == ci.steps
    else:
        assert ci.update.replays == 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_update_has_no_host_traffic(graphs_on_cpu, path, monkeypatch):
    env, runner = make(path)
    state, _ = runner._train_iter(runner.init_state())   # the warm-ups: every cache filled
    with host_traffic(monkeypatch) as calls:
        state, metrics = runner._train_iter(state)
    assert calls == [], sorted(set(calls))
    assert all(torch.isfinite(v) for v in metrics.values())


def test_hygiene_catches_a_host_constant(graphs_on_cpu, monkeypatch):
    def adapt_lr(self, lr, kl_mean):   # the LR's upper bound made from a host number each step
        lr_up = torch.minimum(lr * 1.5, torch.tensor(self.lr_max, device=lr.device))
        return torch.where(kl_mean > self.desired_kl * 2.0, _jmax(lr / 1.5, self.lr_min),
                           torch.where((kl_mean < self.desired_kl / 2.0) & (kl_mean > 0.0), lr_up, lr))

    monkeypatch.setattr(PPO, "_adapt_lr", adapt_lr)
    env, runner = make("xla")
    state, _ = runner._train_iter(runner.init_state())
    with host_traffic(monkeypatch) as calls:
        runner._train_iter(state)
    assert "torch.tensor(device=)" in calls


def test_remat_keeps_no_rng_state(monkeypatch):
    env, runner = make("remat")
    alg = runner.alg
    state = runner.init_state()
    _, batch, _, _, returns, adv = runner._collect(state)
    shuf_w, shuf_f, _ = alg.prepare_update(batch, returns, adv, generator=state.rng)
    mb = PPO.minibatch(shuf_w, shuf_f, env.obs_dim, env.num_actions, 0)
    seen, checkpoint = [], torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **k: seen.append(k) or checkpoint(*a, **k))
    loss, g, _ = alg.loss_and_grad(state.ppo.params, mb)
    assert len(seen) == 1 and seen[0]["preserve_rng_state"] is False and seen[0]["use_reentrant"] is False
    alg.remat_update = False
    loss0, g0, _ = alg.loss_and_grad(state.ppo.params, mb)
    assert len(seen) == 1 and torch.equal(loss, loss0) and torch.equal(g, g0)
