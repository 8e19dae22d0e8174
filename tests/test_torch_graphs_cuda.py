"""The compiled iteration on the card (``learn/graphs.py``,
``OnPolicyRunner._train_iter``): at 64 envs, the training configs
otherwise: GR1T1 (the mega path, K3), GR1T1_lstm (the recurrent update:
one grad step's graph replayed), and GR1T1 on the step path
(``fused_mega = False``: K2 a grad step) and the xla path
(``fused_update = False``), each update one graph; GR1T1 on the engine
(``use_pallas = False``: the per-step collection, one rollout step's graph
replayed T times with the step index on the device, then the collection's
tail).

- ``_train_iter`` against the eager ``iteration`` with injected noise, u
  and permutation, over three calls (the first warms up and captures, the
  next two replay the donated state): the Transition's nine fields, the
  last values, returns and advantages, the env state (and the LSTM
  memory), the PPO state and the metrics, bit for bit.
- A capture that fails raises, and nothing runs eagerly in its place: a
  host read (``.item()``) planted in the collection makes the capture
  fail; the call raises, no graph is kept, and the launch counts show only
  the warm-up's launches. Likewise a host read planted in the recurrent
  grad step: the update's capture raises, no graph is kept, and the grad
  step ran once (its warm-up); and one planted in the engine's env step:
  the rollout step's capture raises, no graph is kept, and the step ran
  once (its warm-up).

Needs a CUDA card (a CUDA graph has no CPU mode; on the CPU the graphs'
bookkeeping is held to the eager path by tests/test_torch_graphs.py).
Marked ``gpu``; elsewhere each test skips. On the card, from the
checkout's root:

    python -m pytest --noconftest -m gpu -q tests/test_torch_graphs_cuda.py
"""

import pytest
import torch

from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn import graphs

pytestmark = pytest.mark.gpu

N = 64


CONFIGS = {
    "GR1T1": ("GR1T1", None),
    "GR1T1_lstm": ("GR1T1_lstm", None),
    "step_path": ("GR1T1", lambda t: setattr(t.algorithm, "fused_mega", False)),
    "xla_path": ("GR1T1", lambda t: setattr(t.algorithm, "fused_update", False)),
    "GR1T1_engine": ("GR1T1", None),
}
ENGINE = {"GR1T1_engine"}   # use_pallas = False


def make_runner(config="GR1T1"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and K1-K3 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    task, train = CONFIGS[config]
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N
    if config in ENGINE:
        cfg.sim.use_pallas = False
    if train is not None:
        train(train_cfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cuda")
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
    assert runner.eager_reason is None
    return runner


@pytest.fixture
def runner():
    return make_runner()


def draws(runner, seed):
    env, t = runner.env, runner.num_steps_per_env
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((t, N, env.num_actions), generator=g, device="cuda")
    u = torch.rand((t, N, env._step_u_cols[1]), generator=g, device="cuda")
    if runner.recurrent:   # env columns
        n_blocks, used = N, runner.alg.recurrent_geometry(N)[1]
    else:
        _, n_blocks, used, _ = runner.alg.shuffle_geometry(t, N)
    return noise, u, torch.randperm(n_blocks, generator=g, device="cuda")[:used]


def bits(x):
    return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]) \
        if x.is_floating_point() else x


def assert_same(got, want, what):
    for (path, x), (_, y) in zip(graphs.leaves(got), graphs.leaves(want)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), f"{what}: {path}"
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), f"{what}: {path}"


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_iter_equals_iteration_bit_for_bit(config):
    runner = make_runner(config)
    s_e, s_g = runner.init_state(), runner.init_state()
    for it in range(3):
        noise, u, perm = draws(runner, 100 + it)
        want = {}
        s_e, m_e = runner.iteration(s_e, noise=noise, u=u, perm=perm, out=want)
        s_g, m_g = runner._train_iter(s_g, noise=noise, u=u, perm=perm)
        assert s_g is runner.compiled.static
        assert_same({k: runner.compiled.last[k] for k in want}, want, f"call {it}")
        assert_same(s_g, s_e, f"call {it} state")
        assert list(m_g) == list(m_e)
        assert all(torch.equal(bits(m_g[k]), bits(m_e[k])) for k in m_e), it
    per_call = runner.num_steps_per_env if config in ENGINE else 1   # the engine: A1 replayed T times a call
    assert runner.compiled.collect["inject"].replays == 3 * per_call - 1


def test_a_failed_capture_raises_and_nothing_runs_instead(runner, monkeypatch):
    sums = runner._collection_sums

    def reads_the_device(rs, acc):
        out = sums(rs, acc)
        out[0].item()   # a host read: refused inside a capture
        return out

    monkeypatch.setattr(runner, "_collection_sums", reads_the_device)
    state = runner.init_state()
    reset_launch_counts()
    with pytest.raises(RuntimeError):
        runner._train_iter(state)
    graph = runner.compiled.collect["draw"]
    assert graph.graph is None and graph.replays == 0
    # the warm-up's launches (one collection), no second run of the body
    assert LAUNCHES["k1"] == runner.num_steps_per_env and LAUNCHES["k3"] == 0


def test_a_failed_update_capture_raises_and_nothing_runs_instead(monkeypatch):
    runner = make_runner("GR1T1_lstm")
    alg = runner.alg
    grad = alg.recurrent_grad
    calls = []

    def reads_the_device(p, mb):
        calls.append(1)
        loss, g, aux = grad(p, mb)
        loss.item()   # a host read: refused inside a capture
        return loss, g, aux

    monkeypatch.setattr(alg, "recurrent_grad", reads_the_device)
    with pytest.raises(RuntimeError):
        runner._train_iter(runner.init_state())
    update = runner.compiled.update
    assert update.graph is None and update.replays == 0
    assert calls == [1, 1]   # the warm-up's grad step, then the capture's (refused), no other


def test_a_failed_engine_step_capture_raises_and_nothing_runs_instead(monkeypatch):
    runner = make_runner("GR1T1_engine")
    env = runner.env
    step = env.step
    calls = []

    def reads_the_device(state, actions, u=None):
        calls.append(1)
        state, out = step(state, actions, u=u)
        out.rew[0].item()   # a host read: refused inside a capture
        return state, out

    state = runner.init_state()
    monkeypatch.setattr(env, "step", reads_the_device)
    reset_launch_counts()
    with pytest.raises(RuntimeError):
        runner._train_iter(state)
    graph = runner.compiled.collect["draw"]
    assert graph.graph is None and graph.replays == 0 and not runner.compiled.tail["draw"].replays
    assert calls == [1, 1]   # the warm-up's step, then the capture's (refused), no other
    assert LAUNCHES["k1"] == 0
