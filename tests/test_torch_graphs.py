"""The compiled iteration on the CPU: what of ``learn/graphs.py`` and its
callers runs without a card.

1. The rule (``OnPolicyRunner.eager_reason``, ``LeggedEnv.step_graph_reason``)
   for each registry task and for the dp, mp, symmetry, step-path, xla-path
   and engine variants, as it reads on a CUDA device: each runner is built
   on the CPU and its device and env backend then set to what the card
   would give (``physics_backend(use_pallas, "cuda")``). Every registry
   task, every update path and the engine backend are compiled, and so
   is dp over NCCL with K1 across ranks, also under the global shuffle
   (``permutation_groups = 1``), and mp with the symmetry loss and on the
   engine's xla path; the CPU, the lane backend (K1's plain version on the
   card), dp and mp over gloo keep their reasons, and so do mp over NCCL
   across ranks on the mega path (not a path of tensor parallelism),
   though its env step is graphed, and the global shuffle with the
   symmetry loss (no run on several cards has held it).
2. Capture hygiene: during ``env.step`` on the plane, heightfield, trimesh,
   heading and full-body configs, on K1 and on the engine, during
   ``spd_solve`` above 48 (``cholesky_ex``), and during ``rollout`` + the last values
   + GAE + ``PPO.prepare_update`` (the block permutation and
   ``_pack_shuffle``), no ``torch.tensor`` / ``torch.as_tensor`` is called
   with a device, no ``torch.from_numpy`` is called, and no ``.item()`` /
   ``.cpu()`` / ``.tolist()`` / ``.numpy()`` / ``bool`` / ``int`` /
   ``float`` of a tensor, no boolean-mask index, no index by a Python list
   or numpy array (a host copy) and no ``Tensor.to(device)`` runs: a CUDA
   graph's capture refuses a host copy and cannot wait for the device. Checked by
   monkeypatching those functions and methods with wrappers that record
   each call. K1's plain version (the lane program) is left out: on the
   card the kernel runs in its place.
3. The static state: ``make_static`` / ``copy_in`` / a copy out of a
   ``RunnerState`` (its ``EnvState`` and ``PPOState``) round trip exactly;
   ``copy_in`` and ``donate`` refuse a mismatched or aliased leaf.
4. The iteration and the env step with the CUDA graphs stood in for: the
   capture records nothing and each replay runs the graph's body again,
   with the graph's spans installed as its capture would record them
   (``Graph._capture`` patched; a mark writes the host's clock,
   ``spans.stamp`` patched), K3's donated update runs its plain
   version over the static state, and the streams, events and synchronize
   are no-ops. This holds the static-state bookkeeping (the copy in, the
   donation, the metrics, the launch tally) to the eager path:
   ``_train_iter`` equals ``iteration`` bit for bit over two iterations
   with injected noise, u and permutation and with generator draws (the
   generators left where the eager ones are), and ``step_graph`` equals
   ``step`` over five steps. The capture itself runs only on the card
   (``tests/test_torch_graphs_cuda.py``, ``chip_smoke.py`` phase 19).
5. The terrain refresh decided on the device (``torch.where`` on
   ``common_step``) against JAX's ``lax.cond`` path on heightfield with
   ``refresh_interval`` 2 over 6 steps, both packages from the same JAX
   state with the same actions and uniform blocks (JAX eager, as
   tests/test_torch_terrain_env.py runs it). Envs 0 and 1 time out at
   steps 0 and 1 (a refresh step and a carry step). Tolerances are
   tests/test_torch_env.py's: rtol 1e-4, atol 1e-5, widened by 3x the
   port's float32 noise floor at that step (the port run again in float64
   from the same state); counters exact.
"""

import contextlib
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_env import as_float64, assert_close_widened, step_block
from test_torch_terrain_env import make_envs, state_to_numpy
from wiki_grx_gym_tpu_torch import build
from wiki_grx_gym_tpu_torch.convert import env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.envs.legged_env import LeggedEnv, physics_backend
from wiki_grx_gym_tpu_torch.learn import graphs, spans
from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
from wiki_grx_gym_tpu_torch.ops import linalg
from wiki_grx_gym_tpu_torch.parallel import mesh
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.sim.cuda_step import CudaDecimation

N, T = 8, 3


def small(task="GR1T1", mutate=None, n=N, train_mutate=None):
    """(env, runner) of ``task`` on the CPU at ``n`` envs, decimation 2, T
    steps, 2 minibatches x 1 epoch."""
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = n
    cfg.control.decimation = 2
    if mutate is not None:
        mutate(cfg)
    train_cfg.runner.num_steps_per_env = T
    train_cfg.algorithm.num_mini_batches = 2
    train_cfg.algorithm.num_learning_epochs = 1
    if train_mutate is not None:
        train_mutate(train_cfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
    return env, runner


# ---------------------------------------------------------------------------
# 1. the rule
# ---------------------------------------------------------------------------

def as_on_card(runner):
    """The runner's rule as it reads on a CUDA device."""
    runner.device = torch.device("cuda")
    runner.env.backend = physics_backend(getattr(runner.env.cfg.sim, "use_pallas", "auto"), "cuda")
    return runner.eager_reason


RULE = {
    "GR1T1": None, "GR1T2": None, "GR1T1_lower_limb": None, "GR1T2_lower_limb": None,
    "GR1T1_full": None, "GR1T2_full": None, "GR1T1_lstm": None,
}


@pytest.mark.parametrize("task", sorted(RULE))
def test_rule_per_registry_task(task):
    n = 25 if task == "GR1T1_lstm" else 4
    _, runner = small(task, n=n)
    reason = as_on_card(runner)
    want = RULE[task]
    assert (reason is None) if want is None else (want in reason), (task, reason)


def _dp(world, mp=False, backend="gloo"):
    """A rank's dp view (with an mp view of 2 if ``mp``) whose groups'
    backend reads ``backend``, on the card."""
    dev = torch.device("cuda")
    tp = mesh.TensorParallel(world=2, rank=0, device=dev, backend=backend) if mp else None
    return mesh.DataParallel(world=world, rank=0, device=dev, mp=tp, backend=backend)


@pytest.mark.parametrize("variant", ["cpu", "dp", "mp", "dp_nccl", "mp_nccl", "symmetry", "step_path", "xla_path",
                                     "engine", "lanes", "bf16", "fused_trunk", "dp_nccl_global",
                                     "dp_nccl_symmetry_global", "mp_nccl_symmetry", "mp_nccl_engine_xla"])
def test_rule_per_variant(variant):
    train = {
        "symmetry": lambda t: setattr(t.algorithm, "symmetry_coef", 0.5),
        "dp_nccl_symmetry_global": lambda t: setattr(t.algorithm, "symmetry_coef", 0.5),
        "mp_nccl_symmetry": lambda t: setattr(t.algorithm, "symmetry_coef", 0.5),
        "mp_nccl_engine_xla": lambda t: setattr(t.algorithm, "fused_update", False),
        "step_path": lambda t: setattr(t.algorithm, "fused_mega", False),
        "xla_path": lambda t: setattr(t.algorithm, "fused_update", False),
        "bf16": lambda t: (setattr(t.policy, "compute_dtype", "bfloat16"),
                           setattr(t.algorithm, "update_dtype", "bfloat16")),
        "fused_trunk": lambda t: setattr(t.algorithm, "fused_trunk", True),
        # the path a dp mesh selects (it turns the mega path off)
        "dp_nccl": lambda t: setattr(t.algorithm, "fused_mega", False),
    }.get(variant)
    sim = {"engine": False, "lanes": "lanes", "mp_nccl_engine_xla": False}.get(variant)
    mutate = (lambda c: setattr(c.sim, "use_pallas", sim)) if sim is not None else None
    env, runner = small(mutate=mutate, train_mutate=train, n=4)
    if variant == "cpu":
        reason = runner.eager_reason
        assert "cpu" in reason and env.step_graph_reason is not None
        return
    if variant.startswith(("dp", "mp")):
        runner.dp = _dp(2, mp=variant.startswith("mp"), backend="gloo" if variant in ("dp", "mp") else "nccl")
    if variant.endswith("_global"):
        # the global shuffle (permutation_groups = 1), PPO built with the
        # dp view as the runner builds it under dp
        runner.alg = PPO(runner.net, runner.alg_cfg, extra_loss_fn=runner.alg.extra_loss_fn, perm_groups=1,
                         dp=runner.dp)
        assert runner.alg.gathered and runner.rule_path.endswith("+global")
    reason = as_on_card(runner)
    # gloo's collectives run on the host: only NCCL's are captured, and
    # across ranks what mesh.COMPILED_COLLECTIONS and COMPILED_UPDATES admit
    # (the runner is built in one process: mp_nccl keeps the mega path,
    # which they do not)
    want = {"dp": "parallelism over gloo", "mp": "parallelism over gloo", "dp_nccl": None,
            "mp_nccl": "tensor parallelism across ranks on the mega path",
            "symmetry": None, "step_path": None, "xla_path": None, "engine": None, "lanes": "'lanes'",
            "bf16": None, "fused_trunk": None, "dp_nccl_global": None,
            "dp_nccl_symmetry_global": None, "mp_nccl_symmetry": None,
            "mp_nccl_engine_xla": None}[variant]
    assert (reason is None) if want is None else (want in reason), (variant, reason)
    # the env step's rule: K1 or the engine on a CUDA device, dp and mp
    # only over NCCL, across ranks where a collection of its layout and
    # backend is held
    env.device = torch.device("cuda")
    env.dp = runner.dp
    step_reason = env.step_graph_reason
    assert (step_reason is None) == (variant not in ("dp", "mp", "lanes")), (variant, step_reason)


# ---------------------------------------------------------------------------
# 2. capture hygiene
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def host_traffic(monkeypatch):
    """Records (in the yielded list) every call that a capture refuses or
    that waits for the device; paused inside K1's plain version."""
    calls, on = [], [True]

    def note(name):
        if on[0]:
            calls.append(name)

    def ctor(fn, name, always=False):
        def wrapped(*a, **k):
            if always or k.get("device") is not None:
                note(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torch, "tensor", ctor(torch.tensor, "torch.tensor(device=)"))
    monkeypatch.setattr(torch, "as_tensor", ctor(torch.as_tensor, "torch.as_tensor(device=)"))
    monkeypatch.setattr(torch, "from_numpy", ctor(torch.from_numpy, "torch.from_numpy", always=True))
    for meth in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, meth)

        def wrapped(self, *a, _orig=orig, _name=meth, **k):
            note(f"Tensor.{_name}")
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, meth, wrapped)
    def check_index(idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(torch.is_tensor(p) and p.dtype == torch.bool for p in parts):
            note("boolean-mask index")
        if any(isinstance(p, (list, np.ndarray)) for p in parts):
            note("host (list or numpy) index")

    getitem, setitem, to = torch.Tensor.__getitem__, torch.Tensor.__setitem__, torch.Tensor.to

    def index(self, idx):
        check_index(idx)
        return getitem(self, idx)

    def assign(self, idx, value):
        check_index(idx)
        return setitem(self, idx, value)

    def move(self, *a, **k):
        if k.get("device") is not None or any(isinstance(x, (str, torch.device)) for x in a):
            note("Tensor.to(device)")
        return to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "__getitem__", index)
    monkeypatch.setattr(torch.Tensor, "__setitem__", assign)
    monkeypatch.setattr(torch.Tensor, "to", move)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: note("Tensor.cuda") or self)
    plain = CudaDecimation.plain

    def paused(self, *a, **k):
        on[0] = False
        try:
            return plain(self, *a, **k)
        finally:
            on[0] = True

    monkeypatch.setattr(CudaDecimation, "plain", paused)
    yield calls


def on_engine(mutate=None):
    """``mutate`` and then the engine backend (``use_pallas = False``)."""
    def engine(cfg):
        if mutate is not None:
            mutate(cfg)
        cfg.sim.use_pallas = False
    return engine


HYGIENE = {
    "plane": ("GR1T1", None),
    "heightfield": ("GR1T1", cuda_step.terrain_config("heightfield", 2, 2)),
    "trimesh": ("GR1T1", cuda_step.terrain_config("trimesh", 2, 2)),
    "heading": ("GR1T1", cuda_step.heading_config),
    "full_body": ("GR1T1_full", None),
    # the engine path: no plain version to pause, every op of the substep recorded
    "engine_plane": ("GR1T1", on_engine()),
    "engine_heightfield": ("GR1T1", on_engine(cuda_step.terrain_config("heightfield", 2, 2))),
    "engine_trimesh": ("GR1T1", on_engine(cuda_step.terrain_config("trimesh", 2, 2))),
    "engine_heading": ("GR1T1", on_engine(cuda_step.heading_config)),
    "engine_full_body": ("GR1T1_full", on_engine()),
}


@pytest.mark.parametrize("config", sorted(HYGIENE))
def test_env_step_has_no_host_traffic(config, monkeypatch):
    task, mutate = HYGIENE[config]

    def decimation_1(cfg):
        if mutate is not None:
            mutate(cfg)
        cfg.control.decimation = 1

    env = cuda_step.task_env(task, 2, "cpu", decimation_1)
    state = env.init_state(0)
    actions = 0.3 * torch.randn(2, env.num_actions, generator=torch.Generator().manual_seed(0))
    state, _ = env.step(state, actions)   # every cache of the env filled
    with host_traffic(monkeypatch) as calls:
        for _ in range(2):   # a refresh step and a carry step on terrain
            state, out = env.step(state, actions)
    assert calls == [], f"{config}: {sorted(set(calls))}"
    assert torch.isfinite(out.obs).all()


def test_large_spd_solve_reads_no_error_code(monkeypatch):
    """Above 48 ``spd_solve`` factors with ``cholesky_ex`` (its ``info``
    unread): the same solution as ``cholesky`` + ``cholesky_solve``, and no
    device value read on the way."""
    n = 49
    rng = np.random.RandomState(0)
    g = rng.randn(3, n, n)
    a = torch.from_numpy((g @ g.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, n).astype(np.float32))
    want = torch.cholesky_solve(b[..., None], torch.linalg.cholesky(a))[..., 0]
    with host_traffic(monkeypatch) as calls:
        got = linalg.spd_solve(a, b)
    assert calls == [], sorted(set(calls))
    assert torch.equal(got, want)


def test_collection_has_no_host_traffic(monkeypatch):
    env, runner = small()
    state = runner.init_state()
    runner.iteration(state)   # every cache filled
    with host_traffic(monkeypatch) as calls:
        rs, batch, acc, last_values, returns, adv = runner._collect(state)
        shuf_w, shuf_f, rows = runner.alg.prepare_update(batch, returns, adv, generator=state.rng)
        runner._collection_sums(rs, acc)
    assert calls == [], sorted(set(calls))
    assert shuf_w.shape[1] == rows


# ---------------------------------------------------------------------------
# 3. the static state
# ---------------------------------------------------------------------------

def _same(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), path
        else:
            assert x is y or x == y, path


@pytest.mark.parametrize("mesh", ["plane", "heightfield"])
def test_static_state_round_trip(mesh):
    mutate = None if mesh == "plane" else cuda_step.terrain_config("heightfield", 2, 2)
    env, runner = small(mutate=mutate, n=4)
    s0 = runner.init_state()
    s1, _ = runner.iteration(runner.init_state())   # other values, same structure
    static = graphs.make_static(s0)
    _same(static, s0)
    tensors = [x for _, x in graphs.leaves(static) if torch.is_tensor(x)]
    assert len({x.untyped_storage().data_ptr() for x in tensors}) == len(tensors)
    assert all(x.is_contiguous() for x in tensors)
    assert static.rng is s0.rng and static.env_state.rng is s0.env_state.rng
    graphs.copy_in(static, s1)
    _same(static, s1)
    assert static.rng is s0.rng   # the static generators keep their identity
    out = graphs.map_tensors(torch.clone, static)   # the copy out
    _same(out, s1)
    graphs.copy_in(static, static)   # the static state itself: nothing to copy
    _same(static, s1)


def test_copy_in_and_donate_refuse_bad_leaves():
    env, runner = small(n=4)
    s = runner.init_state()
    static = graphs.make_static(s)
    with pytest.raises(ValueError, match="obs"):
        graphs.copy_in(static, s.replace(obs=s.obs[:2]))
    with pytest.raises(ValueError, match="episode_length"):
        graphs.copy_in(static, s.replace(env_state=s.env_state.replace(
            episode_length=s.env_state.episode_length.to(torch.int64))))
    # a new leaf that is a view of another static buffer could be overwritten first
    with pytest.raises(ValueError, match="shares memory"):
        graphs.donate(static, static.replace(critic_obs=static.critic_obs.clone(),
                                             obs=static.critic_obs[:, :static.obs.shape[1]]))
    with pytest.raises(ValueError, match="generator"):
        graphs.donate(static, static.replace(rng=torch.Generator()))


def test_launch_tally():
    build.reset_launch_counts()
    build.count_launch("k1")
    with build.capture_tally() as tally:
        build.count_launch("k1")
        build.count_launch("k1")
    assert build.LAUNCHES["k1"] == 1 and tally.counts["k1"] == 2
    seen = []
    tally.after_replay.append(lambda: seen.append(1))
    tally.replayed()
    tally.replayed()
    assert build.LAUNCHES["k1"] == 5 and seen == [1, 1]
    build.reset_launch_counts()


# ---------------------------------------------------------------------------
# 4. the iteration and the step with the graphs stood in for
# ---------------------------------------------------------------------------

class _Replayer:
    """The stand-in of a captured graph: a replay runs the body again."""

    def __init__(self, g):
        self.g = g

    def replay(self):
        with self.g.recording():
            self.g.outputs = self.g._run()


def host_stamp(slots, i):
    """The stand-in of a span's mark: the host's clock (ns) into the slot."""
    slots[i] = time.perf_counter_ns()


class _PlainUpdate:
    """The stand-in of K3's donated update context: its plain version over
    the static p, m and v, in place."""

    def __init__(self, fused, dev, bufs, p, m, v):
        self.fused, self.p, self.m, self.v = fused, p, m, v
        self.steps = fused.num_epochs * fused.num_mini_batches
        self.graph = self.epilogue = None
        self.capture_ms = self.instantiate_ms = self.nodes = None
        self._out = None

    def stage_inputs(self, fused, count, lr, bufs):
        self.count, self.lr = count.clone(), lr.clone()
        self.bufs = {k: x.clone() for k, x in bufs.items()}
        if self._out is None:
            self._out = (self.lr, {k: torch.zeros(()) for k in ("value_loss", "surrogate_loss", "kl")})

    def capture(self, fused, epilogue=None):
        self.graph, self.epilogue = True, epilogue

    def replay(self):
        p2, m2, v2, lr, metrics = self.fused.update_scan_plain(self.p, self.m, self.v, self.count, self.lr,
                                                               self.bufs)
        for dst, src in ((self.p, p2), (self.m, m2), (self.v, v2)):
            dst.copy_(src)
        self._out = (lr, {k: metrics[k] for k in ("value_loss", "surrogate_loss", "kl")})
        self.epilogue()

    def outputs(self):
        return self._out


class _NoStream:
    def wait_stream(self, other):
        pass


class _NoEvent:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def stand_in_graphs(monkeypatch):
    """The CUDA graphs stood in on the CPU (section 4 of the docstring)."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _NoStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    monkeypatch.setattr(spans, "stamp", host_stamp)

    def capture(self):
        self.tally, self.graph = build.LaunchTally(), _Replayer(self)

    monkeypatch.setattr(graphs.Graph, "_capture", capture)
    monkeypatch.setattr(FusedPPOGrad, "donated_update",
                        lambda self, dev, bufs, p, m, v: _PlainUpdate(self, dev, bufs, p, m, v))
    monkeypatch.setattr(OnPolicyRunner, "eager_reason", property(lambda self: None))
    monkeypatch.setattr(LeggedEnv, "step_graph_reason", property(lambda self: None))


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    stand_in_graphs(monkeypatch)


def _draws(env, runner, it):
    rng = np.random.RandomState(10 + it)
    t, n, a = runner.num_steps_per_env, env.num_envs, env.num_actions
    noise = torch.from_numpy(rng.randn(t, n, a).astype(np.float32))
    u = torch.from_numpy(rng.rand(t, n, env._step_u_cols[1]).astype(np.float32))
    if runner.recurrent:   # env columns
        n_blocks, used = n, runner.alg.recurrent_geometry(n)[1]
    else:
        _, n_blocks, used, _ = runner.alg.shuffle_geometry(t, n)
    perm = torch.from_numpy(rng.permutation(n_blocks)[:used])
    return noise, u, perm


@pytest.mark.parametrize("draws", ["injected", "generators"])
def test_train_iter_equals_iteration(graphs_on_cpu, draws):
    env, runner = small()
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
        _same(s_graph, s_eager)   # env state, obs, PPOState, the generators' seeds and offsets
        assert list(m_graph) == list(m_eager)
        for k in m_eager:
            assert torch.equal(m_graph[k], m_eager[k]), (it, k)
    mode = "inject" if draws == "injected" else "draw"
    assert runner.compiled.collect[mode].replays == 1   # the first call warmed up, the second replayed


def test_learn_runs_train_iter(graphs_on_cpu, capsys):
    env, runner = small()
    calls = []
    train_iter = runner._train_iter
    runner._train_iter = lambda state: calls.append(1) or train_iter(state)
    runner.learn(2)
    assert len(calls) == 2 and "compiled" in capsys.readouterr().out
    assert set(runner.log_history[-1]["metrics"]) >= {"value_loss", "lr", "mean_step_reward"}


def test_step_graph_equals_step(graphs_on_cpu):
    env, runner = small(n=4)
    s_eager = runner.init_state().env_state
    s_graph = env.init_state(runner.rank_seed)   # same values, its own generator
    s_graph = env.step(s_graph, torch.zeros(4, env.num_actions))[0]
    g = torch.Generator().manual_seed(5)
    for t in range(5):
        actions = 0.3 * torch.randn(4, env.num_actions, generator=g)
        s_eager, o_eager = env.step(s_eager, actions)
        s_graph, o_graph = env.step_graph(s_graph, actions)
        _same(s_graph, s_eager)
        for name in ("obs", "pri_obs", "rew", "reset"):
            assert torch.equal(getattr(o_graph, name), getattr(o_eager, name)), (t, name)
    graph = env._step_graphs[((4, env.num_actions), torch.float32)]
    assert graph.graph.replays == 4 and s_graph is graph.static


# ---------------------------------------------------------------------------
# 5. the refresh decision against JAX's lax.cond
# ---------------------------------------------------------------------------

REFRESH_STEPS = 6


def test_refresh_on_the_device_matches_lax_cond():
    jenv, tenv = make_envs("heightfield")
    assert tenv.refresh_interval == jenv.refresh_interval == 2
    n = tenv.num_envs
    rng = np.random.RandomState(3)
    jenv._default_point_rel
    jenv.terrain._block_pyramid
    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(1))
    with jax.disable_jit():
        ml = jenv.max_episode_length
        js = js.replace(episode_length=jax.numpy.asarray([ml, ml - 1, 3, 7][:n], jax.numpy.int32))
        ts = env_state_from_numpy(state_to_numpy(js))
        ts64 = env_state_from_numpy(as_float64(state_to_numpy(js)))
        phases = []
        for t in range(REFRESH_STEPS):
            a = (rng.randn(n, jenv.num_actions) * 0.5).astype(np.float32)
            u = step_block(jenv, js)
            phases.append(int(np.asarray(js.common_step)) % 2)
            js, jo = jenv.step(js, jax.numpy.asarray(a))
            ts, to = tenv.step(ts, torch.from_numpy(a), u=torch.from_numpy(u))
            ts64, to64 = tenv.step(ts64, torch.from_numpy(a).double(), u=torch.from_numpy(u).double())
            jd = state_to_numpy(js)
            np.testing.assert_array_equal(ts.common_step.numpy(), jd["common_step"])
            np.testing.assert_array_equal(to.reset.numpy(), np.asarray(jo.reset), err_msg=f"step {t}")
            for k in ("measured_cache", "ground_plane"):
                assert_close_widened(getattr(ts, k).numpy(), jd[k], getattr(ts64, k).numpy(),
                                     err_msg=f"{k} step {t}")
            for k in ("obs", "pri_obs", "rew"):
                assert_close_widened(getattr(to, k).numpy(), np.asarray(getattr(jo, k)),
                                     getattr(to64, k).numpy(), err_msg=f"{k} step {t}")
    assert phases == [0, 1, 0, 1, 0, 1]   # refresh, carry, ... from common_step 0
