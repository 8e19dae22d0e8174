"""The compiled iteration under data and tensor parallelism, on the CPU
(``learn/graphs.py`` under ``parallel/mesh.py``'s groups).

On the card the dp and mp iteration is compiled over NCCL, whose
collectives a CUDA graph captures; gloo's run on the host and cannot be.

(a) The rule (``OnPolicyRunner.eager_reason``, ``LeggedEnv.step_graph_reason``)
    as it reads on a CUDA device (tests/test_torch_graphs.py's
    ``as_on_card``), for a dp view and for a dp view with its mp view, over
    a real in-process gloo group of one rank: with the backend read from
    the group (gloo) both keep a reason naming it; with the backend name
    patched to ``nccl`` (``dist.get_backend``, while the views are made)
    both are None, on K1 and on the engine, on every update path (mega,
    step, xla, the symmetry loss, the recurrent update). The CPU and the
    ``"lanes"`` backend keep their reasons. Across ranks over NCCL (views
    of two ranks, four at dp2 x mp2, no group needed to read the rule) the
    rule compiles the graphs runs on several cards have held
    (``mesh.COMPILED_COLLECTIONS`` by layout, physics and policy net;
    ``mesh.COMPILED_UPDATES`` by layout and path): dp, mp and dp x mp on
    K1 and on the engine, with the MLP and the LSTM, on every path a mesh
    selects, with and without the symmetry loss and the global shuffle
    (``permutation_groups = 1``: ``"+global"``); only the ``"lanes"``
    backend and mp's mega and step paths (which a mesh never selects: an
    mp view set after a one-process build keeps them) keep a reason. A walk
    over every config knob that picks the path (the task, the physics
    backend, ``permutation_groups`` 0, 1 and 4, the kernel switches, the
    symmetry loss), each built as a mesh builds it, compiles everywhere and
    reaches every key of both sets.
(b) Bit for bit: two spawned gloo ranks, the rule opened as (a) opens it
    (the eager reason left is the CPU's; a case is held here before a run
    on several cards may admit it to the rule), the CUDA graphs stood in
    (tests/test_torch_graphs.py's ``stand_in_graphs``: a replay runs the
    graph's body again). On each rank ``_train_iter`` equals ``iteration``
    bit for bit over two iterations, with injected noise, u and
    permutation and with generator draws: the Transition, last values,
    returns, advantages, the state and the metrics. Cases (:data:`CASES`):
    dp2 on the step path (K2's plain version per shard), dp2 on the xla
    path with the command curriculum on, and in
    tests/test_torch_graphs_parallel_paths.py mp2 on the xla path, dp2 on
    GR1T1_lstm, dp2 on the engine (``use_pallas = False``) and dp2 x mp2
    on the xla path over four gloo ranks, and in
    tests/test_torch_graphs_parallel_symmetry.py dp2 with the symmetry loss
    (the xla path with an extra loss term); the global shuffle
    (``permutation_groups = 1``, every rank updating on the gathered global
    batch) in tests/test_torch_graphs_parallel_global.py: dp2 on the mega
    path (K3's plain version) and on the step path, dp4 with
    ``permutation_groups = 2`` on the xla path, dp2 on GR1T1_lstm on the
    engine; mp with the symmetry loss, the LSTM and the engine in
    tests/test_torch_graphs_parallel_mp.py: mp2 with the symmetry loss on
    the engine, mp2 on GR1T1_lstm, and the same two at dp2 x mp2 over four
    ranks; the last runs JAX jits across ranks in
    tests/test_torch_graphs_parallel_last.py (dp2 ``permutation_groups =
    1`` with the symmetry loss, dp2 GR1T1_lstm with the symmetry loss alone
    and under the global shuffle, mp2 GR1T1_lstm with the symmetry loss on
    the engine, and GR1T1_lstm with the symmetry loss over one rank),
    tests/test_torch_mesh_compiled_global.py (dp2 x mp2
    ``permutation_groups = 1`` on the xla path, JAX's CLI run on a dp x mp
    mesh, with the symmetry loss and on GR1T1_lstm on the engine) and
    tests/test_torch_mesh_compiled_lstm.py (dp2 x mp2 GR1T1_lstm
    with the symmetry loss, alone and under the global shuffle). The ranks
    end with bit-identical learner states (their digests).
(c) Hygiene: on each rank the host-traffic recorder of
    tests/test_torch_graphs.py records nothing during a third compiled
    iteration (every graph's body run again): the collection with the
    curriculum's all-reduce, GAE's two all-reduces, ``prepare_update``
    with the permutation's broadcast, the step path's grad steps with
    ``PPO.reduce``, mp2's xla grad steps with ``_CopyToMP`` /
    ``_ReduceFromMP`` and the clip norm's all-reduce, and the metric
    sums' all-reduce. That iteration issues the same collectives, in the
    same order and at the same shapes, as an eager ``iteration`` (every
    rank must capture the same sequence); under the global shuffle one
    all-gather of the update's inputs and no gradient all-reduce.

The curriculum's cases run GR1T1 with the all-terms fold
(``cuda_step.all_terms_config``): the command curriculum runs only with
its tracking_lin_vel term, which GR1T1's own reward set lacks, and then
all-reduces in every env step.

Sizes: 8 envs (4 a dp rank), decimation 2, 3 steps, 2 minibatches x 1
epoch, hidden (32, 32); mp2 takes (32, 16, 8), as
tests/test_torch_tensor_parallel.py does (with (32, 32) the critic's
output layer of width 1 would be split over 2 ranks). Each spawn joins
within 120 s (``parallel.launch.spawn``). JAX parity of the eager dp and mp
paths is tests/test_torch_parallel.py's and
tests/test_torch_tensor_parallel.py's.
"""

import contextlib
import os

import pytest
import torch
import torch.distributed as dist

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.envs.legged_env import physics_backend
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import file_init_method, spawn
from wiki_grx_gym_tpu_torch.sim import cuda_step

WORLD = 2
N_ENVS, STEPS = 8, 3
JOIN_S = 120.0


def _train(hidden=(32, 32), **alg):
    def mutate(t):
        t.runner.num_steps_per_env = STEPS
        t.algorithm.num_mini_batches = 2
        t.algorithm.num_learning_epochs = 1
        t.policy.actor_hidden_dims = list(hidden)
        t.policy.critic_hidden_dims = list(hidden)
        for k, v in alg.items():
            setattr(t.algorithm, k, v)
    return mutate


def _env(all_terms=False, **kw):
    def mutate(c):
        c.control.decimation = 2
        if all_terms:
            cuda_step.all_terms_config(c)
        for k, v in kw.items():
            section, name = k.split("__")
            setattr(getattr(c, section), name, v)
    return mutate


# name: (task, env config, train config, num_mp, the update path); two
# ranks, dp2 x mp2 four
CASES = {
    "dp2_step": ("GR1T1", _env(), _train(fused_mega=False), 1, "step"),
    "dp2_xla_curriculum": ("GR1T1", _env(True, commands__curriculum=True), _train(fused_update=False), 1, "xla"),
    "mp2_xla": ("GR1T1", _env(), _train(hidden=(32, 16, 8)), 2, "xla"),
    "dp2_lstm": ("GR1T1_lstm", _env(), _train(), 1, "recurrent"),
    "dp2_engine": ("GR1T1", _env(True, sim__use_pallas=False, commands__curriculum=True), _train(), 1, "step"),
    "dp2_mp2_xla": ("GR1T1", _env(True, commands__curriculum=True), _train(hidden=(32, 16, 8)), 2, "xla"),
    "dp2_symmetry": ("GR1T1", _env(), _train(symmetry_coef=0.5), 1, "xla"),
    # the global shuffle: every rank updates on the gathered global batch
    "dp2_global_mega": ("GR1T1", _env(True, commands__curriculum=True), _train(permutation_groups=1), 1, "mega"),
    "dp2_global_step": ("GR1T1", _env(), _train(permutation_groups=1, fused_mega=False), 1, "step"),
    "dp4_global_xla": ("GR1T1", _env(), _train(permutation_groups=2), 1, "xla"),
    "dp2_global_lstm_engine": ("GR1T1_lstm", _env(True, sim__use_pallas=False, commands__curriculum=True),
                               _train(permutation_groups=1), 1, "recurrent"),
    # tensor parallelism with the symmetry loss, the LSTM and the engine
    "mp2_symmetry_engine": ("GR1T1", _env(sim__use_pallas=False), _train(hidden=(32, 16, 8), symmetry_coef=0.5),
                            2, "xla"),
    "mp2_lstm": ("GR1T1_lstm", _env(), _train(hidden=(32, 16, 8)), 2, "recurrent"),
    "dp2_mp2_symmetry_engine": ("GR1T1", _env(True, sim__use_pallas=False, commands__curriculum=True),
                                _train(hidden=(32, 16, 8), symmetry_coef=0.5), 2, "xla"),
    "dp2_mp2_lstm": ("GR1T1_lstm", _env(), _train(hidden=(32, 16, 8)), 2, "recurrent"),
    # the global shuffle with the symmetry loss and under dp x mp (JAX's CLI
    # run on a mesh: permutation_groups 1), the LSTM with the symmetry loss,
    # mp on the engine with the LSTM, the recurrent mirror loss in one process
    "dp2_global_symmetry": ("GR1T1", _env(), _train(permutation_groups=1, symmetry_coef=0.5), 1, "xla"),
    "dp2_lstm_symmetry": ("GR1T1_lstm", _env(), _train(symmetry_coef=0.5), 1, "recurrent"),
    "dp2_global_lstm_symmetry": ("GR1T1_lstm", _env(), _train(permutation_groups=1, symmetry_coef=0.5), 1,
                                 "recurrent"),
    "mp2_lstm_symmetry_engine": ("GR1T1_lstm", _env(sim__use_pallas=False),
                                 _train(hidden=(32, 16, 8), symmetry_coef=0.5), 2, "recurrent"),
    "dp2_mp2_global_xla": ("GR1T1", _env(True, commands__curriculum=True),
                           _train(hidden=(32, 16, 8), permutation_groups=1), 2, "xla"),
    "dp2_mp2_global_symmetry": ("GR1T1", _env(), _train(hidden=(32, 16, 8), permutation_groups=1,
                                                       symmetry_coef=0.5), 2, "xla"),
    "dp2_mp2_global_lstm_engine": ("GR1T1_lstm", _env(True, sim__use_pallas=False, commands__curriculum=True),
                                   _train(hidden=(32, 16, 8), permutation_groups=1), 2, "recurrent"),
    "dp2_mp2_lstm_symmetry": ("GR1T1_lstm", _env(), _train(hidden=(32, 16, 8), symmetry_coef=0.5), 2,
                              "recurrent"),
    "dp2_mp2_global_lstm_symmetry": ("GR1T1_lstm", _env(), _train(hidden=(32, 16, 8), permutation_groups=1,
                                                                symmetry_coef=0.5), 2, "recurrent"),
    "world1_lstm_symmetry": ("GR1T1_lstm", _env(), _train(symmetry_coef=0.5), 1, "recurrent"),
}
WORLDS = {"dp2_mp2_xla": 4, "dp4_global_xla": 4, "dp2_mp2_symmetry_engine": 4, "dp2_mp2_lstm": 4,
          "dp2_mp2_global_xla": 4, "dp2_mp2_global_symmetry": 4, "dp2_mp2_global_lstm_engine": 4,
          "dp2_mp2_lstm_symmetry": 4, "dp2_mp2_global_lstm_symmetry": 4, "world1_lstm_symmetry": 1}


def build(task, env_mutate, train_mutate, n=N_ENVS, dp=None):
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = n
    env_mutate(cfg)
    train_mutate(train_cfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu", dp=dp)
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None, dp=dp)
    return env, runner


@contextlib.contextmanager
def backend_reads(name):
    """``dist.get_backend`` reads ``name`` (None: the group's own) while
    the views are made: each view reads its group's backend once."""
    if name is None:
        yield
        return
    orig = dist.get_backend
    dist.get_backend = lambda group=None: name
    try:
        yield
    finally:
        dist.get_backend = orig


def as_on_card(env, runner):
    """(runner's rule, env step's rule) as they read on a CUDA device."""
    runner.device = env.device = torch.device("cuda")
    env.backend = physics_backend(getattr(env.cfg.sim, "use_pallas", "auto"), "cuda")
    return runner.eager_reason, env.step_graph_reason


# ---------------------------------------------------------------------------
# (a) the rule
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_gloo(tmp_path):
    """A real gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=file_init_method(str(tmp_path)), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


RULE_CONFIGS = {
    "mega": ("GR1T1", _env(), _train()),
    "step": ("GR1T1", _env(), _train(fused_mega=False)),
    "xla": ("GR1T1", _env(), _train(fused_update=False)),
    "symmetry": ("GR1T1", _env(), _train(symmetry_coef=0.5)),
    "recurrent": ("GR1T1_lstm", _env(), _train()),
    "engine": ("GR1T1", _env(sim__use_pallas=False), _train()),
    "lanes": ("GR1T1", _env(sim__use_pallas="lanes"), _train()),
    "engine_xla": ("GR1T1", _env(sim__use_pallas=False), _train(fused_update=False)),
    "engine_symmetry": ("GR1T1", _env(sim__use_pallas=False), _train(symmetry_coef=0.5)),
    "engine_recurrent": ("GR1T1_lstm", _env(sim__use_pallas=False), _train()),
    # the global shuffle under dp (permutation_groups = 1: JAX's CLI run)
    "mega_global": ("GR1T1", _env(), _train(permutation_groups=1)),
    "step_global": ("GR1T1", _env(), _train(permutation_groups=1, fused_mega=False)),
    "xla_global": ("GR1T1", _env(), _train(permutation_groups=1, fused_update=False)),
    "symmetry_global": ("GR1T1", _env(), _train(permutation_groups=1, symmetry_coef=0.5)),
    "recurrent_global": ("GR1T1_lstm", _env(), _train(permutation_groups=1)),
    # the LSTM with the symmetry loss (make_mirror_loss_recurrent), alone and
    # under the global shuffle; the LSTM on the engine under the global shuffle
    "recurrent_symmetry": ("GR1T1_lstm", _env(), _train(symmetry_coef=0.5)),
    "recurrent_symmetry_global": ("GR1T1_lstm", _env(), _train(permutation_groups=1, symmetry_coef=0.5)),
    "engine_recurrent_global": ("GR1T1_lstm", _env(sim__use_pallas=False), _train(permutation_groups=1)),
}


@pytest.mark.parametrize("layout", ["dp", "dp_mp"])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("config", sorted(RULE_CONFIGS))
def test_rule_reads_the_groups_backend(one_rank_gloo, config, backend, layout):
    dev = torch.device("cpu")
    with backend_reads(None if backend == "gloo" else "nccl"):
        tp = (mesh.TensorParallel(world=1, rank=0, device=dev, group=dist.new_group([0]))
              if layout == "dp_mp" else None)
        dp = mesh.DataParallel(world=1, rank=0, device=dev, mp=tp)
    assert dp.backend == backend and (tp is None or tp.backend == backend)
    assert dp.capturable == (backend == "nccl")
    task, env_mutate, train_mutate = RULE_CONFIGS[config]
    env, runner = build(task, env_mutate, train_mutate, n=4, dp=dp)
    assert "device cpu" in runner.eager_reason and env.step_graph_reason is not None
    reason, step_reason = as_on_card(env, runner)
    if config == "lanes":
        assert "'lanes'" in reason and "'lanes'" in step_reason
    elif backend == "gloo":
        assert "parallelism over gloo" in reason and "over gloo" in step_reason, (reason, step_reason)
    else:
        assert reason is None and step_reason is None, (config, reason, step_reason)


# (layout, config): whether the runner's iteration and the env's step are
# compiled with a view of two ranks (four at dp2 x mp2) over NCCL on the
# card. dp2 builds with the view (a dp mesh turns the mega path off: the MLP
# configs without an extra loss term, the engine's too, take the step path
# there; with permutation_groups = 1 the global shuffle keeps the
# one-process rule), and so does dp2 x mp2 (hidden (32, 16, 8): every MLP
# config takes the xla path, as under mp); mp2 sets the mp view after a
# one-process build, so each config keeps its own path (the mega and step
# paths are not paths of tensor parallelism, and one process has no global
# shuffle). Across ranks over NCCL only the "lanes" backend and the paths
# a mesh never selects keep a reason.
_ALL = {config: (True, True) for config in RULE_CONFIGS}
_ALL["lanes"] = (False, False)
ACROSS_RANKS = {
    "dp2": dict(_ALL),
    "mp2": {**_ALL, "mega": (False, True), "step": (False, True), "engine": (False, True),
            "mega_global": (False, True), "step_global": (False, True)},
    "dp2_mp2": dict(_ALL),
}
# (layout, config): the words of the reason where the rule keeps it eager
UNHELD = {("mp2", "mega"): "on the mega path", ("mp2", "engine"): "on the mega path",
          ("mp2", "step"): "on the step path", ("mp2", "mega_global"): "on the mega path",
          ("mp2", "step_global"): "on the step path"}
LAYOUT_WORDS = {"dp2": "data parallelism across ranks", "mp2": "tensor parallelism across ranks",
                "dp2_mp2": "data and tensor parallelism across ranks"}


def views_over_nccl(layout, rank=0):
    """This rank's dp view (with its mp view) of ``layout`` over NCCL, made
    without a group (the rule reads only the views)."""
    dev = torch.device("cpu")
    num_mp = 2 if "mp2" in layout else 1
    tp = mesh.TensorParallel(world=2, rank=rank % 2, device=dev, backend="nccl") if num_mp > 1 else None
    world = 2 if layout.startswith("dp2") else 1
    return mesh.DataParallel(world=world, rank=rank // num_mp, device=dev, mp=tp, backend="nccl")


@pytest.mark.parametrize("layout", ["dp2", "mp2", "dp2_mp2"])
@pytest.mark.parametrize("config", sorted(RULE_CONFIGS))
def test_rule_across_ranks_over_nccl(config, layout):
    dp = views_over_nccl(layout)
    assert dp.uncapturable_backend is None and dp.layout == {"dp2": "dp", "mp2": "mp", "dp2_mp2": "dp x mp"}[layout]
    task, env_mutate, train_mutate = RULE_CONFIGS[config]
    if layout == "dp2_mp2":
        # built with the views: the net split in two ((32, 32) cannot be:
        # the critic's output layer has width 1)
        env, runner = build(task, env_mutate, lambda t: (train_mutate(t), _train(hidden=(32, 16, 8))(t)), n=8,
                            dp=dp)
    else:
        # the mp view is set after the build
        env, runner = build(task, env_mutate, train_mutate, n=8, dp=dp if layout == "dp2" else None)
        runner.dp = env.dp = dp
    reason, step_reason = as_on_card(env, runner)
    compiled, step_graphed = ACROSS_RANKS[layout][config]
    assert (reason is None) == compiled and (step_reason is None) == step_graphed, (reason, step_reason)
    if config == "lanes":
        assert "'lanes'" in reason and "'lanes'" in step_reason
    else:
        for why in (reason, step_reason):
            assert why is None or (LAYOUT_WORDS[layout] in why and "not yet held" in why), why
    if (layout, config) in UNHELD:
        assert UNHELD[layout, config] in reason, reason


# every config knob that picks the update's path or the collection's graph:
# the task (the policy net), the physics backend, permutation_groups (0
# resolves to the dp group's size; 1 and 4 against dp2: the global shuffle
# and a multiple of the group), the kernel paths' switches and the symmetry
# loss
WALK_TASKS = ("GR1T1", "GR1T1_lstm")
WALK_PHYSICS = {"kernel": {}, "engine": {"sim__use_pallas": False}}
WALK_GROUPS = (0, 1, 4)
WALK_ALG = {"default": {}, "step": {"fused_mega": False}, "xla": {"fused_update": False},
            "symmetry": {"symmetry_coef": 0.5}}


@pytest.mark.parametrize("layout", ["dp2", "mp2", "dp2_mp2"])
def test_every_selectable_combination_across_ranks_compiles(layout):
    """Over NCCL across ranks, every (layout, physics, policy net, update
    path) a mesh selects compiles: each config of the walk, built with the
    layout's views as a mesh builds it, has ``eager_reason`` None on the
    card (and so does its env step), and the walk reaches every key of
    ``mesh.COMPILED_COLLECTIONS`` and ``COMPILED_UPDATES`` of the layout. A
    key missing from the rule fails here rather than leaving its runs
    eager. Kept out of the walk: the ``"lanes"`` backend (K1's plain
    version; test_rule_across_ranks_over_nccl holds its reason) and gloo
    (test_rule_reads_the_groups_backend)."""
    dp = views_over_nccl(layout)
    hidden = (32, 16, 8) if "mp2" in layout else (32, 32)
    # permutation_groups 1 and 4 are the same path as the group's own at mp2 (no dp group)
    groups = WALK_GROUPS if layout != "mp2" else (0,)
    seen = set()
    for task in WALK_TASKS:
        for physics, sim in WALK_PHYSICS.items():
            for pg in groups:
                for alg in WALK_ALG.values():
                    env, runner = build(task, _env(**sim), _train(hidden=hidden, permutation_groups=pg, **alg),
                                        n=8, dp=dp)
                    reason, step_reason = as_on_card(env, runner)
                    combo = (dp.layout, env.backend, "lstm" if runner.recurrent else "mlp", runner.rule_path)
                    assert reason is None and step_reason is None, (combo, reason, step_reason)
                    seen.add(combo)
    collections = {c for c in mesh.COMPILED_COLLECTIONS if c[0] == dp.layout}
    updates = {u for u in mesh.COMPILED_UPDATES if u[0] == dp.layout}
    assert {c[:3] for c in seen} == collections, sorted(collections - {c[:3] for c in seen})
    assert {(c[0], c[3]) for c in seen} == updates, sorted(updates ^ {(c[0], c[3]) for c in seen})


def test_a_capture_holds_the_garbage_collector():
    """``build.gc_held`` (around every capture): a garbage cycle is
    collected before the block, none inside it (a dropped compiled
    iteration's graphs, freed inside a capture, would end it failed), and
    the collector is on again after."""
    import gc
    import weakref

    from wiki_grx_gym_tpu_torch import build

    class Cycle:
        pass

    def garbage():
        a = Cycle()
        a.me = a
        return weakref.ref(a)

    assert gc.isenabled()
    before = garbage()
    with build.gc_held():
        assert before() is None and not gc.isenabled()
        inside = garbage()
        junk = [[Cycle()] for _ in range(20 * gc.get_threshold()[0])]   # past the automatic trigger
        assert inside() is not None
        del junk
    assert gc.isenabled()
    gc.collect()
    assert inside() is None


def test_destroy_releases_the_graphs_first(tmp_path):
    """``mesh.destroy`` releases every registered holder of CUDA graphs
    (``mesh.hold``: a compiled iteration or an env step graph under dp on
    the card) while the group still exists: NCCL's communicators must
    outlive the graphs that launch their kernels."""
    seen = []

    class Holder:
        def release(self):
            seen.append(dist.is_initialized())

    holder = Holder()
    dp = mesh.init_distributed(backend="gloo", init_method=file_init_method(str(tmp_path)), world_size=1,
                               rank=0, device="cpu")
    mesh.hold(holder)
    mesh.destroy(dp)
    assert seen == [True] and not dist.is_initialized()


def hang_worker(rank, world, init):
    from wiki_grx_gym_tpu_torch.parallel.launch import stage

    stage("done" if rank == 0 else "hung on purpose")
    if rank == 1:
        import time

        time.sleep(600)


def test_a_world_past_its_deadline_names_where_each_rank_stopped(tmp_path):
    """``launch.spawn``: a world that misses its deadline is killed, and
    the error names each rank's last ``launch.stage``."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError) as err:
        spawn(hang_worker, 2, rendezvous_dir=str(tmp_path), timeout_s=25.0)
    assert time.monotonic() - t0 < 60
    assert "rank 0 at 'done'" in str(err.value) and "rank 1 at 'hung on purpose'" in str(err.value), err.value


def test_views_made_without_a_group_read_no_backend():
    assert not dist.is_initialized()
    dp = mesh.DataParallel(world=2, rank=0, device=torch.device("cpu"))
    assert dp.backend is None and not dp.capturable
    assert dp.uncapturable_backend == "an unknown backend"


# ---------------------------------------------------------------------------
# (b), (c): two gloo ranks, the graphs stood in
# ---------------------------------------------------------------------------

def _diffs(want, got, m_eager, m_graph, s_eager, s_graph, tag):
    from wiki_grx_gym_tpu_torch.learn import graphs

    out = []
    for field in want["batch"]._fields:
        if not torch.equal(getattr(got["batch"], field), getattr(want["batch"], field)):
            out.append(f"{tag} batch.{field}")
    for k in ("last_values", "returns", "advantages"):
        if not torch.equal(got[k], want[k]):
            out.append(f"{tag} {k}")
    for (path, x), (_, y) in zip(graphs.leaves(s_graph), graphs.leaves(s_eager)):
        if torch.is_tensor(x):
            same = x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, torch.Generator):
            same = torch.equal(x.get_state(), y.get_state())
        else:
            same = x is y or x == y
        if not same:
            out.append(f"{tag} state.{path}")
    if list(m_graph) != list(m_eager):
        out.append(f"{tag} metric keys")
    out += [f"{tag} metric {k}" for k in m_eager if not torch.equal(m_graph[k], m_eager[k])]
    return out


def _draws(env, runner, it, rank):
    """Injected noise, u and permutation of iteration ``it`` (every rank
    its own noise and u, the same permutation; the broadcast gives every
    rank rank 0's anyway)."""
    import numpy as np

    t, n, a = runner.num_steps_per_env, env.num_envs, env.num_actions
    rng = np.random.RandomState(100 * it + rank)
    noise = torch.from_numpy(rng.randn(t, n, a).astype(np.float32))
    u = torch.from_numpy(rng.rand(t, n, env._step_u_cols[1]).astype(np.float32))
    prng = np.random.RandomState(7 + it)
    n_blocks, used = runner.alg.perm_size(t, n, recurrent=runner.recurrent)   # env columns if recurrent
    perm = torch.from_numpy(prng.permutation(n_blocks)[:used])
    return noise, u, perm


def record_collectives(mp):
    """(the list of (operation, group, shape) of every collective the
    views issue while ``on[0]``, ``on``)."""
    seq, on = [], [False]
    for op in ("all_reduce_sum", "broadcast", "all_gather"):
        orig = getattr(mesh._Group, op)

        def wrapped(self, x, *a, _orig=orig, _op=op, **k):
            if on[0]:
                seq.append((_op, "mp" if isinstance(self, mesh.TensorParallel) else "dp", tuple(x.shape)))
            return _orig(self, x, *a, **k)

        mp.setattr(mesh._Group, op, wrapped)
    return seq, on


def case_worker(rank, world, init, name, out_dir):
    # one thread a rank: at these sizes more threads make no case faster,
    # and the spawned ranks of several test files share the machine's cores
    torch.set_num_threads(1)
    from test_torch_graphs import host_traffic, stand_in_graphs

    task, env_mutate, train_mutate, num_mp, path = CASES[name]
    with backend_reads("nccl"):   # the rule opened as on the card over NCCL
        whole = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu",
                                      timeout_s=60)
        dp = mesh.make_mesh(num_mp, whole)
    out = {"mismatches": [], "calls": None}
    try:
        assert dp.uncapturable_backend is None
        _, runner = build(task, env_mutate, train_mutate, dp=dp)
        assert runner.eager_reason.startswith("device cpu"), runner.eager_reason   # only the CPU's
        with pytest.MonkeyPatch.context() as mp:
            stand_in_graphs(mp)
            for draws in ("injected", "generators"):
                env, runner = build(task, env_mutate, train_mutate, dp=dp)
                assert ("recurrent" if runner.recurrent else runner.alg.path) == path
                s_eager, s_graph = runner.init_state(), runner.init_state()
                for it in range(2):
                    kw = (dict(zip(("noise", "u", "perm"), _draws(env, runner, it, dp.rank)))
                          if draws == "injected" else {})
                    want = {}
                    s_eager, m_eager = runner.iteration(s_eager, out=want, **kw)
                    s_graph, m_graph = runner._train_iter(s_graph, **kw)
                    out["mismatches"] += _diffs(want, runner.compiled.last, m_eager, m_graph, s_eager, s_graph,
                                                f"{draws} iteration {it}")
                out[f"{draws}_replays"] = runner.compiled.collect["inject" if draws == "injected" else "draw"].replays
            # (c): a third compiled iteration, every graph's body run again;
            # its collectives against a third eager iteration's
            seq, on = record_collectives(mp)
            on[0] = True
            s_eager, _ = runner.iteration(s_eager)
            eager_seq = list(seq)
            seq.clear()
            with host_traffic(mp) as calls:
                s_graph, metrics = runner._train_iter(s_graph)
            on[0] = False
            out["collectives"] = {"eager": eager_seq, "compiled": list(seq)}
            out["calls"] = sorted(set(calls))
            out["finite"] = all(bool(torch.isfinite(v)) for v in metrics.values())
            out["digests"] = sharding.check_replicas_identical(
                dp, s_graph.ppo, "compiled iterations", net=runner.net,
                replicated=(s_graph.env_state,) if dp.mp is not None else None)
            out["cmd_range"] = s_graph.env_state.cmd_lin_vel_x_range.clone()
        torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        mesh.destroy(whole)


def run_case(name, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(name)
    world = WORLDS.get(name, WORLD)
    spawn(case_worker, world, args=(name, str(out_dir)), rendezvous_dir=str(out_dir), timeout_s=JOIN_S)
    return [torch.load(out_dir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]


def check_case(ranks, name):
    num_mp = CASES[name][3]
    # the first call warmed up and captured, the second replayed; on the
    # engine the rollout step's graph A1 is called T times a call
    replays = 2 * STEPS - 1 if "engine" in name else 1
    for r, res in enumerate(ranks):
        assert res["mismatches"] == [], (name, r, res["mismatches"])
        assert res["injected_replays"] == replays and res["generators_replays"] == replays, (name, r)
        assert res["calls"] == [], (name, r, res["calls"])
        assert res["finite"], (name, r)
        seq = res["collectives"]
        assert seq["compiled"] == seq["eager"] and seq["eager"], (name, r, seq)
        # the global shuffle: one all-gather of the update's inputs over the
        # dp group an iteration, and no other all-gather
        gathers = [c for c in seq["compiled"] if c[0] == "all_gather"]
        assert len(gathers) == ("global" in name) and all(c[1] == "dp" for c in gathers), (name, r, gathers)
    # every dp rank's digest, gathered on each: the same learner state (mp
    # peers hold their shards; check_replicas_identical held their
    # replicated leaves and env states equal)
    for res in ranks:
        assert len(res["digests"]) == len(ranks) // num_mp and len(set(res["digests"].tolist())) == 1
    if num_mp == 1 and len(ranks) > 1:
        assert torch.equal(ranks[0]["digests"], ranks[1]["digests"])


@pytest.fixture(scope="module")
def dp2_step(tmp_path_factory):
    return run_case("dp2_step", tmp_path_factory)


@pytest.fixture(scope="module")
def dp2_xla_curriculum(tmp_path_factory):
    return run_case("dp2_xla_curriculum", tmp_path_factory)


def test_dp2_step_path_compiled_equals_eager(dp2_step):
    check_case(dp2_step, "dp2_step")


def test_dp2_xla_path_with_the_curriculum_compiled_equals_eager(dp2_xla_curriculum):
    check_case(dp2_xla_curriculum, "dp2_xla_curriculum")
    # the curriculum's all-reduce of the (sum, count) pair in every env step
    assert sum(c == ("all_reduce_sum", "dp", (2,)) for c in dp2_xla_curriculum[0]["collectives"]["compiled"]) == STEPS
    # the curriculum's all-reduce: both ranks widened the range alike
    assert torch.equal(dp2_xla_curriculum[0]["cmd_range"], dp2_xla_curriculum[1]["cmd_range"])

