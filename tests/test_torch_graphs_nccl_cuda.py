"""The compiled iteration over NCCL on the card (``learn/graphs.py`` under
``parallel/mesh.py``'s groups: the collectives captured in the graphs).

- One rank of a world-1 NCCL group made in this process, GR1T1 at 64 envs
  with the all-terms fold (``cuda_step.all_terms_config``: the curriculum
  runs only with its tracking_lin_vel term) and the command curriculum on,
  on the mega path (K3) and the xla path:
  the rule compiles it; ``_train_iter`` equals ``iteration`` bit for bit
  over three calls with injected draws and two with generator draws; the
  collection graph captured the curriculum's all-reduce of every env step
  and the update graph the metric sums' all-reduce. At one rank NCCL runs
  an in-place sum without a kernel, so the graphs' NCCL kernel nodes are
  counted only where there are two ranks.
- Across ranks (:data:`ACROSS`: one rank a card, each case skipped where
  ``torch.cuda.device_count()`` is below its ranks, since NCCL takes one
  rank a card), each case at 64 envs a dp rank with the rule as shipped:
  dp2 on the step path, on the xla path, with the symmetry loss, on the
  engine and on GR1T1_lstm; mp2 on the xla path (NCCL launched from
  autograd's backward inside the capture); on four cards dp2 x mp2 on the
  xla path (two communicators a rank) and dp4 on the step path; the
  global shuffle (every rank updating on the gathered global batch): dp2
  with ``permutation_groups = 1`` on the mega path (K3 over the gathered
  batch), on the step path and on GR1T1_lstm on the engine, dp4 with
  ``permutation_groups = 2`` on the xla path; mp2 and, on four cards,
  dp2 x mp2 with the symmetry loss on the engine and on GR1T1_lstm; dp2
  with ``permutation_groups = 1`` and the symmetry loss, dp2 GR1T1_lstm
  with the symmetry loss alone and under the global shuffle, mp2
  GR1T1_lstm with the symmetry loss on the engine, and on four cards dp2
  x mp2 with ``permutation_groups = 1`` on the xla path (JAX's own CLI
  run, ``train --num_mp 2`` on four devices), with the symmetry loss, on
  GR1T1_lstm on the engine and on GR1T1_lstm with the symmetry loss, and
  dp2 x mp2 GR1T1_lstm with the symmetry loss. Each
  rank is compiled (``eager_reason`` None), bit for bit against its eager
  iteration over three calls, its collection and update graphs hold NCCL
  kernel nodes (the gather's among them under the global shuffle), and
  every dp group's ranks end with one learner state. Together they hold
  every key of ``mesh.COMPILED_COLLECTIONS`` and ``COMPILED_UPDATES``: a
  new key is held here (with the rule opened in each rank) before it
  joins them.

Each world ends within ``JOIN_S`` (``parallel.launch.spawn``); past it
every rank is killed and the error names where each stopped.

Needs a CUDA card; marked ``gpu``, elsewhere each test skips. On the card,
from the checkout's root:

    python -m pytest --noconftest -m gpu -q tests/test_torch_graphs_nccl_cuda.py
"""

import json
import os

import pytest
import torch
import torch.distributed as dist

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn import graphs
from wiki_grx_gym_tpu_torch.parallel import mesh
from wiki_grx_gym_tpu_torch.parallel.launch import file_init_method, spawn
from wiki_grx_gym_tpu_torch.sim import cuda_step

pytestmark = pytest.mark.gpu

N, T = 64, 4
JOIN_S = 240.0   # a world's deadline (its ranks are killed past it)
PATHS = {"mega": {}, "xla": {"fused_update": False}, "step": {"fused_mega": False},
         "symmetry": {"symmetry_coef": 0.5},
         # the global shuffle: permutation_groups that the dp group does not divide
         "mega_global": {"permutation_groups": 1}, "step_global": {"permutation_groups": 1, "fused_mega": False},
         "groups2": {"permutation_groups": 2},
         "symmetry_global": {"permutation_groups": 1, "symmetry_coef": 0.5}}


def _need_cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs, NCCL and K1-K3 have no CPU mode")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards (NCCL takes one rank a card), the machine has "
                    f"{torch.cuda.device_count()}")


def make_runner(dp, path, n=N, task="GR1T1", sim=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = n
    cuda_step.all_terms_config(cfg)
    cfg.commands.curriculum = True
    for k, v in (sim or {}).items():
        setattr(cfg.sim, k, v)
    train_cfg.runner.num_steps_per_env = T
    for k, v in PATHS[path].items():
        setattr(train_cfg.algorithm, k, v)
    env, _ = task_registry.make_env(task, env_cfg=cfg, dp=dp)
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None, dp=dp)
    assert runner.eager_reason is None and env.step_graph_reason is None
    return runner


def draws(runner, seed):
    env, t, dev = runner.env, runner.num_steps_per_env, runner.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n = env.num_envs
    noise = torch.randn((t, n, env.num_actions), generator=g, device=dev)
    u = torch.rand((t, n, env._step_u_cols[1]), generator=g, device=dev)
    # a group's blocks (env columns if recurrent), of the global batch under the global shuffle
    n_blocks, used = runner.alg.perm_size(t, n, recurrent=runner.recurrent)
    return noise, u, torch.randperm(n_blocks, generator=g, device=dev)[:used]


def bits(x):
    return x.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]) \
        if x.is_floating_point() else x


def differing(got, want, prefix=""):
    out = []
    for (path, x), (_, y) in zip(graphs.leaves(got, prefix), graphs.leaves(want, prefix)):
        if torch.is_tensor(x):
            if x.dtype != y.dtype or not torch.equal(bits(x), bits(y)):
                out.append(path)
        elif isinstance(x, torch.Generator) and not torch.equal(x.get_state(), y.get_state()):
            out.append(path)
    return out


def compiled_vs_eager(runner, calls, injected, seed=100):
    """The leaves that differ in each of ``calls`` compiled calls against
    the eager ones, each fed its own last state."""
    s_e, s_g = runner.init_state(), runner.init_state()
    out = []
    for it in range(calls):
        kw = dict(zip(("noise", "u", "perm"), draws(runner, seed + it))) if injected else {}
        want = {}
        s_e, m_e = runner.iteration(s_e, out=want, **kw)
        s_g, m_g = runner._train_iter(s_g, **kw)
        d = differing({k: runner.compiled.last[k] for k in want}, want)
        d += differing(s_g, s_e, "state")
        d += [f"metric {k}" for k in m_e if not torch.equal(bits(m_g[k]), bits(m_e[k]))]
        out.append(d)
    return out, s_g


@pytest.fixture
def world1(tmp_path):
    _need_cards(1)
    dp = mesh.init_distributed(backend="nccl", init_method=file_init_method(str(tmp_path)), world_size=1,
                               rank=0, device="cuda:0", timeout_s=120)
    try:
        yield dp
    finally:
        mesh.destroy(dp)


@pytest.mark.parametrize("path", ["mega", "xla"])
def test_world1_nccl_compiled_equals_eager(world1, path):
    assert world1.backend == "nccl" and world1.capturable
    runner = make_runner(world1, path)
    assert runner.alg.path == path
    injected, _ = compiled_vs_eager(runner, 3, injected=True)
    assert injected == [[], [], []], injected
    generated, _ = compiled_vs_eager(runner, 2, injected=False)
    assert generated == [[], []], generated
    ci = runner.compiled
    collect = ci.collect["inject"]
    # the curriculum's all-reduce of every env step, captured in the collection
    assert collect.collectives == {"all_reduce": T}, collect.collectives
    update = ci.update_collectives if path == "mega" else ci.update.collectives
    assert update == {"all_reduce": 1}, update   # the metric sums'
    kinds = graphs.node_kinds(collect.graph)
    assert kinds["kernels"] > 0 and kinds["cooperative"] == 0 and kinds["nccl_kernels"] == 0, kinds


# name: (task, num_mp, PATHS key, sim settings, cards); ranks = cards, one a
# card, each dp rank N envs
ACROSS = {
    "dp2_step": ("GR1T1", 1, "step", None, 2),
    "dp2_xla": ("GR1T1", 1, "xla", None, 2),
    "dp2_symmetry": ("GR1T1", 1, "symmetry", None, 2),
    "dp2_engine": ("GR1T1", 1, "step", {"use_pallas": False}, 2),
    "dp2_lstm": ("GR1T1_lstm", 1, "mega", None, 2),
    "mp2_xla": ("GR1T1", 2, "mega", None, 2),
    "dp2_mp2_xla": ("GR1T1", 2, "mega", None, 4),
    "dp4_step": ("GR1T1", 1, "step", None, 4),
    "dp2_global_mega": ("GR1T1", 1, "mega_global", None, 2),
    "dp2_global_step": ("GR1T1", 1, "step_global", None, 2),
    "dp2_global_lstm_engine": ("GR1T1_lstm", 1, "mega_global", {"use_pallas": False}, 2),
    "mp2_symmetry_engine": ("GR1T1", 2, "symmetry", {"use_pallas": False}, 2),
    "mp2_lstm": ("GR1T1_lstm", 2, "mega", None, 2),
    "dp4_global_xla": ("GR1T1", 1, "groups2", None, 4),
    "dp2_mp2_symmetry_engine": ("GR1T1", 2, "symmetry", {"use_pallas": False}, 4),
    "dp2_mp2_lstm": ("GR1T1_lstm", 2, "mega", None, 4),
    # the global shuffle with the symmetry loss and under dp x mp
    # (dp2_mp2_global_xla: JAX's own CLI run on a dp x mp mesh), the LSTM with
    # the symmetry loss, mp on the engine with the LSTM
    "dp2_global_symmetry": ("GR1T1", 1, "symmetry_global", None, 2),
    "dp2_lstm_symmetry": ("GR1T1_lstm", 1, "symmetry", None, 2),
    "dp2_global_lstm_symmetry": ("GR1T1_lstm", 1, "symmetry_global", None, 2),
    "mp2_lstm_symmetry_engine": ("GR1T1_lstm", 2, "symmetry", {"use_pallas": False}, 2),
    "dp2_mp2_global_xla": ("GR1T1", 2, "mega_global", None, 4),
    "dp2_mp2_global_symmetry": ("GR1T1", 2, "symmetry_global", None, 4),
    "dp2_mp2_global_lstm_engine": ("GR1T1_lstm", 2, "mega_global", {"use_pallas": False}, 4),
    "dp2_mp2_lstm_symmetry": ("GR1T1_lstm", 2, "symmetry", None, 4),
    "dp2_mp2_global_lstm_symmetry": ("GR1T1_lstm", 2, "symmetry_global", None, 4),
}


def across_worker(rank, world, init, out_dir, name):
    from wiki_grx_gym_tpu_torch.parallel import sharding
    from wiki_grx_gym_tpu_torch.parallel.launch import stage

    task, num_mp, path, sim, _ = ACROSS[name]
    whole = mesh.init_distributed(backend="nccl", init_method=init, world_size=world, rank=rank, device="cuda",
                                  timeout_s=JOIN_S)
    try:
        dp = mesh.make_mesh(num_mp, whole)
        stage("building the runner")
        runner = make_runner(dp, path, n=N * world // num_mp, task=task, sim=sim)   # the rule compiles it
        stage("compiled against eager")
        diffs, s_g = compiled_vs_eager(runner, 3, injected=True)
        ci = runner.compiled
        stage("the digest check")
        digests = sharding.check_replicas_identical(
            dp, s_g.ppo, "compiled iterations", net=runner.net,
            replicated=(s_g.env_state,) if dp.mp is not None else None)
        # the update's graphs: K3's (mega) or the update's, and the recurrent
        # path's metrics graph (which holds the metric sums' all-reduce)
        update = [ci.update.graph] + ([ci.epilogue.graph] if ci.epilogue is not None else [])
        staging = ci.tail["inject"] if ci.per_step else ci.collect["inject"]
        res = {"diffs": diffs, "digests": [int(x) for x in digests], "gathered": runner.alg.gathered,
               "collection": graphs.node_kinds(ci.collect["inject"].graph),
               "update": {"nccl_kernels": sum(graphs.node_kinds(g)["nccl_kernels"] for g in update)},
               "collectives": {"collection": ci.collect["inject"].collectives, "staging": staging.collectives,
                               "update": ci.update_collectives if ci.path == "mega" else ci.update.collectives}}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        stage("teardown")
    finally:
        mesh.destroy(whole)


@pytest.mark.parametrize("name", list(ACROSS))
def test_across_ranks_compiled_equals_eager(tmp_path, name):
    """A case of :data:`ACROSS` on as many cards as it has ranks: compiled
    with the rule as shipped, bit for bit against eager over three calls,
    NCCL kernel nodes in the collection and update graphs, the ranks'
    learner states equal."""
    task, num_mp, _, _, cards = ACROSS[name]
    _need_cards(cards)
    spawn(across_worker, cards, args=(str(tmp_path), name), rendezvous_dir=str(tmp_path), timeout_s=JOIN_S)
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(cards)]
    for r in ranks:
        assert r["diffs"] == [[], [], []], (name, r["diffs"])
        assert r["collection"]["nccl_kernels"] > 0 and r["update"]["nccl_kernels"] > 0, (name, r)
        # every rank gathered its dp group's digests: one learner state
        assert len(r["digests"]) == cards // num_mp and len(set(r["digests"])) == 1, (name, r["digests"])
        if name == "dp2_step":
            # GAE's two all-reduces, the permutation's broadcast, the curriculum's T
            assert r["collectives"]["collection"] == {"all_reduce": T + 2, "broadcast": 1}, r["collectives"]
        # the global shuffle's one all-gather, in the graph that stages the update
        assert r["gathered"] == ("global" in name)
        assert (r["collectives"]["staging"] or {}).get("all_gather", 0) == r["gathered"], (name, r["collectives"])
    assert not dist.is_initialized()
