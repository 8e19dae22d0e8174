"""The reference's global minibatch shuffle across ranks (``PPO`` with
``perm_groups`` that the dp group's size does not divide; 1 is the run
JAX's own CLI makes on a mesh), eagerly, over ``torch.distributed`` (gloo,
CPU).

- The dp2 update with ``perm_groups = 1``: two gloo processes, each fed its
  half of one batch (env columns) and the same block permutation of the
  global batch, against JAX's ``PPO(perm_groups=1)`` update of the whole
  batch: the xla path against JAX's XLA scan, the mega path (K3's plain
  version) and the step path (K2's plain version) against JAX's kernels in
  interpret mode. t=8, n=64, hidden (32, 32), 2 epochs x 2 minibatches, f32
  storage; tests/test_torch_parallel.py's tolerances: params and Adam
  moments at rtol 2e-3 / atol 2e-5, metrics and LR at rtol 2e-4. Each
  update all-gathers once and all-reduces no gradient; the ranks end
  bit-identical.
- A dp2 GR1T1_lstm update with ``perm_groups = 1`` (dones in the batch, a
  non-zero start memory) against the port's one-process recurrent update
  of the whole batch, at the same tolerances.
- The run JAX's CLI makes: a JAX runner built without a mesh and given a
  2-device CPU mesh afterwards keeps ``perm_groups == 1`` (the kernels'
  rule, no dp kernel mesh); the port's runner given ``permutation_groups =
  1`` under dp2 builds (it was refused before) and takes the global shuffle
  on the mega path; the group still divides the global env count.

The dp2 training iteration with ``permutation_groups = 1`` against the
port's one-process iteration is tests/test_torch_global_shuffle_iteration.py.
Every spawn joins within 120 s (``parallel.launch.spawn``).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import A, JOIN_S, N, O, P, T, WORLD, _half, _threads, make_batch
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent, Hidden
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, Transition
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn

PATHS = ("xla", "mega", "step")
LSTM_H = 16


def _alg(task="GR1T1"):
    _, train_cfg = task_registry.get_cfgs(task)
    pc = train_cfg.policy
    pc.actor_hidden_dims = [32, 32]
    pc.critic_hidden_dims = [32, 32]
    pc.rnn_hidden_size = LSTM_H
    alg = train_cfg.algorithm
    alg.num_learning_epochs = 2
    alg.num_mini_batches = 2
    alg.storage_dtype = "float32"
    return pc, alg


def port_ppo(path, dp=None):
    pc, alg = _alg()
    alg.fused_update = path != "xla"
    alg.fused_mega = path == "mega"
    return PPO(ActorCritic(O, P, A, pc), alg, perm_groups=1, dp=dp)


def lstm_ppo(dp=None):
    pc, alg = _alg("GR1T1_lstm")
    net = ActorCriticRecurrent(O, P, A, pc)
    net.reset_parameters(torch.Generator().manual_seed(3))
    return PPO(net, alg, perm_groups=1, dp=dp)


def lstm_inputs():
    """A batch with dones, its returns and advantages, and a non-zero start
    memory (L, N, H) of each LSTM."""
    batch, returns, adv = make_batch(5, dones=True)
    rng = np.random.RandomState(6)
    hidden0 = Hidden(*(torch.from_numpy(0.5 * rng.randn(1, N, LSTM_H).astype(np.float32)) for _ in range(4)))
    return batch, returns, adv, hidden0


def _count_collectives(dp):
    """Count the dp view's all-gathers and all-reduces (wrapped on it)."""
    seen = {"all_gather": 0, "all_reduce_sum": 0}
    for op in seen:
        orig = getattr(dp, op)

        def wrapped(x, *a, _orig=orig, _op=op, **k):
            seen[_op] += 1
            return _orig(x, *a, **k)

        object.__setattr__(dp, op, wrapped)
    return seen


def update_worker(rank, world, init, state0, perms, lstm_state0, lstm_perm, out_dir):
    """One rank: the perm_groups = 1 update of its half of the batch on each
    path, and of the LSTM batch."""
    _threads()
    dp = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        out = {}
        batch, returns, adv = make_batch(1)
        tb = Transition(**{k: _half(v, rank) for k, v in batch.items()})
        for path in PATHS:
            ppo = port_ppo(path, dp)
            assert ppo.gathered and ppo.path == path and ppo.local_groups == 1
            seen = _count_collectives(ppo.dp)
            st, m = ppo.update(state0, tb, _half(returns, rank), _half(adv, rank), perm=perms[path])
            seen = dict(seen)
            digests = sharding.check_replicas_identical(dp, st)
            out[path] = dict(params=st.params, m=st.m, v=st.v, count=st.count, lr=st.learning_rate,
                             metrics={k: float(x) for k, x in m.items()}, digests=digests, collectives=seen)
        batch, returns, adv, hidden0 = lstm_inputs()
        lo, hi = sharding.shard_bounds(N, world, rank)
        ppo = lstm_ppo(dp)
        seen = _count_collectives(ppo.dp)
        st, m = ppo.update_recurrent(lstm_state0, Transition(**{k: _half(v, rank) for k, v in batch.items()}),
                                     _half(returns, rank), _half(adv, rank),
                                     Hidden(*(h[:, lo:hi] for h in hidden0)), perm=lstm_perm)
        seen = dict(seen)
        out["lstm"] = dict(params=st.params, m=st.m, v=st.v, count=st.count, lr=st.learning_rate,
                           metrics={k: float(x) for k, x in m.items()},
                           digests=sharding.check_replicas_identical(dp, st), collectives=seen)
        torch.save(out, os.path.join(out_dir, f"update_rank{rank}.pt"))
    finally:
        mesh.destroy(dp)


def _jax_ppo(path):
    from wiki_grx_gym_tpu.envs import task_registry as jax_registry
    from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
    from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO

    _, train_cfg = jax_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims = [32, 32]
    pc.critic_hidden_dims = [32, 32]
    alg = train_cfg.algorithm
    alg.fused_update = path != "xla"
    alg.fused_mega = path == "mega"
    alg.num_learning_epochs = 2
    alg.num_mini_batches = 2
    alg.storage_dtype = "float32"
    alg.update_dtype = "float32"
    ppo = JaxPPO(JaxActorCritic(O, P, A, pc), alg, perm_groups=1)
    assert ppo.fused_update == (path != "xla") and ppo.fused_mega == (path == "mega")
    return ppo


@pytest.fixture(scope="module")
def global_update(tmp_path_factory):
    """JAX's perm_groups = 1 updates of the whole batch on each path, the
    port's one-process recurrent update of the whole LSTM batch, and the
    port's dp2 updates of the same batches from the same states."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
    from wiki_grx_gym_tpu_torch.convert import ppo_state_from_numpy

    batch, returns, adv = make_batch(1)
    key = jax.random.PRNGKey(202)
    jres, perms, state0 = {}, {}, None
    for path in PATHS:
        jppo = _jax_ppo(path)
        params = jppo.net.init(jax.random.PRNGKey(1))
        jst = jppo.init(params)
        jst2, jm = jppo.update(jst, JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()}),
                               jnp.asarray(returns), jnp.asarray(adv), key)
        count, mu, nu, _ = jppo._opt_state_pieces(jst2.opt_state, ravel_pytree(jst2.params)[0].size)
        jres[path] = dict(params=np.asarray(ravel_pytree(jst2.params)[0]), m=np.asarray(mu), v=np.asarray(nu),
                          count=int(count), lr=float(jst2.learning_rate),
                          metrics={k: float(x) for k, x in jm.items()})
        tppo = port_ppo(path)
        n_blocks, used = tppo.perm_size(T, N)
        perms[path] = torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)[:used]))
        c0, mu0, nu0, _ = jppo._opt_state_pieces(jst.opt_state, ravel_pytree(params)[0].size)
        state0 = ppo_state_from_numpy(tppo.net, params, np.asarray(mu0), np.asarray(nu0), np.asarray(c0),
                                      np.asarray(jst.learning_rate))
    # the LSTM: the one-process update of the whole batch
    one = lstm_ppo()
    lstm_state0 = one.init(one.net.params_flat.clone())
    n_cols, used = one.perm_size(T, N, recurrent=True)
    lstm_perm = torch.from_numpy(np.random.RandomState(8).permutation(n_cols)[:used])
    lb, lr_, la, hidden0 = lstm_inputs()
    st, m = one.update_recurrent(lstm_state0, Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in lb.items()}),
                                 torch.from_numpy(lr_), torch.from_numpy(la), hidden0, perm=lstm_perm)
    lstm_want = dict(params=st.params, m=st.m, v=st.v, count=st.count, lr=st.learning_rate,
                     metrics={k: float(x) for k, x in m.items()})
    out_dir = tmp_path_factory.mktemp("global_update")
    spawn(update_worker, WORLD, args=(state0, perms, lstm_state0, lstm_perm, str(out_dir)),
          rendezvous_dir=str(out_dir), timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"update_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return jres, ranks, port_ppo("xla").net, lstm_want, one.net


def _close(net, got, want, what, order=None):
    for name, off, shape in net.layout:
        sl = slice(off, off + int(np.prod(shape)))
        g, w = (got, want) if order is None else (order(got), want)
        atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(w[sl]).max()))
        np.testing.assert_allclose(g[sl], w[sl], rtol=2e-3, atol=atol, err_msg=f"{what} of {name}")


@pytest.mark.parametrize("path", PATHS)
def test_dp2_global_shuffle_matches_jax_perm_groups_1(global_update, path):
    from wiki_grx_gym_tpu_torch.convert import flat_to_jax_order

    jres, ranks, net, _, _ = global_update
    got, want = ranks[0][path], jres[path]
    assert int(got["count"]) == want["count"] == 4
    np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=2e-4)
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-4, err_msg=f"{path} {k}")
    for what in ("params", "m", "v"):
        _close(net, got[what], want[what], f"{path}: {what}", order=lambda x: flat_to_jax_order(net, x))


@pytest.mark.parametrize("path", [*PATHS, "lstm"])
def test_dp2_global_shuffle_ranks_end_bit_identical_after_one_gather(global_update, path):
    _, ranks, _, _, _ = global_update
    a, b = ranks[0][path], ranks[1][path]
    assert bool((a["digests"] == a["digests"][0]).all()) and torch.equal(a["digests"], b["digests"])
    for k in ("params", "m", "v", "count", "lr"):
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # one gather of the update's inputs; no gradient all-reduce (the
    # permutation's broadcast is the update's only other collective)
    for r in ranks:
        assert r[path]["collectives"] == {"all_gather": 1, "all_reduce_sum": 0}, r[path]["collectives"]


def test_dp2_global_shuffle_lstm_matches_one_process(global_update):
    _, ranks, _, want, net = global_update
    got = ranks[0]["lstm"]
    assert int(got["count"]) == int(want["count"]) == 4
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-4, err_msg=k)
    for what in ("params", "m", "v"):
        _close(net, got[what].numpy(), want[what].numpy(), f"lstm: {what}")


def test_gather_envs_joins_in_global_env_order():
    """``sharding.gather_envs`` over a stand-in group of three ranks: each
    tensor joined along its env dimension (1), rank after rank, dtypes
    kept."""
    class Three:
        world = 3

        def all_gather(self, x):
            return torch.stack([x + 100 * r for r in range(3)])

    a = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2)
    b = torch.tensor([[True, False]])
    ga, gb = sharding.gather_envs(Three(), [a, b])
    assert torch.equal(ga, torch.cat([a + 100 * r for r in range(3)], dim=1))
    # rank r's part is b + 100 r: rank 0's False stays False, every other entry is True
    assert gb.dtype == torch.bool and torch.equal(gb, torch.tensor([[True, False, True, True, True, True]]))


def test_jax_cli_run_keeps_perm_groups_1_and_the_port_builds_it():
    """JAX's CLI order (``scripts/train.py:24-26``): the runner built
    without a mesh, then given a 2-device CPU mesh, has ``perm_groups == 1``
    and the one-process kernel rule (no dp kernel mesh). The port's runner
    with ``permutation_groups = 1`` under dp2 (a rank's view; building
    needs no group) builds and takes the global shuffle on the mega path;
    the rule names it apart (``"+global"``)."""
    import jax

    from wiki_grx_gym_tpu.envs import task_registry as jax_registry
    from wiki_grx_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh

    cfg, train_cfg = jax_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 4
    env, _ = jax_registry.make_env("GR1T1", env_cfg=cfg)
    runner, _ = jax_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    runner.mesh = jax_make_mesh(num_mp=1, devices=jax.devices()[:2])
    assert runner.alg.perm_groups == 1 and runner.alg.fused_dp_mesh is None and runner.alg.fused_mega

    dp = mesh.DataParallel(world=2, rank=1, device=torch.device("cpu"))
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 8
    train_cfg.algorithm.permutation_groups = 1
    train_cfg.algorithm.num_mini_batches = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu", dp=dp)
    port = OnPolicyRunner(env, train_cfg, device="cpu", dp=dp)
    alg = port.alg
    assert alg.perm_groups == 1 and alg.gathered and alg.local_groups == 1 and alg.path == "mega"
    assert port.rule_path == "mega+global"
    assert alg.perm_size(T, env.num_envs) == alg.shuffle_geometry(T, 8)[1:3]   # the global batch's blocks
    # any other count the group does not divide: the xla path; a multiple: per rank
    for pg, gathered, path in ((3, True, "xla"), (4, False, "xla"), (2, False, "step")):
        train_cfg.algorithm.permutation_groups = pg
        with pytest.raises(ValueError, match="not divisible") if pg == 3 else contextlib.nullcontext():
            ppo = OnPolicyRunner(env, train_cfg, device="cpu", dp=dp).alg
            assert (ppo.gathered, ppo.path) == (gathered, path)
            ppo.perm_size(T, env.num_envs)
    # the recurrent update takes the global shuffle as well
    cfg, train_cfg = task_registry.get_cfgs("GR1T1_lstm")
    cfg.env.num_envs = 8
    train_cfg.algorithm.permutation_groups = 1
    env, _ = task_registry.make_env("GR1T1_lstm", env_cfg=cfg, device="cpu", dp=dp)
    port = OnPolicyRunner(env, train_cfg, device="cpu", dp=dp)
    assert port.alg.gathered and port.rule_path == "recurrent+global"
    n_cols, used = port.alg.perm_size(T, env.num_envs, recurrent=True)
    assert n_cols == 8 and used == port.alg.recurrent_geometry(8)[1]
