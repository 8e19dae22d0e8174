"""Data-parallel training of the port over ``torch.distributed`` (gloo, CPU).

- The dp2 update: two gloo processes, each fed its half of one batch (env
  columns) and the same block permutation, against JAX's
  ``PPO(perm_groups=2)`` update of the whole batch: on the xla path against
  JAX's XLA scan (no mesh), on the step path (K2's plain version per rank +
  the gradient all-reduce) against JAX's per-shard kernel under
  ``shard_map`` on a 2-device CPU mesh (interpret mode). t=8, n=64, hidden
  (32, 32), 2 epochs x 2 minibatches, f32 storage; params and Adam moments
  at test_torch_ppo_update.py's rtol 2e-3 / atol 2e-5, metrics and LR at
  rtol 2e-4. Each rank's GAE on its half, with dones, equals JAX's global
  normalisation at test_torch_ppo_update.py's rtol 1e-5 / atol 1e-5. The
  ranks end the update bit-identical (digests all-gathered, and the saved
  tensors compared).
- A dp2 training iteration (8 GR1T1 envs, decimation 2, 4 steps, the xla
  path, the command curriculum on, half the envs timing out) against the
  port's one-process iteration with ``permutation_groups = 2``, from the
  same initial state (each rank its slice), with the action noise, the
  env's uniform blocks and the block permutation injected: metrics at rtol
  1e-4 / atol 6e-5 and params at rtol 2e-5 / atol 4e-5 (JAX's dp1-vs-dp8
  tolerances, tests/test_parallel.py). Then ``learn(1)`` on each rank with a
  log directory of its own (checkpoints only, no TensorBoard writer): only
  rank 0 writes ``model_1.pt``, and the port's ``play`` loads it in one
  process.
- Every spawn joins within 120 s (``parallel.launch.spawn`` kills its
  children past that), over a ``file://`` rendezvous in ``tmp_path``.
"""

import os

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, RunnerState, Transition
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn

O, P, A = 39, 168, 23
T, N = 8, 64
WORLD = 2
JOIN_S = 120.0


def _threads():
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))


def port_ppo(path, dp=None, perm_groups=2):
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims = [32, 32]
    pc.critic_hidden_dims = [32, 32]
    alg = train_cfg.algorithm
    alg.fused_update = path != "xla"
    alg.fused_mega = False
    alg.num_learning_epochs = 2
    alg.num_mini_batches = 2
    alg.storage_dtype = "float32"
    return PPO(ActorCritic(O, P, A, pc), alg, perm_groups=perm_groups, dp=dp)


def make_batch(seed, dones=False):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = (-0.5 * (((actions - mu) / sigma) ** 2 + np.log(2 * np.pi)) - np.log(sigma)).sum(-1)
    return dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions, rewards=0.1 * f(T, N),
                dones=(rng.rand(T, N) < 0.1) if dones else np.zeros((T, N), bool), values=f(T, N),
                log_prob=logp.astype(np.float32), mu=mu, sigma=sigma), f(T, N), f(T, N)


def _half(x, rank):
    lo, hi = sharding.shard_bounds(N, WORLD, rank)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)[:, lo:hi]))


def update_worker(rank, world, init, state0, perms, out_dir):
    """One rank: the update of its half of batch 1 on each path, and GAE of
    its half of batch 3 (with dones)."""
    _threads()
    dp = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        out = {}
        batch, returns, adv = make_batch(1)
        for path in ("xla", "step"):
            ppo = port_ppo(path, dp)
            assert ppo.path == path and ppo.local_groups == 1
            tb = Transition(**{k: _half(v, rank) for k, v in batch.items()})
            st, m = ppo.update(state0, tb, _half(returns, rank), _half(adv, rank), perm=perms[path])
            digests = sharding.check_replicas_identical(dp, st)
            out[path] = dict(params=st.params, m=st.m, v=st.v, count=st.count, lr=st.learning_rate,
                             metrics={k: float(x) for k, x in m.items()}, digests=digests)
        gb, _, last = make_batch(3, dones=True)
        ppo = port_ppo("xla", dp)
        tb = Transition(**{k: _half(v, rank) for k, v in gb.items()})
        out["gae"] = ppo.compute_returns(tb, _half(last, rank)[0])
        torch.save(out, os.path.join(out_dir, f"update_rank{rank}.pt"))
    finally:
        mesh.destroy(dp)


def _jax_ppo(path, mesh2=None):
    from wiki_grx_gym_tpu.envs import task_registry as jax_registry
    from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
    from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO

    _, train_cfg = jax_registry.get_cfgs("GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims = [32, 32]
    pc.critic_hidden_dims = [32, 32]
    alg = train_cfg.algorithm
    alg.fused_update = path != "xla"
    alg.num_learning_epochs = 2
    alg.num_mini_batches = 2
    alg.storage_dtype = "float32"
    alg.update_dtype = "float32"
    ppo = JaxPPO(JaxActorCritic(O, P, A, pc), alg, perm_groups=2, mesh=mesh2)
    assert ppo.fused_update == (path == "step") and (ppo.fused_dp_mesh is not None) == (path == "step")
    return ppo


@pytest.fixture(scope="module")
def dp_update(tmp_path_factory):
    """JAX's perm_groups=2 updates (xla: one device; step: a dp2 mesh) and
    the port's dp2 updates of the same batch from the same state."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
    from wiki_grx_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from wiki_grx_gym_tpu_torch.convert import ppo_state_from_numpy

    batch, returns, adv = make_batch(1)
    mesh2 = jax_make_mesh(num_mp=1, devices=jax.devices()[:2])
    key = jax.random.PRNGKey(101)
    jres, perms, state0 = {}, {}, None
    for path in ("xla", "step"):
        jppo = _jax_ppo(path, mesh2 if path == "step" else None)
        params = jppo.net.init(jax.random.PRNGKey(1))
        jst = jppo.init(params)
        jb = JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()})
        jr, ja = jnp.asarray(returns), jnp.asarray(adv)
        if path == "step":
            put = lambda x: jax.device_put(x, NamedSharding(mesh2, Pspec(None, "dp", *([None] * (x.ndim - 2)))))
            jb, jr, ja = jax.tree.map(put, jb), put(jr), put(ja)
        jst2, jm = jppo.update(jst, jb, jr, ja, key)
        count, mu, nu, _ = jppo._opt_state_pieces(jst2.opt_state, ravel_pytree(jst2.params)[0].size)
        jres[path] = dict(params=np.asarray(ravel_pytree(jst2.params)[0]), m=np.asarray(mu), v=np.asarray(nu),
                          count=int(count), lr=float(jst2.learning_rate),
                          metrics={k: float(x) for k, x in jm.items()})
        tppo = port_ppo(path)
        _, n_blocks, used, _ = tppo.shuffle_geometry(T, N // 2)
        perms[path] = torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)[:used]))
        c0, mu0, nu0, _ = jppo._opt_state_pieces(jst.opt_state, ravel_pytree(params)[0].size)
        state0 = ppo_state_from_numpy(tppo.net, params, np.asarray(mu0), np.asarray(nu0), np.asarray(c0),
                                      np.asarray(jst.learning_rate))
    gb, _, last = make_batch(3, dones=True)
    jgae = _jax_ppo("xla").compute_returns(JaxTransition(**{k: jnp.asarray(v) for k, v in gb.items()}),
                                           jnp.asarray(last[0]))
    out_dir = tmp_path_factory.mktemp("dp_update")
    spawn(update_worker, WORLD, args=(state0, perms, str(out_dir)), rendezvous_dir=str(out_dir),
          timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"update_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return jres, ranks, [np.asarray(x) for x in jgae], port_ppo("xla").net


@pytest.mark.parametrize("path", ["xla", "step"])
def test_dp2_update_matches_jax_perm_groups_2(dp_update, path):
    from wiki_grx_gym_tpu_torch.convert import flat_to_jax_order

    jres, ranks, _, net = dp_update
    got, want = ranks[0][path], jres[path]
    assert int(got["count"]) == want["count"] == 4
    np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=2e-4)
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-4, err_msg=f"{path} {k}")
    for what in ("params", "m", "v"):
        g, w = flat_to_jax_order(net, got[what]), want[what]
        for name, off, shape in net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(w[sl]).max()))
            np.testing.assert_allclose(g[sl], w[sl], rtol=2e-3, atol=atol, err_msg=f"{path}: {what} of {name}")


@pytest.mark.parametrize("path", ["xla", "step"])
def test_dp2_ranks_end_the_update_bit_identical(dp_update, path):
    _, ranks, _, _ = dp_update
    a, b = ranks[0][path], ranks[1][path]
    assert bool((a["digests"] == a["digests"][0]).all()) and torch.equal(a["digests"], b["digests"])
    for k in ("params", "m", "v", "count", "lr"):
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_dp2_gae_uses_the_global_normalisation(dp_update):
    _, ranks, (jr, ja), _ = dp_update
    returns = torch.cat([r["gae"][0] for r in ranks], dim=1).numpy()
    adv = torch.cat([r["gae"][1] for r in ranks], dim=1).numpy()
    np.testing.assert_allclose(returns, jr, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adv, ja, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# a training iteration: dp2 against one process with permutation_groups = 2
# ---------------------------------------------------------------------------

N_ENVS, STEPS = 8, 4


def iteration_cfgs():
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    cfg.control.decimation = 2
    cfg.commands.curriculum = True   # the curriculum's mean is over every rank's resetting envs
    train_cfg.runner.num_steps_per_env = STEPS
    train_cfg.algorithm.num_mini_batches = 2
    train_cfg.algorithm.num_learning_epochs = 1
    train_cfg.algorithm.fused_update = False
    train_cfg.algorithm.permutation_groups = 2
    return cfg, train_cfg


def one_process_start():
    """The one-process runner and its initial state, half the envs a few
    steps from their timeout; the injected noise, uniform blocks and block
    permutation."""
    cfg, train_cfg = iteration_cfgs()
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, train_cfg, device="cpu")
    s0 = runner.init_state()
    ep = s0.env_state.episode_length.clone()
    ep[::2] = env.max_episode_length - 2
    s0 = s0.replace(env_state=s0.env_state.replace(episode_length=ep))
    rng = np.random.RandomState(7)
    noise = torch.from_numpy(rng.randn(STEPS, N_ENVS, env.num_actions).astype(np.float32))
    u = torch.from_numpy(rng.rand(STEPS, N_ENVS, env._step_u_cols[1]).astype(np.float32))
    _, n_blocks, used, _ = runner.alg.shuffle_geometry(STEPS, N_ENVS // 2)
    perm = torch.from_numpy(rng.permutation(n_blocks)[:used])
    return runner, s0, noise, u, perm


def iteration_worker(rank, world, init, out_dir):
    _threads()
    dp = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        _, s0, noise, u, perm = one_process_start()
        cfg, train_cfg = iteration_cfgs()
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None, dp=dp)
        assert runner.alg.path == "xla" and runner.alg.local_groups == 1
        lo, hi = env.shard
        mine = lambda x: sharding.shard_env_state(x, lo, hi, N_ENVS)
        start = runner.init_state()
        # origins and terrain types follow the global index: equal to the full env's slice
        assert torch.equal(start.env_state.env_origins, mine(s0.env_state.env_origins))
        state = RunnerState(env_state=mine(s0.env_state), obs=mine(s0.obs), critic_obs=mine(s0.critic_obs),
                            rng=start.rng, ppo=start.ppo)
        state, metrics = runner.iteration(state, noise=noise[:, lo:hi], u=u[:, lo:hi], perm=perm)
        digests = sharding.check_replicas_identical(dp, state.ppo)
        # then learn(1), each rank with a log directory of its own: only rank 0 writes
        runner.log_dir = os.path.join(out_dir, f"rank{rank}", "run")
        runner.writer = False   # checkpoints only: no TensorBoard events
        runner.learn(1, state=state)
        torch.save(dict(metrics={k: float(v) for k, v in metrics.items()}, params=state.ppo.params,
                        digests=digests, cmd_range=state.env_state.cmd_lin_vel_x_range),
                   os.path.join(out_dir, f"iteration_rank{rank}.pt"))
    finally:
        mesh.destroy(dp)


@pytest.fixture(scope="module")
def dp_iteration(tmp_path_factory):
    runner, s0, noise, u, perm = one_process_start()
    assert runner.alg.path == "xla" and runner.alg.local_groups == 2   # JAX: groups > 1 in one process
    state, metrics = runner.iteration(s0, noise=noise, u=u, perm=perm)
    out_dir = tmp_path_factory.mktemp("dp_iteration")
    spawn(iteration_worker, WORLD, args=(str(out_dir),), rendezvous_dir=str(out_dir), timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"iteration_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ({k: float(v) for k, v in metrics.items()}, state), ranks, out_dir


def test_dp2_iteration_matches_one_process_with_groups_2(dp_iteration):
    (m1, s1), ranks, _ = dp_iteration
    assert m1["done_count"] == N_ENVS // 2   # the planted timeouts reset half the envs
    for r in ranks:
        for k in m1:
            np.testing.assert_allclose(r["metrics"][k], m1[k], rtol=1e-4, atol=6e-5, err_msg=k)
        np.testing.assert_allclose(r["params"].numpy(), s1.ppo.params.numpy(), rtol=2e-5, atol=4e-5)
        assert torch.equal(r["cmd_range"], s1.env_state.cmd_lin_vel_x_range)
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    assert torch.equal(ranks[0]["digests"], ranks[1]["digests"])


def test_only_rank_0_writes_and_play_loads_it(dp_iteration):
    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    _, _, out_dir = dp_iteration
    assert os.path.isfile(out_dir / "rank0" / "run" / "model_1.pt")
    assert not os.path.exists(out_dir / "rank1")
    logger = play(get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", "2"]), num_steps=2,
                  log_root=str(out_dir / "rank0"))
    assert len(logger.rew_log["rew_total"]) == 2 and all(np.isfinite(logger.rew_log["rew_total"]))
