"""Tensor parallelism of the port (``--num_mp``) over ``torch.distributed``
(gloo, CPU), against the JAX package's ``shard_params`` and the port's
one-process and dp-only runs.

- ``parallel.sharding.shard_flat``/``gather_flat`` round-trip a whole flat
  buffer bit for bit, and each mp rank's shard equals the data JAX's
  ``shard_params`` puts on that rank's device of a ``("dp", "mp")`` mesh of
  the conftest's fake CPU devices (W transposed: the port keeps (out, in)).
  A tensor-parallel net drawn from a seed holds the shard of the one-process
  net drawn from it; the LSTM memories are replicated.
- Two gloo ranks at mp2 (dp1): the forwards (``action_mean``, ``evaluate``,
  ``joint_mean_value``; an actor whose last layer is column-parallel, its
  output gathered) and the xla loss's gradient, gathered, against the
  one-process net at float32 tolerance (rtol 1e-5 / atol 1e-6; the
  row-parallel partial products sum in another order), the bf16 forward at
  ``tests/test_learn.py:306``'s bounds (1e-2 / 2e-2); the mirror-symmetry
  loss and the LSTM net's update loss likewise; a checkpoint written at mp1
  loads at mp2 (each rank holds ``shard_flat`` of it), one written at mp2
  loads at mp1 (the gathered net), and ``full_net()`` exports what an mp1
  run with those weights exports.
- dp2 x mp2 (4 ranks) against dp2 x mp1 (2 ranks) at
  ``tests/test_parallel.py::test_mp1_vs_mp2_training_step_equivalence``'s
  sizes and tolerances: 16 envs, 4 steps, 2 minibatches, 1 epoch, the xla
  update, ``permutation_groups`` 4 and then 2, two iterations each; metrics
  rtol 1e-4 / atol 2e-5, params rtol 2e-5 / atol 4e-5 entry by entry, save
  entries whose dp-mean gradient cancelled to float32 noise (at most 5e-5
  of them, held within the Adam steps' reach: see the test). mp peers end
  bit-identical. With ``tests/test_torch_parallel.py`` (port dp2 against
  JAX's perm_groups=2 update) this chains the port's mp2 to JAX.
- Every spawn joins within 120 s (``parallel.launch.spawn``).
"""

import math
import os

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic, split_axis
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn

JOIN_S = 120.0
O, P, A = 39, 168, 10
ROWS = 48


def _threads(world):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def small_cfg(recurrent=False):
    _, train_cfg = task_registry.get_cfgs("GR1T1_lstm" if recurrent else "GR1T1")
    pc = train_cfg.policy
    pc.actor_hidden_dims = [32, 16, 8]
    pc.critic_hidden_dims = [32, 16, 8]
    if recurrent:
        pc.rnn_hidden_size = 16
    alg = train_cfg.algorithm
    alg.fused_update = False
    alg.storage_dtype = "float32"
    return train_cfg


def minibatch(seed, lead=()):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*lead, *s).astype(np.float32))
    mu = 0.3 * f(ROWS, A)
    return dict(obs=f(ROWS, O), critic_obs=f(ROWS, P), actions=mu + 0.2 * f(ROWS, A), log_prob=f(ROWS), mu=mu,
                sigma=torch.full((*lead, ROWS, A), 0.2), values=f(ROWS), returns=f(ROWS), advantages=f(ROWS))


# ---------------------------------------------------------------------------
# the shard layout
# ---------------------------------------------------------------------------

def test_shard_flat_round_trip_and_jax_shard_params():
    import jax
    from jax.flatten_util import ravel_pytree

    from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
    from wiki_grx_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from wiki_grx_gym_tpu.parallel.sharding import shard_params
    from wiki_grx_gym_tpu_torch.convert import flat_from_jax_order

    train_cfg = small_cfg()
    jnet = JaxActorCritic(O, P, A, train_cfg.policy)
    params = jnet.init(jax.random.PRNGKey(3))
    net = ActorCritic(O, P, A, train_cfg.policy)
    full = torch.from_numpy(flat_from_jax_order(net, np.asarray(ravel_pytree(params)[0])))
    jmesh = jax_make_mesh(num_mp=2, devices=jax.devices()[:8])
    assert dict(jmesh.shape) == {"dp": 4, "mp": 2}
    placed = shard_params(params, jmesh)
    jleaves = [x for stack in (placed.actor, placed.critic) for pair in stack for x in pair] + [placed.std]
    shards = [sharding.shard_flat(net, full, 2, j) for j in range(2)]
    assert torch.equal(sharding.gather_flat(net, shards), full)
    assert torch.equal(sharding.gather_flat(net, torch.stack(shards)), full)
    tp = ActorCritic(O, P, A, train_cfg.policy, mp=mesh.TensorParallel(world=2, rank=0, device=torch.device("cpu")))
    assert tp.num_params == shards[0].numel() < net.num_params
    for j in range(2):
        dev = jmesh.devices[0, j]
        for (name, off, shape), leaf in zip(tp.layout, jleaves):
            want = next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev)
            got = shards[j][off: off + math.prod(shape)].reshape(shape).numpy()
            np.testing.assert_array_equal(got.T if got.ndim == 2 else got, want, err_msg=f"mp {j} {name}")
            assert (split_axis(name) is None) == (want.shape == np.asarray(leaf).shape), name
    # a tensor-parallel net drawn from a seed holds the shard of the one-process net's draws
    g = lambda: torch.Generator().manual_seed(11)
    one = ActorCritic(O, P, A, train_cfg.policy, generator=g())
    for j in range(2):
        tpj = ActorCritic(O, P, A, train_cfg.policy, generator=g(),
                          mp=mesh.TensorParallel(world=2, rank=j, device=torch.device("cpu")))
        assert torch.equal(tpj.params_flat, sharding.shard_flat(one, one.params_flat, 2, j))
    # the recurrent net: the memories replicated, the heads split
    rc = small_cfg(recurrent=True)
    one = ActorCriticRecurrent(O, P, A, rc.policy, generator=g())
    tp0 = ActorCriticRecurrent(O, P, A, rc.policy, generator=g(),
                               mp=mesh.TensorParallel(world=2, rank=0, device=torch.device("cpu")))
    sh = sharding.shard_flat(one, one.params_flat, 2, 0)
    assert torch.equal(tp0.params_flat, sh)
    assert torch.equal(tp0.memories()[0][0][0], one.memories()[0][0][0])
    with pytest.raises(ValueError, match="not divisible"):
        ActorCritic(O, P, A, small_cfg().policy, mp=mesh.TensorParallel(world=3, rank=0, device=torch.device("cpu")))


# ---------------------------------------------------------------------------
# mp2 over two gloo ranks: forwards, gradients, checkpoints, export
# ---------------------------------------------------------------------------

def _grad(fn, p):
    with torch.enable_grad():
        pr = p.detach().requires_grad_(True)
        out = fn(pr)
        (g,) = torch.autograd.grad(out, pr)
    return out.detach(), g


def forward_worker(rank, world, init, out_dir):
    from wiki_grx_gym_tpu_torch.learn.symmetry import make_mirror_loss
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
    from wiki_grx_gym_tpu_torch.utils.helpers import export_policy_npz

    _threads(world)
    group = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        dp = mesh.make_mesh(2, group)
        assert dp.world == 1 and dp.mp.world == 2 and dp.mp.rank == rank and dp.is_lead == (rank == 0)
        mp, out = dp.mp, {}
        gather = lambda net, x: sharding.gather_flat(net, mp.all_gather(x))
        train_cfg = small_cfg()
        net = ActorCritic(O, P, A, train_cfg.policy, generator=torch.Generator().manual_seed(5), mp=mp)
        ppo = PPO(net, train_cfg.algorithm, dp=dp)
        assert ppo.path == "xla" and ppo.dp is None
        mb = minibatch(1)
        out["mean"] = net.action_mean(mb["obs"])
        out["value"] = net.evaluate(mb["critic_obs"])
        out["joint"] = net.joint_mean_value(mb["obs"], mb["critic_obs"])
        out["mean_bf16"] = net.action_mean(mb["obs"], dtype=torch.bfloat16)
        loss, g, _ = ppo.loss_and_grad(net.params_flat, mb)
        out["loss"], out["grad"] = loss, gather(net, g)
        # the clip's global norm over the shards: the one-process norm of the gathered gradient
        p2, *_ = ppo._optax_step(net.params_flat, torch.zeros_like(g), torch.zeros_like(g),
                                 torch.zeros((), dtype=torch.int32), torch.tensor(1e-3), g * 100.0)
        out["step"] = gather(net, p2)
        for flag in ("fused_trunk", "remat_update"):
            cfg = small_cfg()
            setattr(cfg.algorithm, flag, True)
            out[flag] = gather(net, PPO(net, cfg.algorithm, dp=dp).loss_and_grad(net.params_flat, mb)[1])
        # an actor that ends on a column-parallel layer: its output columns gathered
        odd = small_cfg()
        odd.policy.actor_hidden_dims = [32, 16]
        onet = ActorCritic(O, P, A, odd.policy, generator=torch.Generator().manual_seed(7), mp=mp)
        _, og = _grad(lambda p: onet.action_mean(mb["obs"], flat=p).square().sum(), onet.params_flat)
        out["odd_mean"], out["odd_grad"] = onet.action_mean(mb["obs"]), gather(onet, og)
        cfg, _ = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = 2
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu", dp=dp)
        sym = make_mirror_loss(env, net, 0.5)
        t, gs = _grad(lambda p: sym(p, mb), net.params_flat)
        out["sym"], out["sym_grad"] = t, gather(net, gs)
        # the LSTM net's update loss over an (8, M) replay with resets
        rc = small_cfg(recurrent=True)
        rnet = ActorCriticRecurrent(O, P, A, rc.policy, generator=torch.Generator().manual_seed(6), mp=mp)
        rppo = PPO(rnet, rc.algorithm, dp=dp)
        rmb = minibatch(2, lead=(8,))
        rmb["done_prev"] = torch.from_numpy((np.random.RandomState(3).rand(8, ROWS) < 0.2).astype(np.float32))
        rmb["hidden0"] = rnet.initial_hidden(ROWS)
        rl, rg = _grad(lambda p: rppo._minibatch_loss_recurrent(p, rmb)[0], rnet.params_flat)
        out["lstm_loss"], out["lstm_grad"] = rl, gather(rnet, rg)
        # checkpoints: an mp1 file loads here as its shards; the mp2 save is the gathered net
        runner = OnPolicyRunner(env, small_cfg(), device="cpu", dp=dp)
        runner.load(os.path.join(out_dir, "mp1.pt"))
        out["loaded_shard"] = runner.net.params_flat.clone()
        state = runner.init_state()
        runner.save(os.path.join(out_dir, "mp2.pt"), state)
        export_policy_npz(runner.full_net(state), os.path.join(out_dir, f"export_rank{rank}.npz"))
        with pytest.raises(ValueError, match="tensor-parallel shard"):
            export_policy_npz(runner.net, os.path.join(out_dir, "no.npz"))
        out["shard"] = state.ppo.params
        torch.save(out, os.path.join(out_dir, f"forward_rank{rank}.pt"))
    finally:
        mesh.destroy(group)


@pytest.fixture(scope="module")
def mp2(tmp_path_factory):
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

    out_dir = tmp_path_factory.mktemp("mp2")
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    one = OnPolicyRunner(env, small_cfg(), device="cpu")
    st = one.init_state()
    st = st.replace(ppo=st.ppo.replace(params=st.ppo.params + 0.01 * torch.randn(one.net.num_params),
                                       m=torch.rand(one.net.num_params), count=torch.tensor(3, dtype=torch.int32)))
    one.save(str(out_dir / "mp1.pt"), st)
    spawn(forward_worker, 2, args=(str(out_dir),), rendezvous_dir=str(out_dir), timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"forward_rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, out_dir, one, st


def close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol, atol=atol, err_msg=what)


def test_mp2_forward_and_gradient_equal_one_process(mp2):
    ranks, _, _, _ = mp2
    train_cfg = small_cfg()
    net = ActorCritic(O, P, A, train_cfg.policy, generator=torch.Generator().manual_seed(5))
    ppo = PPO(net, train_cfg.algorithm)
    mb = minibatch(1)
    mean, value = net.action_mean(mb["obs"]), net.evaluate(mb["critic_obs"])
    loss, g, _ = ppo.loss_and_grad(net.params_flat, mb)
    for r in ranks:
        close(r["mean"], mean, what="mean")
        close(r["value"], value, what="value")
        close(r["joint"][0], mean, what="joint mean")
        close(r["joint"][1], value, what="joint value")
        close(r["loss"], loss, what="loss")
        close(r["grad"], g, atol=1e-6 * float(g.abs().max()), what="gradient")
        assert float((r["mean_bf16"] - mean).abs().max()) < 1e-2   # tests/test_learn.py:306
        p2, *_ = ppo._optax_step(net.params_flat, torch.zeros_like(g), torch.zeros_like(g),
                                 torch.zeros((), dtype=torch.int32), torch.tensor(1e-3), g * 100.0)
        close(r["step"], p2, what="clipped Adam step")
        for flag in ("fused_trunk", "remat_update"):
            cfg = small_cfg()
            setattr(cfg.algorithm, flag, True)
            close(r[flag], PPO(net, cfg.algorithm).loss_and_grad(net.params_flat, mb)[1],
                  atol=1e-6 * float(g.abs().max()), what=flag)
    assert torch.equal(ranks[0]["grad"], ranks[1]["grad"]) and torch.equal(ranks[0]["mean"], ranks[1]["mean"])
    odd = small_cfg()
    odd.policy.actor_hidden_dims = [32, 16]
    onet = ActorCritic(O, P, A, odd.policy, generator=torch.Generator().manual_seed(7))
    _, og = _grad(lambda p: onet.action_mean(mb["obs"], flat=p).square().sum(), onet.params_flat)
    for r in ranks:
        close(r["odd_mean"], onet.action_mean(mb["obs"]), what="column-parallel last layer")
        close(r["odd_grad"], og, atol=1e-6 * float(og.abs().max()), what="its gradient")


def test_mp2_symmetry_loss_and_lstm_net(mp2):
    from wiki_grx_gym_tpu_torch.learn.symmetry import make_mirror_loss

    ranks, _, _, _ = mp2
    train_cfg = small_cfg()
    net = ActorCritic(O, P, A, train_cfg.policy, generator=torch.Generator().manual_seed(5))
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    mb = minibatch(1)
    t, gs = _grad(lambda p: make_mirror_loss(env, net, 0.5)(p, mb), net.params_flat)
    rc = small_cfg(recurrent=True)
    rnet = ActorCriticRecurrent(O, P, A, rc.policy, generator=torch.Generator().manual_seed(6))
    rmb = minibatch(2, lead=(8,))
    rmb["done_prev"] = torch.from_numpy((np.random.RandomState(3).rand(8, ROWS) < 0.2).astype(np.float32))
    rmb["hidden0"] = rnet.initial_hidden(ROWS)
    rl, rg = _grad(lambda p: PPO(rnet, rc.algorithm)._minibatch_loss_recurrent(p, rmb)[0], rnet.params_flat)
    assert float(t) > 0 and float(rg.abs().max()) > 0
    for r in ranks:
        close(r["sym"], t, what="mirror loss")
        close(r["sym_grad"], gs, atol=1e-6 * float(gs.abs().max()), what="mirror loss gradient")
        close(r["lstm_loss"], rl, what="LSTM loss")
        close(r["lstm_grad"], rg, atol=1e-6 * float(rg.abs().max()), what="LSTM gradient")


def test_checkpoints_and_exports_cross_mp(mp2):
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
    from wiki_grx_gym_tpu_torch.utils.helpers import export_policy_npz

    ranks, out_dir, one, st = mp2
    for j, r in enumerate(ranks):   # mp1 -> mp2: each rank holds its shard of the file
        assert torch.equal(r["loaded_shard"], sharding.shard_flat(one.net, st.ppo.params, 2, j))
    ck = torch.load(out_dir / "mp2.pt", weights_only=True)   # mp2 -> mp1: the gathered net
    full = sharding.gather_flat(one.net, [r["shard"] for r in ranks])
    assert torch.equal(ck["params"], full) and ck["params"].shape == (one.net.num_params,)
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    back = OnPolicyRunner(env, small_cfg(), device="cpu")
    back.load(str(out_dir / "mp2.pt"))
    assert torch.equal(back.net.params_flat, full) and int(back.current_learning_iteration) == int(ck["iter"])
    export_policy_npz(back.net, str(out_dir / "export_mp1.npz"))
    want = np.load(out_dir / "export_mp1.npz")
    for r in range(2):
        got = np.load(out_dir / f"export_rank{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# training iterations: dp2 x mp2 against dp2 x mp1
# ---------------------------------------------------------------------------

N_ENVS, STEPS, ITERS = 16, 4, 2


def iteration_worker(rank, world, init, num_mp, out_dir):
    _threads(world)
    group = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        dp = mesh.make_mesh(num_mp, group)
        out = {}
        for groups in (4, 2):
            cfg, train_cfg = task_registry.get_cfgs("GR1T1")
            cfg.env.num_envs = N_ENVS
            train_cfg.runner.num_steps_per_env = STEPS
            train_cfg.algorithm.num_mini_batches = 2
            train_cfg.algorithm.num_learning_epochs = 1
            train_cfg.algorithm.permutation_groups = groups
            train_cfg.algorithm.fused_update = False
            env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, dp=dp)
            runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None, dp=dp)
            assert runner.alg.path == "xla" and env.num_envs == N_ENVS // 2
            cond = []
            if num_mp == 1:
                # each grad step's |dp mean of the gradient| over the ranks'
                # mean |gradient|, entry by entry (where it is ~1e-7, the
                # mean is a cancellation at float32 noise: Adam's normalized
                # step takes its sign from the rounding)
                alg, reduce = runner.alg, runner.alg.reduce

                def recording(loss, g, aux):
                    scale = dp.all_reduce_sum(g.abs()) / dp.world
                    out_ = reduce(loss, g, aux)
                    cond.append(torch.where(scale > 0, out_[1].abs() / scale, torch.inf))
                    return out_
                alg.reduce = recording
            state = runner.learn(ITERS, init_at_random_ep_len=True)
            full = runner.gathered(state.ppo)
            out[groups] = dict(metrics=runner.log_history[-1]["metrics"], params=full.params,
                               digests=runner.replica_digests, lr=max(h["metrics"]["lr"] for h in runner.log_history),
                               cond=torch.stack(cond).min(0).values if cond else None,
                               env=torch.cat([t.reshape(-1).to(torch.float64)
                                              for t in sharding.tensor_leaves(state.env_state)]))
        torch.save(out, os.path.join(out_dir, f"mp{num_mp}_rank{rank}.pt"))
    finally:
        mesh.destroy(group)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dp2_mp")
    runs = {}
    for num_mp in (2, 1):
        spawn(iteration_worker, 2 * num_mp, args=(num_mp, str(out_dir)), rendezvous_dir=str(out_dir),
              timeout_s=JOIN_S)
        runs[num_mp] = [torch.load(out_dir / f"mp{num_mp}_rank{r}.pt", weights_only=False)
                        for r in range(2 * num_mp)]
    return runs


# an entry whose dp-mean gradient fell below this share of the ranks' mean
# |gradient| at some grad step of the mp1 run is a cancellation within 10x
# the two layouts' float32 noise (their rank gradients differ by ~1.2e-6 of
# their size): Adam's normalized step may take either sign there
CANCELLED = 1e-5


@pytest.mark.parametrize("groups", [4, 2])
def test_dp2_mp2_training_matches_dp2_mp1(dp2, groups):
    """test_parallel.py::test_mp1_vs_mp2_training_step_equivalence's
    tolerances, rank 0 of each layout. The params are held to them entry by
    entry, except entries whose dp-mean gradient cancelled to float32 noise
    at some step (``CANCELLED``; with these seeds actor.1.weight[117, 350],
    0.0819585 on one dp rank and -0.0819585 on the other at the first step):
    Adam's normalized step then takes its sign from the rounding, so those
    are held within the Adam steps' reach (4 x steps x the largest LR) and
    may be at most 5e-5 of the net's entries (8 and 7 of 436,885 here;
    uniform draws would give ~17 at this share over 4 grad steps)."""
    m1, p1 = dp2[1][0][groups]["metrics"], dp2[1][0][groups]["params"]
    m2, p2 = dp2[2][0][groups]["metrics"], dp2[2][0][groups]["params"]
    for k in ("value_loss", "surrogate_loss", "kl", "mean_step_reward", "done_count"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-4, atol=2e-5, err_msg=k)
    cancelled = dp2[1][0][groups]["cond"] < CANCELLED
    assert int(cancelled.sum()) <= 5e-5 * p1.numel()
    keep = ~cancelled
    np.testing.assert_allclose(p2[keep].numpy(), p1[keep].numpy(), rtol=2e-5, atol=4e-5)
    reach = 4 * ITERS * 2 * dp2[1][0][groups]["lr"]
    assert float(torch.cat([(p2 - p1)[cancelled].abs(), torch.zeros(1)]).max()) <= reach
    assert torch.equal(p1, dp2[1][1][groups]["params"])   # the dp peers of the mp1 run


@pytest.mark.parametrize("groups", [4, 2])
def test_mp_peers_end_bit_identical(dp2, groups):
    ranks = dp2[2]
    for a, b in ((0, 1), (2, 3)):   # mp peers: same env shard, same metrics, same gathered params
        x, y = ranks[a][groups], ranks[b][groups]
        assert x["metrics"] == y["metrics"] and torch.equal(x["params"], y["params"])
        assert torch.equal(x["env"], y["env"])
    for a, b in ((0, 2), (1, 3)):   # dp peers: the same digests of their shards
        assert all(torch.equal(d, e) for d, e in zip(ranks[a][groups]["digests"], ranks[b][groups]["digests"]))
    assert not torch.equal(ranks[0][groups]["env"], ranks[2][groups]["env"])   # dp shards differ
