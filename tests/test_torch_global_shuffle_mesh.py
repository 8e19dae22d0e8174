"""The update of JAX's own CLI run on a mesh, against the port's global
shuffle across ranks, eagerly, over ``torch.distributed`` (gloo, CPU).

JAX's CLI builds the runner with no mesh and sets it afterwards
(``scripts/train.py:24-26``), so its PPO keeps ``perm_groups = 1`` (the
global shuffle, ``learn/runner.py:100-108``) and the flat optimizer
(``learn/runner.py:112``); the mesh then places the learner state
(``parallel/sharding.shard_params``: the hidden layers split over mp) and
XLA runs the update on the placed operands. The JAX side here is exactly
that: a runner built through the registry without a mesh, given
``make_mesh(num_mp)`` of the conftest's fake CPU devices, its update
jitted on the learner state and the batch placed on the mesh (the batch's
envs over dp).

- **dp2 x mp2** (``train --num_mp 2`` on four devices): the port's
  ``permutation_groups = 1`` on four gloo ranks (each dp rank fed its half
  of the batch's envs, the mp peers the same half; each rank updates its
  shard of the net on the gathered global batch), hidden (32, 16, 8),
  against JAX on ``make_mesh(num_mp=2, devices=jax.devices()[:4])``.
- **dp2 with the symmetry loss** (``symmetry_coef = 0.5``,
  ``learn/runner.py:90-98``): the port's ``permutation_groups = 1`` on two
  gloo ranks against JAX's ``PPO(perm_groups=1)`` with its mirror loss on
  ``make_mesh(num_mp=1, devices=jax.devices()[:2])``.

Both sides take the xla path (JAX's ``fused_update = "auto"`` selects no
kernel off a TPU; the port's update under mp and with an extra loss term
is the xla path) and are fed the same batch (t=8, n=64, float32 storage)
and the same block permutation of the global batch
(``jax.random.permutation`` of the update's key, as JAX's shuffle draws
it), 2 epochs x 2 minibatches, from the same learner state. The
tolerances are tests/test_torch_global_shuffle.py's: params and Adam
moments at rtol 2e-3 / atol 2e-5, metrics and LR at rtol 2e-4. Under mp
JAX's flat optimizer clips by the norm of the raveled gradient, the
port's by each rank's squared shard entries summed over the mp group plus
the replicated entries once (``PPO._optax_step``): the same norm, summed
in another order, so the two differ by float32 rounding alone. Each port
update all-gathers its inputs once over the dp group and all-reduces no
gradient over it; the dp peers end bit-identical. Every spawn joins within
120 s (``parallel.launch.spawn``).
"""

import os

import numpy as np
import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.runner import Transition
from wiki_grx_gym_tpu_torch.learn.symmetry import make_mirror_loss
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn

O, P, A = 39, 168, 10   # GR1T1's: the mirror map needs its obs layout
T, N = 8, 64
HIDDEN = [32, 16, 8]    # every split dimension divisible by mp = 2
JOIN_S = 120.0
SYMMETRY_COEF = 0.5
# name: (num_mp, world, symmetry_coef)
CASES = {"dp2_mp2": (2, 4, 0.0), "dp2_symmetry": (1, 2, SYMMETRY_COEF)}


def make_batch(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = (-0.5 * (((actions - mu) / sigma) ** 2 + np.log(2 * np.pi)) - np.log(sigma)).sum(-1)
    return dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions, rewards=0.1 * f(T, N),
                dones=np.zeros((T, N), bool), values=f(T, N), log_prob=logp.astype(np.float32), mu=mu,
                sigma=sigma), f(T, N), f(T, N)


def _sizes(train_cfg, symmetry_coef):
    pc, alg = train_cfg.policy, train_cfg.algorithm
    pc.actor_hidden_dims = list(HIDDEN)
    pc.critic_hidden_dims = list(HIDDEN)
    alg.num_learning_epochs = 2
    alg.num_mini_batches = 2
    alg.storage_dtype = "float32"
    alg.update_dtype = "float32"
    alg.symmetry_coef = symmetry_coef
    return train_cfg


def port_env():
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    return task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")[0]


def port_ppo(symmetry_coef, dp=None):
    """The port's PPO as the runner builds it: ``permutation_groups = 1``,
    the mirror loss where ``symmetry_coef > 0``; with ``dp`` the rank's
    (tensor-parallel under mp) net."""
    train_cfg = _sizes(task_registry.get_cfgs("GR1T1")[1], symmetry_coef)
    net = ActorCritic(O, P, A, train_cfg.policy, mp=None if dp is None else dp.mp)
    extra = make_mirror_loss(port_env(), net, symmetry_coef) if symmetry_coef > 0 else None
    return PPO(net, train_cfg.algorithm, extra_loss_fn=extra, perm_groups=1, dp=dp)


def _threads(world):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))


def update_worker(rank, world, init, name, state0, perm, out_dir):
    """One rank: the port's update of its dp rank's half of the batch (mp
    peers the same half) from its shard of ``state0``; the result gathered
    over the mp group."""
    num_mp, _, coef = CASES[name]
    _threads(world)
    whole = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        dp = mesh.make_mesh(num_mp, whole)
        ppo = port_ppo(coef, dp)
        assert ppo.gathered and ppo.path == "xla" and ppo.local_groups == 1
        full_net = port_ppo(0.0).net
        if dp.mp is not None:
            shard = lambda x: sharding.shard_flat(full_net, x, dp.mp.world, dp.mp.rank).contiguous()
            state0 = state0.replace(params=shard(state0.params), m=shard(state0.m), v=shard(state0.v))
        seen = {"all_gather": 0, "all_reduce_sum": 0}
        for op in seen:
            orig = getattr(ppo.dp, op)

            def counted(x, *a, _orig=orig, _op=op, **k):
                seen[_op] += 1
                return _orig(x, *a, **k)

            object.__setattr__(ppo.dp, op, counted)
        batch, returns, adv = make_batch(1)
        lo, hi = sharding.shard_bounds(N, dp.world, dp.rank)
        half = lambda x: torch.from_numpy(np.ascontiguousarray(np.asarray(x)[:, lo:hi]))
        st, metrics = ppo.update(state0, Transition(**{k: half(v) for k, v in batch.items()}), half(returns),
                                 half(adv), perm=perm)
        out = {"count": st.count, "lr": st.learning_rate, "metrics": {k: float(x) for k, x in metrics.items()},
               "collectives": dict(seen), "digests": sharding.check_replicas_identical(dp, st, net=ppo.net)}
        for k in ("params", "m", "v"):
            x = getattr(st, k)
            out[k] = x if dp.mp is None else sharding.gather_flat(full_net, dp.mp.all_gather(x))
        torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        mesh.destroy(whole)


def jax_cli_update(num_mp, symmetry_coef, batch, returns, adv, key):
    """JAX's CLI order: the runner built through the registry without a
    mesh, then ``runner.mesh = make_mesh(num_mp)`` of 2 x num_mp fake CPU
    devices; its update jitted on the learner state placed as
    ``shard_runner_state`` places it and the batch's envs over dp.
    Returns (the PPO, its start params, start state, end state, metrics)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Pspec

    from wiki_grx_gym_tpu.envs import task_registry as jax_registry
    from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
    from wiki_grx_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from wiki_grx_gym_tpu.parallel.sharding import shard_params

    cfg, train_cfg = jax_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 4
    _sizes(train_cfg, symmetry_coef)
    env, _ = jax_registry.make_env("GR1T1", env_cfg=cfg)
    runner, _ = jax_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    jmesh = jax_make_mesh(num_mp=num_mp, devices=jax.devices()[:2 * num_mp])
    runner.mesh = jmesh
    ppo = runner.alg
    assert dict(jmesh.shape) == {"dp": 2, "mp": num_mp}
    assert ppo.perm_groups == 1 and ppo.flat_optimizer and not ppo.fused_update
    assert (ppo.extra_loss_fn is not None) == (symmetry_coef > 0)
    params = ppo.net.init(jax.random.PRNGKey(1))
    st0 = ppo.init(params)
    placed = st0.replace(params=shard_params(params, jmesh),
                         opt_state=jax.device_put(st0.opt_state, NamedSharding(jmesh, Pspec())),
                         learning_rate=jax.device_put(st0.learning_rate, NamedSharding(jmesh, Pspec())))
    envs = lambda x: jax.device_put(jnp.asarray(x), NamedSharding(jmesh, Pspec(None, "dp")))
    st1, metrics = jax.jit(ppo.update)(placed, JaxTransition(**{k: envs(v) for k, v in batch.items()}),
                                       envs(returns), envs(adv), key)
    return ppo, params, st0, st1, metrics


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    """JAX's update of the whole batch on its mesh, and the port's ranks'
    updates of the same batch from the same state with the same
    permutation."""
    import jax
    from jax.flatten_util import ravel_pytree

    from wiki_grx_gym_tpu_torch.convert import ppo_state_from_numpy

    name = request.param
    num_mp, world, coef = CASES[name]
    batch, returns, adv = make_batch(1)
    key = jax.random.PRNGKey(202)
    jppo, params, st0, st1, jm = jax_cli_update(num_mp, coef, batch, returns, adv, key)
    n = ravel_pytree(params)[0].size
    count, mu, nu, _ = jppo._opt_state_pieces(st1.opt_state, n)
    want = dict(params=np.asarray(ravel_pytree(st1.params)[0]), m=np.asarray(mu), v=np.asarray(nu),
                count=int(count), lr=float(st1.learning_rate), metrics={k: float(x) for k, x in jm.items()})
    one = port_ppo(0.0)
    n_blocks, used = one.perm_size(T, N)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, n_blocks)[:used]))
    c0, mu0, nu0, _ = jppo._opt_state_pieces(st0.opt_state, n)
    state0 = ppo_state_from_numpy(one.net, params, np.asarray(mu0), np.asarray(nu0), np.asarray(c0),
                                  np.asarray(st0.learning_rate))
    out_dir = tmp_path_factory.mktemp(name)
    spawn(update_worker, world, args=(name, state0, perm, str(out_dir)), rendezvous_dir=str(out_dir),
          timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]
    return name, want, ranks, one.net


def test_port_global_shuffle_matches_jax_cli_run_on_its_mesh(case):
    from wiki_grx_gym_tpu_torch.convert import flat_to_jax_order

    name, want, ranks, net = case
    for r, got in enumerate(ranks):
        assert int(got["count"]) == want["count"] == 4
        np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=2e-4)
        for k in ("value_loss", "surrogate_loss", "kl", "lr"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2e-4, err_msg=f"{name} {r} {k}")
        for what in ("params", "m", "v"):
            g, w = flat_to_jax_order(net, got[what]), want[what]
            for leaf, off, shape in net.layout:
                sl = slice(off, off + int(np.prod(shape)))
                atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(w[sl]).max()))
                np.testing.assert_allclose(g[sl], w[sl], rtol=2e-3, atol=atol,
                                           err_msg=f"{name} rank {r}: {what} of {leaf}")


def test_port_global_shuffle_gathers_once_and_the_dp_peers_end_bit_identical(case):
    name, _, ranks, _ = case
    num_mp = CASES[name][0]
    for got in ranks:
        # one gather of the update's inputs over dp; no gradient all-reduce
        # over dp (the permutation's broadcast is its only other collective)
        assert got["collectives"] == {"all_gather": 1, "all_reduce_sum": 0}, got["collectives"]
        assert bool((got["digests"] == got["digests"][0]).all())
    for a, b in zip(ranks[:num_mp], ranks[num_mp:]):   # rank r and its dp peer r + num_mp
        for k in ("params", "m", "v", "count", "lr"):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
