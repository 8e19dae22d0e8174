"""The port's PPO update, GAE and state conversion against the JAX package.

- ``PPO.update`` on each of the port's three paths against the matching JAX
  path (``fused_update``/``fused_mega`` forced; f32 storage, so the kernels'
  plain versions run with f32 operands and the JAX kernels in interpreter
  mode): ``mega`` (K3's plain version) vs the JAX whole-update kernel,
  ``step`` (K2's plain version + torch clip/Adam) vs the JAX per-step kernel
  + optax, ``xla`` (torch.autograd) vs the JAX XLA scan. t=8, n=64, hidden
  (32, 32), 2 epochs x 2 minibatches, the block permutation computed in JAX
  from the update key and injected. Params and Adam moments at rtol 2e-3 /
  atol 2e-5 (as tests/test_fused_update.py holds the JAX paths to each
  other), metrics and LR at rtol 2e-4.
- The same with the std floor at 0.3 (above the 0.2 init), where the paths
  differ by design: the xla loss differentiates through max(std, floor), the
  kernels use the raw std. Each port path is held to its own JAX path, and
  every path ends with std >= floor.
- GAE (``compute_returns``) with dones, at rtol 1e-5 (the JAX package sums
  the recurrence as a parallel prefix, the port as a reverse loop).
- ``convert.ppo_state_from_numpy``: JAX params and optax state into the
  port's ``PPOState`` and back, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.convert import flat_to_jax_order, ppo_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.runner import Transition

O, P, A = 39, 168, 23
T, N = 8, 64


def make(path, floor=0.0):
    """(JAX PPO, port PPO) on the given path, hidden (32, 32)."""
    out = []
    for reg, cls, ppo_cls in ((jax_registry, JaxActorCritic, JaxPPO),
                              (task_registry, ActorCritic, PPO)):
        _, train_cfg = reg.get_cfgs("GR1T1")
        pc = train_cfg.policy
        pc.actor_hidden_dims = [32, 32]
        pc.critic_hidden_dims = [32, 32]
        pc.noise_std_floor = floor
        alg = train_cfg.algorithm
        alg.fused_update = path != "xla"
        alg.fused_mega = path == "mega"
        alg.num_learning_epochs = 2
        alg.num_mini_batches = 2
        alg.storage_dtype = "float32"
        alg.update_dtype = "float32"
        out.append(ppo_cls(cls(O, P, A, pc), alg))
    assert out[0].fused_update == out[1].fused_update == (path != "xla")
    assert out[1].path == path
    return out


def make_batch(seed, dones=False):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = np.asarray(JaxActorCritic.log_prob(jnp.asarray(mu), jnp.asarray(sigma),
                                               jnp.asarray(actions)))
    return dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions,
                rewards=0.1 * f(T, N), dones=(rng.rand(T, N) < 0.1) if dones else np.zeros((T, N), bool),
                values=f(T, N), log_prob=logp, mu=mu, sigma=sigma), f(T, N), f(T, N)


def jax_state_numpy(jppo, st):
    count, mu, nu, _ = jppo._opt_state_pieces(st.opt_state, ravel_pytree(st.params)[0].size)
    return st.params, np.asarray(mu), np.asarray(nu), np.asarray(count), np.asarray(st.learning_rate)


def run_both(path, floor=0.0, seed=0):
    jppo, tppo = make(path, floor)
    batch, returns, adv = make_batch(seed)
    params = jppo.net.init(jax.random.PRNGKey(seed))
    jst = jppo.init(params)
    key = jax.random.PRNGKey(100 + seed)
    jst2, jm = jppo.update(jst, JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()}),
                           jnp.asarray(returns), jnp.asarray(adv), key)
    _, n_blocks, used, _ = tppo.shuffle_geometry(T, N)
    perm = np.asarray(jax.random.permutation(key, n_blocks)[:used])

    tst = ppo_state_from_numpy(tppo.net, *jax_state_numpy(jppo, jst))
    tb = Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    before = dict(LAUNCHES)
    tst2, tm = tppo.update(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv), perm=perm)
    assert LAUNCHES == before   # CPU tensors launch no kernel
    return jppo, jst2, jm, tppo, tst2, tm


@pytest.fixture(scope="module", params=["mega", "step", "xla"])
def updated(request):
    return request.param, run_both(request.param, seed=1)


def test_update_metrics_and_lr_match(updated):
    path, (_, _, jm, _, _, tm) = updated
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, err_msg=f"{path} {k}")


def test_update_params_and_moments_match(updated):
    path, (jppo, jst2, _, tppo, tst2, _) = updated
    jp, jmu, jnu, jcount, jlr = jax_state_numpy(jppo, jst2)
    assert int(tst2.count) == int(jcount) == 4
    np.testing.assert_allclose(float(tst2.learning_rate), float(jlr), rtol=2e-4)
    for got, want, what in ((tst2.params, ravel_pytree(jp)[0], "params"),
                            (tst2.m, jmu, "Adam m"), (tst2.v, jnu, "Adam v")):
        got, want = flat_to_jax_order(tppo.net, got), np.asarray(want)
        for name, off, shape in tppo.net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(want[sl]).max()))
            np.testing.assert_allclose(got[sl], want[sl], rtol=2e-3, atol=atol,
                                       err_msg=f"{path}: {what} of {name}")


@pytest.mark.parametrize("path", ["mega", "step", "xla"])
def test_std_floor_on_every_path(path):
    jppo, jst2, jm, tppo, tst2, tm = run_both(path, floor=0.3, seed=2)
    std = tst2.params[tppo.net.layout[-1][1]:]
    assert float(std.min()) >= 0.3 - 1e-6
    np.testing.assert_allclose(flat_to_jax_order(tppo.net, tst2.params),
                               np.asarray(ravel_pytree(jst2.params)[0]), rtol=2e-3, atol=2e-5)
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, err_msg=k)


def test_gae_matches_jax():
    jppo, tppo = make("xla")
    batch, _, last = make_batch(3, dones=True)
    last = last[0]
    assert batch["dones"].any()
    jb = JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()})
    jr, ja = jppo.compute_returns(jb, jnp.asarray(last))
    tb = Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    tr, ta = tppo.compute_returns(tb, torch.from_numpy(last))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)


def test_ppo_state_from_numpy_round_trip():
    jppo, tppo = make("xla")
    params = jppo.net.init(jax.random.PRNGKey(4))
    st = jppo.init(params)
    flat = ravel_pytree(params)[0]
    rng = np.random.RandomState(4)
    mu = rng.randn(flat.size).astype(np.float32)
    nu = rng.rand(flat.size).astype(np.float32)
    tst = ppo_state_from_numpy(tppo.net, params, mu, nu, np.int32(7), np.float32(3e-4))
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.params), np.asarray(flat))
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.m), mu)
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.v), nu)
    assert tst.count.dtype == torch.int32 and int(tst.count) == 7
    assert float(tst.learning_rate) == float(np.float32(3e-4))
    # the port's layout holds W (out, in): the first actor weight transposed
    w0 = np.asarray(params.actor[0][0])
    tppo.net.bind(tst.params)
    np.testing.assert_array_equal(tppo.net.actor[0].weight.numpy(), w0.T)
    assert jppo.init(params).learning_rate == st.learning_rate


@pytest.mark.parametrize("field,value", [
    ("update_dtype", "bfloat16"),
    ("remat_update", True),
])
def test_update_refuses_what_gr1t1_does_not_use(field, value):
    """PPO builds and honours ``update_dtype`` / ``remat_update`` (refused
    before, ROADMAP item 16): bf16 moves the xla loss by bf16 rounding and
    runs K2 on bf16 operands even at f32 storage (JAX ``ppo.py:469-473``);
    remat leaves the xla gradient bit for bit. Their parity with JAX is
    ``tests/test_torch_dtype_options.py``."""
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    alg = train_cfg.algorithm
    alg.storage_dtype = "float32"
    alg.fused_update = False
    net = ActorCritic(39, 168, 10, train_cfg.policy, generator=torch.Generator().manual_seed(0))
    base = PPO(net, alg)
    setattr(alg, field, value)
    ppo = PPO(net, alg)
    rng = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    mu = 0.3 * f(64, 10)
    mb = dict(obs=f(64, 39), critic_obs=f(64, 168), actions=mu + 0.2 * f(64, 10), log_prob=f(64), mu=mu,
              sigma=torch.full((64, 10), 0.2), values=f(64), returns=f(64), advantages=f(64))
    l0, g0, _ = base.loss_and_grad(net.params_flat, mb)
    l1, g1, _ = ppo.loss_and_grad(net.params_flat, mb)
    if field == "update_dtype":
        assert ppo.update_dtype == torch.bfloat16 and not ppo.remat_update
        assert ppo._get_fused(64).op_dtype == torch.bfloat16 and base._get_fused(64).op_dtype == torch.float32
        assert not torch.equal(g0, g1) and torch.allclose(l0, l1, rtol=1e-2)
    else:
        assert ppo.remat_update and ppo.update_dtype is None
        assert torch.equal(l0, l1) and torch.equal(g0, g1)
    # group-local shuffles (refused before, item 14): in one process JAX's
    # perm_groups > 1 runs its xla path (ppo.py:165-168), and so does the port's
    alg = task_registry.get_cfgs("GR1T1")[1].algorithm
    assert PPO(net, alg, perm_groups=2).path == "xla" and PPO(net, alg).path == "mega"


def test_runner_refuses_the_symmetry_loss():
    """The runner refused ``symmetry_coef > 0`` (item 13) before; it now
    adds the mirror loss through PPO's ``extra_loss_fn``, on the xla path
    (``FusedPPOGrad.supported`` is false with an extra loss term)."""
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    train_cfg.algorithm.symmetry_coef = 0.5
    runner = OnPolicyRunner(env, train_cfg, device="cpu")
    assert runner.alg.extra_loss_fn is not None and runner.alg.path == "xla"
