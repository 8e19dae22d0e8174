"""The port's mirror-symmetry loss (``learn/symmetry.py``) against the JAX
package's.

- ``mirror_dof_map`` and ``build_mirror_spec`` equal JAX's exactly (the
  permutations and signs, array for array) for GR1T1 and GR1T2; for
  GR1T1_full both packages raise the same error (no counterpart for
  ``waist_roll_joint``: the ``l_`` pattern matches inside "roll_").
- ``make_mirror_loss`` at the GR1T1 widths (obs 39, 10 actions, ELU [512,
  256, 128]) on 64 random rows: the loss at rtol 1e-5 and its gradient with
  respect to the flat params leaf by leaf at rtol 1e-4 / atol 1e-6 x the
  leaf's largest |value| (JAX at highest matmul precision; the products sum
  in another order).
- ``make_mirror_loss_recurrent`` (LSTM 32, heads [32, 32]) on an 8 x 8
  trajectory minibatch with resets: the loss and its gradient likewise.
- One xla-path update with ``symmetry_coef`` 0.5 (hidden (32, 32), 8 x 64,
  2 epochs x 2 minibatches, f32 storage, JAX's block permutation injected)
  equals JAX's ``PPO(extra_loss_fn=make_mirror_loss(...))`` update at
  tests/test_torch_ppo_update.py's tolerances: params and Adam moments rtol
  2e-3 / atol 2e-5, metrics and LR rtol 2e-4.
- The runner takes ``symmetry_coef > 0`` (it refused it before) for the MLP
  and the recurrent net, on the xla path.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_ppo_update import jax_state_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn import symmetry as jsym
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu.learn.recurrent import ActorCriticRecurrent as JaxRecurrent
from wiki_grx_gym_tpu_torch.convert import flat_from_jax_order, flat_to_jax_order, ppo_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn import symmetry as tsym
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, Transition


def envs(task):
    out = []
    for reg, kw in ((jax_registry, {}), (task_registry, {"device": "cpu"})):
        cfg, _ = reg.get_cfgs(task)
        cfg.env.num_envs = 2
        out.append(reg.make_env(task, env_cfg=cfg, **kw)[0])
    return out


@pytest.fixture(scope="module")
def gr1t1():
    return envs("GR1T1")


def test_full_body_mirror_map_fails_as_jax_does():
    """Reference hazard, pinned (ROADMAP queue 3): the name patterns ``l_``
    and ``_l`` match inside ``waist_roll_joint`` (``rol[l_]joint``), which
    has no counterpart, so both packages refuse the 32-DOF body's map with
    the same error."""
    jenv, tenv = envs("GR1T1_full")
    errors = []
    for sym, env in ((jsym, jenv), (tsym, tenv)):
        with pytest.raises(ValueError, match="no mirror counterpart") as e:
            sym.build_mirror_spec(env)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "no mirror counterpart for dof 'waist_roll_joint'"


@pytest.mark.parametrize("task", ["GR1T1", "GR1T2"])
def test_mirror_spec_equals_jax(task, gr1t1):
    jenv, tenv = gr1t1 if task == "GR1T1" else envs(task)
    jp, js = jsym.mirror_dof_map(jenv.model)
    tp, ts = tsym.mirror_dof_map(tenv.model)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    jspec, tspec = jsym.build_mirror_spec(jenv), tsym.build_mirror_spec(tenv)
    for field in tsym.MirrorSpec._fields:
        a, b = getattr(tspec, field), np.asarray(getattr(jspec, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert len(tspec.obs_perm) == tenv.obs_dim


def _grads_match(tnet, g_torch, g_jax, rtol=1e-4, atol_frac=1e-6):
    got = flat_to_jax_order(tnet, g_torch)
    want = np.asarray(ravel_pytree(g_jax)[0])
    for name, off, shape in tnet.layout:
        sl = slice(off, off + int(np.prod(shape)))
        np.testing.assert_allclose(got[sl], want[sl], rtol=rtol,
                                   atol=atol_frac * max(1e-30, float(np.abs(want[sl]).max())), err_msg=name)


def _torch_loss_and_grad(loss_fn, flat, mb):
    p = flat.clone().requires_grad_(True)
    loss = loss_fn(p, mb)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g


def test_mirror_loss_and_gradient_equal_jax(gr1t1):
    jenv, tenv = gr1t1
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    jnet = JaxActorCritic(jenv.obs_dim, jenv.pri_obs_dim, jenv.num_actions, jax_registry.get_cfgs("GR1T1")[1].policy)
    tnet = ActorCritic(tenv.obs_dim, tenv.pri_obs_dim, tenv.num_actions, train_cfg.policy)
    params = jnet.init(jax.random.PRNGKey(3))
    flat = torch.from_numpy(flat_from_jax_order(tnet, np.asarray(ravel_pytree(params)[0])))
    obs = np.random.RandomState(3).randn(64, jenv.obs_dim).astype(np.float32)
    jloss = jsym.make_mirror_loss(jenv, jnet, 0.5)
    loss, g = _torch_loss_and_grad(tsym.make_mirror_loss(tenv, tnet, 0.5), flat, {"obs": torch.from_numpy(obs)})
    want, jg = jax.value_and_grad(jloss)(params, {"obs": jnp.asarray(obs)})
    assert loss > 1e-6
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    _grads_match(tnet, g, jg)


def test_recurrent_mirror_loss_equals_jax(gr1t1):
    jenv, tenv = gr1t1
    nets = []
    for reg, cls in ((jax_registry, JaxRecurrent), (task_registry, ActorCriticRecurrent)):
        _, train_cfg = reg.get_cfgs("GR1T1_lstm")
        pc = train_cfg.policy
        pc.rnn_hidden_size = 32
        pc.actor_hidden_dims = [32, 32]
        pc.critic_hidden_dims = [32, 32]
        nets.append(cls(jenv.obs_dim, jenv.pri_obs_dim, jenv.num_actions, pc))
    jnet, tnet = nets
    params = jnet.init(jax.random.PRNGKey(4))
    flat = torch.from_numpy(flat_from_jax_order(tnet, np.asarray(ravel_pytree(params)[0])))
    rng = np.random.RandomState(4)
    obs = rng.randn(8, 8, jenv.obs_dim).astype(np.float32)
    done_prev = (rng.rand(8, 8) < 0.2).astype(np.float32)
    done_prev[0] = 0.0
    loss, g = _torch_loss_and_grad(tsym.make_mirror_loss_recurrent(tenv, tnet, 0.5), flat,
                                   {"obs": torch.from_numpy(obs), "done_prev": torch.from_numpy(done_prev)})
    want, jg = jax.value_and_grad(jsym.make_mirror_loss_recurrent(jenv, jnet, 0.5))(
        params, {"obs": jnp.asarray(obs), "done_prev": jnp.asarray(done_prev)})
    assert loss > 1e-6
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    _grads_match(tnet, g, jg)


T, N = 8, 64


def test_update_with_the_mirror_loss_equals_jax(gr1t1):
    jenv, tenv = gr1t1
    O, Pc, A = tenv.obs_dim, tenv.pri_obs_dim, tenv.num_actions
    ppos = []
    for reg, cls, ppo_cls, sym, env in ((jax_registry, JaxActorCritic, JaxPPO, jsym, jenv),
                                        (task_registry, ActorCritic, PPO, tsym, tenv)):
        _, train_cfg = reg.get_cfgs("GR1T1")
        pc = train_cfg.policy
        pc.actor_hidden_dims = [32, 32]
        pc.critic_hidden_dims = [32, 32]
        alg = train_cfg.algorithm
        alg.num_learning_epochs = 2
        alg.num_mini_batches = 2
        alg.storage_dtype = "float32"
        alg.update_dtype = "float32"
        net = cls(O, Pc, A, pc)
        ppos.append(ppo_cls(net, alg, extra_loss_fn=sym.make_mirror_loss(env, net, 0.5)))
    jppo, tppo = ppos
    assert not jppo.fused_update and tppo.path == "xla"

    rng = np.random.RandomState(5)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = np.asarray(JaxActorCritic.log_prob(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(actions)))
    batch = dict(obs=f(T, N, O), critic_obs=f(T, N, Pc), actions=actions, rewards=0.1 * f(T, N),
                 dones=np.zeros((T, N), bool), values=f(T, N), log_prob=logp, mu=mu, sigma=sigma)
    returns, adv = f(T, N), f(T, N)
    params = jppo.net.init(jax.random.PRNGKey(5))
    jst = jppo.init(params)
    key = jax.random.PRNGKey(105)
    jst2, jm = jppo.update(jst, JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()}),
                           jnp.asarray(returns), jnp.asarray(adv), key)
    _, n_blocks, used, _ = tppo.shuffle_geometry(T, N)
    perm = np.asarray(jax.random.permutation(key, n_blocks)[:used])
    tst = ppo_state_from_numpy(tppo.net, *jax_state_numpy(jppo, jst))
    tb = Transition(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    tst2, tm = tppo.update(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv), perm=perm)

    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, err_msg=k)
    jp, jmu, jnu, jcount, jlr = jax_state_numpy(jppo, jst2)
    assert int(tst2.count) == int(jcount) == 4
    for got, want, what in ((tst2.params, ravel_pytree(jp)[0], "params"), (tst2.m, jmu, "Adam m"),
                            (tst2.v, jnu, "Adam v")):
        got, want = flat_to_jax_order(tppo.net, got), np.asarray(want)
        for name, off, shape in tppo.net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(want[sl]).max()))
            np.testing.assert_allclose(got[sl], want[sl], rtol=2e-3, atol=atol, err_msg=f"{what} of {name}")
    # the loss term matters at these tolerances: the update without it
    # fails the same check against JAX's update with it
    cfg = copy.copy(tppo.cfg)
    cfg.fused_update = False
    tst3, _ = PPO(tppo.net, cfg).update(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv), perm=perm)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(flat_to_jax_order(tppo.net, tst3.params), np.asarray(ravel_pytree(jp)[0]),
                                   rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("task", ["GR1T1", "GR1T1_lstm"])
def test_runner_takes_the_symmetry_loss(task, gr1t1):
    _, tenv = gr1t1
    _, train_cfg = task_registry.get_cfgs(task)
    train_cfg.algorithm.symmetry_coef = 0.5
    runner = OnPolicyRunner(tenv, train_cfg, device="cpu")
    assert runner.alg.extra_loss_fn is not None and runner.alg.path == "xla"
    assert runner.recurrent == (task == "GR1T1_lstm")
