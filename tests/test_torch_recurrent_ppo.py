"""The port's recurrent PPO update (``PPO.update_recurrent``) against the JAX
package's (``learn/ppo.py:update_recurrent``).

A small recurrent net (LSTM 32, heads [32, 32], obs 39, critic obs 168, 10
actions), a rollout buffer of 8 steps x 8 envs with dones in it (the replay
zeroes the memory there) and a random start memory ``hidden0``, 2 epochs x
2 minibatches of 4 whole env columns. The env permutation is JAX's, drawn
from the update key and passed in. The same converted params and Adam state
go in. Held as tests/test_torch_ppo_update.py holds the MLP's xla path:
params and Adam moments rtol 2e-3 / atol 2e-5 (moments atol relative to the
leaf's largest value), metrics and LR rtol 2e-4, the Adam count exact.

A second case puts a NaN advantage in one env: the minibatch that holds it
has a NaN loss, its step is skipped on both sides (zero gradient into Adam),
and the metric means are NaN on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_ppo_update import jax_state_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu.learn.recurrent import ActorCriticRecurrent as JaxRecurrent
from wiki_grx_gym_tpu.learn.recurrent import Hidden as JaxHidden
from wiki_grx_gym_tpu_torch.convert import flat_to_jax_order, ppo_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent, Hidden
from wiki_grx_gym_tpu_torch.learn.runner import Transition

O, P, A, H = 39, 168, 10, 32
T, N = 8, 8


def make():
    out = []
    for reg, cls, ppo_cls in ((jax_registry, JaxRecurrent, JaxPPO),
                              (task_registry, ActorCriticRecurrent, PPO)):
        _, train_cfg = reg.get_cfgs("GR1T1_lstm")
        pc = train_cfg.policy
        pc.rnn_hidden_size = H
        pc.actor_hidden_dims = [32, 32]
        pc.critic_hidden_dims = [32, 32]
        alg = train_cfg.algorithm
        alg.num_learning_epochs = 2
        alg.num_mini_batches = 2
        out.append(ppo_cls(cls(O, P, A, pc), alg))
    # the kernels' test holds for the recurrent net in both packages (it
    # has actor_hidden); the recurrent update never consults it (ROADMAP
    # queue 3)
    from wiki_grx_gym_tpu.learn.fused_update import FusedPPOGrad as JaxFused
    from wiki_grx_gym_tpu_torch.learn.fused_update import FusedPPOGrad

    assert JaxFused.supported(out[0].net, None) and FusedPPOGrad.supported(out[1].net, None)
    return out


def make_batch(seed, nan_env=None):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = np.asarray(JaxActorCritic.log_prob(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(actions)))
    dones = rng.rand(T, N) < 0.15
    dones[3, 1] = True
    batch = dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions, rewards=0.1 * f(T, N),
                 dones=dones, values=f(T, N), log_prob=logp, mu=mu, sigma=sigma)
    adv = f(T, N)
    if nan_env is not None:
        adv[2, nan_env] = np.nan
    hidden0 = [0.5 * f(1, N, H) for _ in range(4)]
    return batch, f(T, N), adv, hidden0


def run_both(seed, nan_env=None):
    jppo, tppo = make()
    batch, returns, adv, hidden0 = make_batch(seed, nan_env)
    params = jppo.net.init(jax.random.PRNGKey(seed))
    jst = jppo.init(params)
    key = jax.random.PRNGKey(100 + seed)
    jst2, jm = jppo.update_recurrent(
        jst, JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()}), jnp.asarray(returns),
        jnp.asarray(adv), key, JaxHidden(*(jnp.asarray(h) for h in hidden0)))
    mb_envs, used = tppo.recurrent_geometry(N)
    assert (mb_envs, used) == (4, 8)
    perm = np.asarray(jax.random.permutation(key, N)[:used])

    tst = ppo_state_from_numpy(tppo.net, *jax_state_numpy(jppo, jst))
    tb = Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    tst2, tm = tppo.update_recurrent(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv),
                                     Hidden(*(torch.from_numpy(h) for h in hidden0)), perm=perm)
    return jppo, jst2, jm, tppo, tst2, tm, perm


@pytest.fixture(scope="module", params=["finite", "nan_minibatch"])
def updated(request):
    return request.param, run_both(1, nan_env=5 if request.param == "nan_minibatch" else None)


def test_recurrent_update_metrics_and_lr_match(updated):
    case, (_, _, jm, _, _, tm, _) = updated
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        want = float(jm[k])
        if case == "nan_minibatch" and k == "surrogate_loss":
            assert np.isnan(want) and np.isnan(float(tm[k]))
            continue
        np.testing.assert_allclose(float(tm[k]), want, rtol=2e-4, err_msg=f"{case} {k}")


def test_recurrent_update_params_and_moments_match(updated):
    case, (jppo, jst2, _, tppo, tst2, _, perm) = updated
    jp, jmu, jnu, jcount, jlr = jax_state_numpy(jppo, jst2)
    assert int(tst2.count) == int(jcount) == 4
    np.testing.assert_allclose(float(tst2.learning_rate), float(jlr), rtol=2e-4)
    for got, want, what in ((tst2.params, ravel_pytree(jp)[0], "params"),
                            (tst2.m, jmu, "Adam m"), (tst2.v, jnu, "Adam v")):
        got, want = flat_to_jax_order(tppo.net, got), np.asarray(want)
        assert np.isfinite(got).all()
        for name, off, shape in tppo.net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(want[sl]).max()))
            np.testing.assert_allclose(got[sl], want[sl], rtol=2e-3, atol=atol,
                                       err_msg=f"{case}: {what} of {name}")
    if case == "nan_minibatch":   # the NaN env is in a minibatch: its steps are skipped
        assert 5 in perm
