"""The port's PPO update at the 32-DOF full body's widths and config, against
the JAX package.

``GR1T1_full``'s learner: obs 105, critic obs 234, 32 actions, ELU
[512, 256, 128] actor and critic (507,329 parameters), std floor 0.10,
entropy coefficient 0, the whole-update (``mega``) path, float32 storage
(so K3's plain version runs in the port and the JAX whole-update kernel in
interpreter mode). t=8, n=32 (256 rows), 2 epochs x 2 minibatches, the
block permutation computed in JAX from the update key and injected.
Tolerances as tests/test_torch_ppo_update.py: params and Adam moments rtol
2e-3 / atol 2e-5, metrics and LR rtol 2e-4. The state carried across
(``convert.ppo_state_from_numpy``, ``flat_from_jax_order``) must give the
same numbers as the JAX package at these widths, bit for bit.
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
from wiki_grx_gym_tpu_torch.convert import flat_from_jax_order, flat_to_jax_order, ppo_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.runner import Transition

TASK = "GR1T1_full"
O, P, A = 105, 234, 32
T, N = 8, 32


def make():
    """(JAX PPO, port PPO) of the full-body training config, mega path,
    float32 storage, 2 epochs x 2 minibatches."""
    out = []
    for reg, cls, ppo_cls in ((jax_registry, JaxActorCritic, JaxPPO),
                              (task_registry, ActorCritic, PPO)):
        _, train_cfg = reg.get_cfgs(TASK)
        alg = train_cfg.algorithm
        alg.fused_update = True   # the whole-update kernel (JAX picks it by device otherwise)
        alg.fused_mega = True
        alg.num_learning_epochs = 2
        alg.num_mini_batches = 2
        alg.storage_dtype = "float32"
        alg.update_dtype = "float32"
        out.append(ppo_cls(cls(O, P, A, train_cfg.policy), alg))
    assert out[1].path == "mega" and out[0].fused_update
    return out


def make_batch(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = np.asarray(JaxActorCritic.log_prob(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(actions)))
    return dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions, rewards=0.1 * f(T, N),
                dones=np.zeros((T, N), bool), values=f(T, N), log_prob=logp, mu=mu,
                sigma=sigma), f(T, N), f(T, N)


def jax_state_numpy(jppo, st):
    count, mu, nu, _ = jppo._opt_state_pieces(st.opt_state, ravel_pytree(st.params)[0].size)
    return st.params, np.asarray(mu), np.asarray(nu), np.asarray(count), np.asarray(st.learning_rate)


@pytest.fixture(scope="module")
def updated():
    jppo, tppo = make()
    batch, returns, adv = make_batch(0)
    params = jppo.net.init(jax.random.PRNGKey(0))
    jst = jppo.init(params)
    key = jax.random.PRNGKey(100)
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


def test_full_body_learner_config(updated):
    _, _, _, tppo, _, _ = updated
    assert tppo.net.num_params == 507329
    assert tppo.std_floor == pytest.approx(0.10) and tppo.entropy_coef == 0.0


def test_full_body_update_metrics_and_lr_match(updated):
    _, _, jm, _, _, tm = updated
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, err_msg=k)


def test_full_body_update_params_and_moments_match(updated):
    jppo, jst2, _, tppo, tst2, _ = updated
    jp, jmu, jnu, jcount, jlr = jax_state_numpy(jppo, jst2)
    assert int(tst2.count) == int(jcount) == 4
    np.testing.assert_allclose(float(tst2.learning_rate), float(jlr), rtol=2e-4)
    for got, want, what in ((tst2.params, ravel_pytree(jp)[0], "params"),
                            (tst2.m, jmu, "Adam m"), (tst2.v, jnu, "Adam v")):
        got, want = flat_to_jax_order(tppo.net, got), np.asarray(want)
        for name, off, shape in tppo.net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = 2e-5 if what == "params" else 2e-5 * max(1e-12, float(np.abs(want[sl]).max()))
            np.testing.assert_allclose(got[sl], want[sl], rtol=2e-3, atol=atol, err_msg=f"{what} of {name}")
    std = tst2.params[tppo.net.layout[-1][1]:]
    assert float(std.min()) >= 0.10 - 1e-6


def test_full_body_state_carries_across_bit_for_bit():
    jppo, tppo = make()
    params = jppo.net.init(jax.random.PRNGKey(4))
    flat = np.asarray(ravel_pytree(params)[0])
    assert flat.size == tppo.net.num_params
    rng = np.random.RandomState(4)
    mu = rng.randn(flat.size).astype(np.float32)
    nu = rng.rand(flat.size).astype(np.float32)
    tst = ppo_state_from_numpy(tppo.net, params, mu, nu, np.int32(7), np.float32(3e-4))
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.params), flat)
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.m), mu)
    np.testing.assert_array_equal(flat_to_jax_order(tppo.net, tst.v), nu)
    np.testing.assert_array_equal(flat_from_jax_order(tppo.net, flat), tst.params.numpy())
    # the port's layout holds W (out, in): each actor and critic weight transposed
    tppo.net.bind(tst.params)
    for lin, (w, b) in zip([m for m in tppo.net.actor if isinstance(m, torch.nn.Linear)], params.actor):
        np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(w).T)
        np.testing.assert_array_equal(lin.bias.numpy(), np.asarray(b))
    for lin, (w, _) in zip([m for m in tppo.net.critic if isinstance(m, torch.nn.Linear)], params.critic):
        np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(w).T)
    assert tppo.net.actor[0].weight.shape == (512, O) and tppo.net.critic[0].weight.shape == (512, P)
