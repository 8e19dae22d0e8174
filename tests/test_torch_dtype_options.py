"""The port's bf16 policy and update dtypes, ``fused_trunk`` in the update
and ``remat_update`` (ROADMAP item 16) against the JAX package.

- bf16 forwards (``policy.compute_dtype = "bfloat16"``): ``action_mean``,
  ``evaluate`` and ``joint_mean_value`` of the MLP net, and the LSTM net's
  heads (``act_inference_rnn``, ``evaluate_rnn``, ``joint_mean_value_seq``),
  on the same converted params and inputs as JAX's bf16 forwards: within one
  bf16 ulp of the largest output (2^-8 x max |JAX|; the hidden layers round
  alike, only the last layer's float32 sums run in another order). Against
  the port's own float32 forward within ``tests/test_learn.py:306``'s
  bounds (1e-2 on the mean, 2e-2 on the value); the outputs are float32.
- K2's operand dtype for the four (storage_dtype, update_dtype) pairs
  equals JAX's ``PPO._get_fused(rows).op_dtype`` on the CPU.
- One xla-path update (hidden (32, 32), t=8, n=64, 2 minibatches x 1
  epoch, f32 storage, JAX's block permutation injected, as
  ``tests/test_torch_ppo_update.py``) with ``update_dtype = "bfloat16"``,
  with ``fused_trunk`` and with ``remat_update``, each against JAX's
  ``PPO.update`` with the same flag: f32 cases at test_torch_ppo_update.py's
  tolerances (params and Adam moments rtol 2e-3 / atol 2e-5, metrics and
  LR rtol 2e-4); the bf16 case at ``tests/test_parallel.py:193-196``'s bf16
  bounds (params rtol 1e-2 / atol 5e-3, metrics rtol 2e-2 / atol 1e-3). In
  the port, remat on and off are bit-equal.
- ``export_policy_npz`` and ``.grxpolicy`` write float32 weights under
  ``compute_dtype = "bfloat16"``, equal to the float32 net's files.
- ``activation = "crelu"``: JAX's ``init_mlp`` does not double the next
  layer's fan-in, so its ``action_mean`` raises ``TypeError``; the port
  refuses the activation with ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_ppo_update import jax_state_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn import recurrent as jrec
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.ppo import PPO as JaxPPO
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu_torch.convert import (actor_critic_from_numpy, flat_to_jax_order, ppo_state_from_numpy,
                                            recurrent_from_numpy)
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.ppo import PPO
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent, Hidden
from wiki_grx_gym_tpu_torch.learn.runner import Transition

O, P, A = 39, 168, 10
T, N = 8, 64
BF16_ULP = 2.0 ** -8   # one bf16 ulp relative to a value in [1, 2): 2^-7, taken as 2^-8 of the largest


def policy(reg, dtype="bfloat16", task="GR1T1", hidden=(64, 32, 16)):
    _, train_cfg = reg.get_cfgs(task)
    p = train_cfg.policy
    p.actor_hidden_dims = list(hidden)
    p.critic_hidden_dims = list(hidden)
    p.compute_dtype = dtype
    if task == "GR1T1_lstm":
        p.rnn_hidden_size = 32
    return p


def seeded(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def within_ulp(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.float32, what
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULP * float(np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def mlp():
    jnet = JaxActorCritic(O, P, A, policy(jax_registry))
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = actor_critic_from_numpy(ActorCritic(O, P, A, policy(task_registry)), jax.tree.map(np.asarray, params))
    return jnet, params, tnet


def test_bf16_forwards_match_jax_and_f32(mlp):
    jnet, params, tnet = mlp
    assert jnet.compute_dtype == jnp.bfloat16 and tnet.compute_dtype == torch.bfloat16
    obs, cobs = seeded(256, O, seed=1), seeded(256, P, seed=2)
    to, tc = torch.from_numpy(obs), torch.from_numpy(cobs)
    mean, value = tnet.action_mean(to), tnet.evaluate(tc)
    within_ulp(mean, jnet.action_mean(params, jnp.asarray(obs)), "action_mean")
    within_ulp(value, jnet.evaluate(params, jnp.asarray(cobs)), "evaluate")
    jm, jv = jnet.joint_mean_value(params, jnp.asarray(obs), jnp.asarray(cobs))
    tm, tv = tnet.joint_mean_value(to, tc)
    within_ulp(tm, jm, "joint mean")
    within_ulp(tv, jv, "joint value")
    # dtype= overrides the net's compute dtype, as JAX's
    within_ulp(tnet.action_mean(to, dtype=None), jnet.action_mean(params, jnp.asarray(obs), dtype=None), "f32")
    assert float((mean - tnet.action_mean(to, dtype=None)).abs().max()) < 1e-2   # test_learn.py:306
    assert float((value - tnet.evaluate(tc, dtype=None)).abs().max()) < 2e-2
    assert float((mean - tnet.action_mean(to, dtype=None)).abs().max()) > 0   # bf16 did round
    actions, logp, mu, sigma = tnet.act(to, torch.from_numpy(seeded(256, A, seed=3)))
    assert mu.dtype == logp.dtype == torch.float32 and torch.equal(mu, mean)


def test_bf16_lstm_heads_match_jax():
    cfg = policy(jax_registry, task="GR1T1_lstm", hidden=(64, 32))
    jnet = jrec.ActorCriticRecurrent(O, P, A, cfg)
    assert jnet.compute_dtype == jnp.bfloat16
    params = jnet.init(jax.random.PRNGKey(1))
    tnet = recurrent_from_numpy(ActorCriticRecurrent(O, P, A, policy(task_registry, task="GR1T1_lstm",
                                                                      hidden=(64, 32))),
                                jax.tree.map(np.asarray, params))
    n = 32
    h = [seeded(1, n, 32, seed=s) for s in range(4)]
    jh, th = jrec.Hidden(*map(jnp.asarray, h)), Hidden(*map(torch.from_numpy, h))
    obs, cobs = seeded(n, O, seed=5), seeded(n, P, seed=6)
    jm, jh2 = jnet.act_inference_rnn(params, jnp.asarray(obs), jh)
    tm, th2 = tnet.act_inference_rnn(torch.from_numpy(obs), th)
    within_ulp(tm, jm, "act_inference_rnn")
    assert th2.ha.dtype == torch.float32   # the memories stay f32
    np.testing.assert_allclose(th2.ha.numpy(), np.asarray(jh2.ha), rtol=1e-5, atol=1e-6)
    jv, _ = jnet.evaluate_rnn(params, jnp.asarray(cobs), jh)
    tv, _ = tnet.evaluate_rnn(torch.from_numpy(cobs), th)
    within_ulp(tv, jv, "evaluate_rnn")
    os_, cs = seeded(6, n, O, seed=7), seeded(6, n, P, seed=8)
    done = (np.random.RandomState(9).rand(6, n) < 0.2).astype(np.float32)
    jm, jv = jnet.joint_mean_value_seq(params, jnp.asarray(os_), jnp.asarray(cs), jnp.asarray(done), jh)
    tm, tv = tnet.joint_mean_value_seq(torch.from_numpy(os_), torch.from_numpy(cs), torch.from_numpy(done), th)
    within_ulp(tm, jm, "joint_mean_value_seq mean")
    within_ulp(tv, jv, "joint_mean_value_seq value")


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("update", ["float32", "bfloat16"])
def test_k2_operand_dtype_follows_jax(storage, update):
    out = []
    for reg, cls, ppo_cls in ((jax_registry, JaxActorCritic, JaxPPO), (task_registry, ActorCritic, PPO)):
        _, train_cfg = reg.get_cfgs("GR1T1")
        train_cfg.algorithm.storage_dtype = storage
        train_cfg.algorithm.update_dtype = update
        train_cfg.algorithm.fused_update = True
        out.append(ppo_cls(cls(O, P, A, train_cfg.policy), train_cfg.algorithm)._get_fused(10480).op_dtype)
    want = torch.float32 if out[0] == jnp.float32 else torch.bfloat16
    assert out[1] == want
    assert (want == torch.float32) == (storage == update == "float32")


def make_pair(flag, value):
    """(JAX PPO, port PPO) on the xla path with ``flag`` set, hidden (32, 32)."""
    out = []
    for reg, cls, ppo_cls in ((jax_registry, JaxActorCritic, JaxPPO), (task_registry, ActorCritic, PPO)):
        _, train_cfg = reg.get_cfgs("GR1T1")
        pc = train_cfg.policy
        pc.actor_hidden_dims = [32, 32]
        pc.critic_hidden_dims = [32, 32]
        alg = train_cfg.algorithm
        alg.fused_update = False
        alg.num_learning_epochs = 1
        alg.num_mini_batches = 2
        alg.storage_dtype = "float32"
        alg.update_dtype = "float32"
        setattr(alg, flag, value)
        out.append(ppo_cls(cls(O, P, A, pc), alg))
    assert not out[0].fused_update and out[1].path == "xla"
    return out


def make_batch(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    mu = 0.3 * f(T, N, A)
    sigma = np.full((T, N, A), 0.2, np.float32)
    actions = mu + sigma * f(T, N, A)
    logp = np.asarray(JaxActorCritic.log_prob(jnp.asarray(mu), jnp.asarray(sigma), jnp.asarray(actions)))
    return dict(obs=f(T, N, O), critic_obs=f(T, N, P), actions=actions, rewards=0.1 * f(T, N),
                dones=np.zeros((T, N), bool), values=f(T, N), log_prob=logp, mu=mu, sigma=sigma), f(T, N), f(T, N)


def run_pair(flag, value, seed=1):
    jppo, tppo = make_pair(flag, value)
    batch, returns, adv = make_batch(seed)
    params = jppo.net.init(jax.random.PRNGKey(seed))
    jst = jppo.init(params)
    key = jax.random.PRNGKey(100 + seed)
    jst2, jm = jppo.update(jst, JaxTransition(**{k: jnp.asarray(v) for k, v in batch.items()}),
                           jnp.asarray(returns), jnp.asarray(adv), key)
    _, n_blocks, used, _ = tppo.shuffle_geometry(T, N)
    perm = np.asarray(jax.random.permutation(key, n_blocks)[:used])
    tst = ppo_state_from_numpy(tppo.net, *jax_state_numpy(jppo, jst))
    tb = Transition(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    tst2, tm = tppo.update(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv), perm=perm)
    return jppo, jst2, jm, tppo, tst, tst2, tm, (tb, returns, adv, perm)


# (metrics rtol, metrics atol, params/moments rtol, params atol)
TOLS = {"fused_trunk": (2e-4, 0.0, 2e-3, 2e-5), "remat_update": (2e-4, 0.0, 2e-3, 2e-5),
        "update_dtype": (2e-2, 1e-3, 1e-2, 5e-3)}


@pytest.mark.parametrize("flag,value", [("update_dtype", "bfloat16"), ("fused_trunk", True),
                                        ("remat_update", True)])
def test_xla_update_with_flag_matches_jax(flag, value):
    jppo, jst2, jm, tppo, _, tst2, tm, _ = run_pair(flag, value)
    assert getattr(tppo, flag) == ({"bfloat16": torch.bfloat16}.get(value, value))
    mrtol, matol, prtol, patol = TOLS[flag]
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=mrtol, atol=matol, err_msg=f"{flag} {k}")
    jp, jmu, jnu, jcount, _ = jax_state_numpy(jppo, jst2)
    assert int(tst2.count) == int(jcount) == 2
    for got, want, what in ((tst2.params, ravel_pytree(jp)[0], "params"), (tst2.m, jmu, "Adam m"),
                            (tst2.v, jnu, "Adam v")):
        got, want = flat_to_jax_order(tppo.net, got), np.asarray(want)
        for name, off, shape in tppo.net.layout:
            sl = slice(off, off + int(np.prod(shape)))
            atol = patol if what == "params" else patol * max(1e-12, float(np.abs(want[sl]).max()))
            np.testing.assert_allclose(got[sl], want[sl], rtol=prtol, atol=atol, err_msg=f"{flag}: {what} of {name}")


def test_remat_is_bit_equal_in_the_port():
    _, _, _, tppo, tst, tst2, tm, (tb, returns, adv, perm) = run_pair("remat_update", True)
    _, plain = make_pair("remat_update", False)
    st, m = plain.update(tst, tb, torch.from_numpy(returns), torch.from_numpy(adv), perm=perm)
    for k in ("params", "m", "v", "count", "learning_rate"):
        assert torch.equal(getattr(st, k), getattr(tst2, k)), k
    assert all(torch.equal(m[k], tm[k]) for k in m)


def test_export_stays_f32_under_bf16_compute(tmp_path, mlp):
    from wiki_grx_gym_tpu_torch.deploy.runtime import export_policy_bin
    from wiki_grx_gym_tpu_torch.utils.helpers import export_policy_npz

    _, params, tnet = mlp
    t32 = actor_critic_from_numpy(ActorCritic(O, P, A, policy(task_registry, "float32")),
                                  jax.tree.map(np.asarray, params))
    for net, tag in ((tnet, "bf16"), (t32, "f32")):
        export_policy_npz(net, str(tmp_path / f"{tag}.npz"))
        export_policy_bin(net, str(tmp_path / f"{tag}.grxpolicy"))
    a, b = np.load(tmp_path / "bf16.npz"), np.load(tmp_path / "f32.npz")
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["actor_w0"].dtype == np.float32
    assert (tmp_path / "bf16.grxpolicy").read_bytes() == (tmp_path / "f32.grxpolicy").read_bytes()


def test_crelu_raises_on_both_sides():
    jp, tp = policy(jax_registry, "float32"), policy(task_registry, "float32")
    jp.activation = tp.activation = "crelu"
    jnet = JaxActorCritic(O, P, A, jp)
    params = jnet.init(jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="dot_general"):
        jnet.action_mean(params, jnp.zeros((2, O)))
    with pytest.raises(NotImplementedError, match="crelu"):
        ActorCritic(O, P, A, tp)
