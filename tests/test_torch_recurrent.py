"""Port parity for the recurrent actor-critic (``learn/recurrent.py``),
``convert.py``'s recurrent conversions and ``learn/utils.py``.

- The cell against JAX ``_lstm_cell`` and against ``torch.nn.LSTM`` on one
  step (as tests/test_recurrent.py checks JAX's), rtol 1e-5 / atol 1e-6.
- The sequence replay with resets (``features_seq``) against JAX
  ``features_seq`` and against stepping the port's cell one step at a time
  with the memory zeroed after each reset (equal bit for bit: the same ops).
- ``act_evaluate_rnn``, ``evaluate_rnn``, ``act_inference_rnn``,
  ``action_mean_seq`` and ``joint_mean_value_seq`` on the
  same converted params, inputs and injected noise (rtol 1e-5 / atol 1e-5:
  float32 matmuls summed in another order).
- At GR1T1_lstm's widths (obs 39, critic obs 168, 10 actions, LSTM 256,
  heads [512, 256, 128]): 1,333,397 parameters, the leaves in
  ``ravel_pytree``'s order and shapes, and the conversion JAX -> port -> JAX
  bit for bit.
- ``learn/utils.py`` against the JAX module on seeded inputs.

The nets here are small (LSTM 32, heads [64, 32]) except for the width
checks, which build the JAX params only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn import recurrent as jrec
from wiki_grx_gym_tpu.learn import utils as jutils
from wiki_grx_gym_tpu_torch.convert import (flat_from_jax_order, flat_to_jax_order,
                                            recurrent_from_numpy, recurrent_to_numpy)
from wiki_grx_gym_tpu_torch.learn import utils as tutils
from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent, Hidden, lstm_cell

RTOL, ATOL = 1e-5, 1e-5
O, OC, A, H = 39, 168, 10, 32


def policy_cfg(hidden=H, heads=(64, 32)):
    _, train_cfg = jax_registry.get_cfgs("GR1T1_lstm")
    p = train_cfg.policy
    p.rnn_hidden_size = hidden
    p.actor_hidden_dims = list(heads)
    p.critic_hidden_dims = list(heads)
    return p


def jax_to_numpy(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def nets():
    cfg = policy_cfg()
    jnet = jrec.ActorCriticRecurrent(O, OC, A, cfg)
    params = jnet.init(jax.random.PRNGKey(0))
    params = params.replace(std=params.std + 0.05 * jnp.arange(A))   # distinct std entries
    tnet = ActorCriticRecurrent(O, OC, A, cfg)
    recurrent_from_numpy(tnet, jax_to_numpy(params))
    return jnet, params, tnet


def seeded(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def hidden_pair(n, seed):
    return [seeded(1, n, H, seed=seed + k, scale=0.5) for k in range(4)]


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float64),
                               np.asarray(want, np.float64), **{"rtol": RTOL, "atol": ATOL, **kw})


def test_cell_matches_jax_and_torch_lstm():
    torch.manual_seed(0)
    i_dim, h_dim, n = 7, 5, 3
    lstm = torch.nn.LSTM(i_dim, h_dim, num_layers=1)
    x, h0, c0 = torch.randn(1, n, i_dim), torch.randn(1, n, h_dim), torch.randn(1, n, h_dim)
    with torch.no_grad():
        _, (h1, c1) = lstm(x, (h0, c0))
    layer = (lstm.weight_ih_l0.detach().t().contiguous(), lstm.weight_hh_l0.detach().t().contiguous(),
             lstm.bias_ih_l0.detach(), lstm.bias_hh_l0.detach())
    h, c = lstm_cell(layer, x[0], h0[0], c0[0])
    close(h, h1[0].numpy(), atol=1e-6)
    close(c, c1[0].numpy(), atol=1e-6)
    jp = jrec.LSTMLayerParams(*(jnp.asarray(t.numpy()) for t in layer))
    jh, jc = jrec._lstm_cell(jp, jnp.asarray(x[0].numpy()), jnp.asarray(h0[0].numpy()),
                             jnp.asarray(c0[0].numpy()))
    close(h, jh, atol=1e-6)
    close(c, jc, atol=1e-6)


def test_sequence_replay_with_resets(nets):
    """``features_seq`` zeroes the memory where ``done_prev``: equal to JAX
    ``features_seq``, and bit for bit to the port's cell stepped one step
    at a time with the memory zeroed after each reset (the rollout)."""
    jnet, params, tnet = nets
    t, n = 12, 6
    xs = seeded(t, n, O, seed=3)
    dones = np.random.RandomState(4).rand(t, n) < 0.2
    dones[5, 2] = True
    done_prev = np.concatenate([np.zeros((1, n)), dones[:-1]], 0).astype(np.float32)
    h0, c0 = hidden_pair(n, 5)[:2]
    want = jnet.features_seq(params.memory_a, jnp.asarray(xs), jnp.asarray(done_prev),
                             jnp.asarray(h0), jnp.asarray(c0))
    mem_a, _ = tnet.memories()
    got = tnet.features_seq(mem_a, torch.from_numpy(xs), torch.from_numpy(done_prev),
                            torch.from_numpy(h0), torch.from_numpy(c0))
    assert got.shape == (t, n, H)
    close(got, want)
    h, c = torch.from_numpy(h0)[0], torch.from_numpy(c0)[0]
    for s in range(t):
        h, c = lstm_cell(mem_a[0], torch.from_numpy(xs[s]), h, c)
        assert torch.equal(h, got[s]), s
        live = torch.from_numpy(1.0 - dones[s].astype(np.float32))[:, None]
        h, c = h * live, c * live


def test_one_step_methods_match_jax(nets):
    jnet, params, tnet = nets
    n = 5
    obs, cobs = seeded(n, O, seed=6), seeded(n, OC, seed=7)
    hid = hidden_pair(n, 8)
    jh = jrec.Hidden(*(jnp.asarray(x) for x in hid))
    th = Hidden(*(torch.from_numpy(x) for x in hid))
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (n, A)))
    ja = jnet.act_evaluate_rnn(params, jnp.asarray(obs), jnp.asarray(cobs), jh, key)
    ta = tnet.act_evaluate_rnn(torch.from_numpy(obs), torch.from_numpy(cobs), th, torch.from_numpy(noise))
    for g, w in zip(ta[:5], ja[:5]):
        close(g, w)
    for g, w in zip(ta[5], ja[5]):
        close(g, w)
    jv, jh2 = jnet.evaluate_rnn(params, jnp.asarray(cobs), jh)
    tv, th2 = tnet.evaluate_rnn(torch.from_numpy(cobs), th)
    close(tv, jv)
    for g, w in zip(th2, jh2):
        close(g, w)
    jm, jh3 = jnet.act_inference_rnn(params, jnp.asarray(obs), jh)
    tm, th3 = tnet.act_inference_rnn(torch.from_numpy(obs), th)
    close(tm, jm)
    for g, w in zip(th3, jh3):
        close(g, w)
    assert torch.equal(th3.hc, th.hc) and torch.equal(th2.ha, th.ha)   # the other memory untouched


def test_sequence_methods_match_jax(nets):
    jnet, params, tnet = nets
    t, n = 8, 4
    obs, cobs = seeded(t, n, O, seed=10), seeded(t, n, OC, seed=11)
    done_prev = (np.random.RandomState(12).rand(t, n) < 0.25).astype(np.float32)
    done_prev[0] = 0.0
    hid = hidden_pair(n, 13)
    jh = jrec.Hidden(*(jnp.asarray(x) for x in hid))
    th = Hidden(*(torch.from_numpy(x) for x in hid))
    args_j = (jnp.asarray(obs), jnp.asarray(cobs), jnp.asarray(done_prev), jh)
    args_t = (torch.from_numpy(obs), torch.from_numpy(cobs), torch.from_numpy(done_prev), th)
    jm, jv = jnet.joint_mean_value_seq(params, *args_j)
    tm, tv = tnet.joint_mean_value_seq(*args_t)
    assert tm.shape == (t, n, A) and tv.shape == (t, n)
    close(tm, jm)
    close(tv, jv)
    am = tnet.action_mean_seq(args_t[0], args_t[2], th)
    close(am, jnet.action_mean_seq(params, args_j[0], args_j[2], jh))
    assert torch.equal(tm, am)   # the joint replay's mean is the actor's replay


def test_gr1t1_lstm_widths_count_and_leaf_order():
    _, train_cfg = jax_registry.get_cfgs("GR1T1_lstm")
    jnet = jrec.ActorCriticRecurrent(O, OC, A, train_cfg.policy)
    params = jnet.init(jax.random.PRNGKey(1))
    vec, _ = ravel_pytree(params)
    tnet = ActorCriticRecurrent(O, OC, A, train_cfg.policy)
    assert tnet.num_params == vec.shape[0] == 1_333_397
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(tnet.layout)
    names = [name for name, _, _ in tnet.layout]
    assert names[:8] == [f"memory_{s}.0.{k}" for s in "ac" for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    assert names[8:16] == [f"actor.{i}.{k}" for i in range(4) for k in ("weight", "bias")]
    assert names[-1] == "std"
    for leaf, (name, off, shape) in zip(leaves, tnet.layout):
        want = leaf.shape if not (len(shape) == 2 and name.startswith(("actor", "critic"))) else leaf.shape[::-1]
        assert tuple(shape) == tuple(want), name
    assert tnet.layout[0][2] == (39, 1024) and tnet.layout[1][2] == (256, 1024)
    assert tnet.layout[4][2] == (168, 1024)
    # JAX -> port -> JAX, bit for bit
    recurrent_from_numpy(tnet, jax_to_numpy(params))
    back = flat_to_jax_order(tnet, tnet.params_flat)
    assert np.array_equal(back, np.asarray(vec))
    assert np.array_equal(flat_from_jax_order(tnet, np.asarray(vec)), tnet.params_flat.numpy())
    tree = recurrent_to_numpy(tnet)
    for stack in ("memory_a", "memory_c"):
        for got, want in zip(tree[stack], getattr(params, stack)):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                assert np.array_equal(got[k], np.asarray(getattr(want, k))), (stack, k)
    for stack in ("actor", "critic"):
        for (w, b), (jw, jb) in zip(tree[stack], getattr(params, stack)):
            assert np.array_equal(w, np.asarray(jw)) and np.array_equal(b, np.asarray(jb))
    assert np.array_equal(tree["std"], np.asarray(params.std))


def test_init_is_torch_default():
    net = ActorCriticRecurrent(O, OC, A, policy_cfg(), generator=torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(H)
    for layer in net.memories()[0] + net.memories()[1]:
        for t in layer:
            assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.5 * bound
    assert torch.equal(net.std(), torch.full((A,), 0.2))


def test_learn_utils_match_jax():
    rng = np.random.RandomState(20)
    # RunningMeanStd over two batches
    b1, b2 = rng.randn(50, 3).astype(np.float32), (rng.randn(30, 3) * 2 + 1).astype(np.float32)
    j = jutils.RunningMeanStd.create((3,)).update(jnp.asarray(b1)).update(jnp.asarray(b2))
    t = tutils.RunningMeanStd.create((3,)).update(torch.from_numpy(b1)).update(torch.from_numpy(b2))
    for k in ("mean", "var", "count"):
        close(getattr(t, k), getattr(j, k))
    x = (rng.randn(7, 3) * 5).astype(np.float32)
    close(t.normalize(torch.from_numpy(x)), j.normalize(jnp.asarray(x)))
    # split_and_pad_trajectories / unpad
    tt, n = 6, 4
    feats = rng.randn(tt, n, 2).astype(np.float32)
    dones = np.zeros((tt, n), bool)
    dones[2, 0] = dones[3, 1] = dones[0, 3] = True
    jo, jm = jutils.split_and_pad_trajectories(jnp.asarray(feats), jnp.asarray(dones))
    to, tm = tutils.split_and_pad_trajectories(torch.from_numpy(feats), torch.from_numpy(dones))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    close(to, jo, rtol=0, atol=0)
    close(tutils.unpad_trajectories(to, tm), jutils.unpad_trajectories(jo, jm), rtol=0, atol=0)
    # quaternion_slerp, including fractions 0 and 1 and a near-identical pair
    q0 = rng.randn(6, 4).astype(np.float32)
    q1 = rng.randn(6, 4).astype(np.float32)
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q1[5] = q0[5]
    f = np.array([0.0, 0.25, 0.5, 1.0, 0.7, 0.3], np.float32)
    close(tutils.quaternion_slerp(torch.from_numpy(q0), torch.from_numpy(q1), torch.from_numpy(f)),
          jutils.quaternion_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(f)))
    # swap_lr
    v = rng.randn(3, 6).astype(np.float32)
    close(tutils.swap_lr(torch.from_numpy(v), [0, 2], [3, 5]),
          jutils.swap_lr(jnp.asarray(v), [0, 2], [3, 5]), rtol=0, atol=0)
