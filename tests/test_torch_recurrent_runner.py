"""The recurrent task (``GR1T1_lstm``) through the port's runner, training
entry point, play and export, on the CPU.

- One iteration (rollout, last values, GAE, the recurrent update) of the
  port's ``OnPolicyRunner.iteration`` against the JAX runner's pieces as a
  host loop (tests/test_torch_rollout.py's scheme): the GR1T1_lstm config
  at 4 envs, decimation 2, 3 steps, 2 epochs x 2 minibatches of 2 env
  columns, from the same converted env state, observations, params and a
  random start memory; the action noise, the env's U blocks and the
  update's env permutation rebuilt from JAX's keys. The JAX env steps
  eagerly (``jax.disable_jit()``: its jit costs more than the 3 steps). The transition buffer, the memory after
  the rollout and the returns are held as tests/test_torch_rollout.py
  holds them (rtol 1e-4 / atol 1e-5 widened by 3x the port's float32 floor,
  the port run again in float64); metrics and LR at rtol 1e-3; params at
  atol 2 x LR x steps element by element and the whole update within 2% in
  L2. The compiled iteration (``_train_iter``, its CUDA graphs stood in
  as tests/test_torch_graphs.py does) from the same state and draws, by
  the same rules.
- ``scripts/train.py --task GR1T1_lstm --device cpu`` for 2 iterations (4
  envs, 8 steps, one epoch of 2 minibatches: the registry's config cut so
  the test stays short), then a resume from ``model_2.pt`` that restores
  params, Adam moments, count, LR and iteration bit for bit; the memory is
  not saved and starts at zero.
- The stateful inference policy: its first action from zeros, a second
  call on the same observation differs (the memory moved), and after
  ``reset()`` the first action again, bit for bit; ``scripts/play.py``
  plays the trained checkpoint and exports ``policy.npz``, which equals the
  JAX ``export_policy_npz`` of the same params key for key and array for
  array. The port's ``load_policy_npz`` refuses that file with a ValueError
  naming the LSTM keys; the JAX loader reads it and fails at the first
  product (ROADMAP queue 3).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_env import as_float64, assert_close_widened, jax_state_to_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu.learn.recurrent import Hidden as JaxHidden
from wiki_grx_gym_tpu.learn.runner import OnPolicyRunner as JaxRunner
from wiki_grx_gym_tpu.utils.helpers import export_policy_npz as jax_export_policy_npz
from wiki_grx_gym_tpu.utils.helpers import load_policy_npz as jax_load_policy_npz
from wiki_grx_gym_tpu_torch.build import LAUNCHES
from wiki_grx_gym_tpu_torch.convert import (env_state_from_numpy, flat_to_jax_order,
                                            recurrent_from_numpy, recurrent_to_numpy)
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.recurrent import Hidden
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, RunnerState
from wiki_grx_gym_tpu_torch.utils.helpers import load_policy_npz

TASK = "GR1T1_lstm"
FIELDS = ("obs", "critic_obs", "actions", "rewards", "values", "log_prob", "mu", "sigma", "dones")
N, T, DECIMATION = 4, 3, 2


def cut(train_cfg, steps=T, epochs=2, mbs=2):
    train_cfg.runner.num_steps_per_env = steps
    train_cfg.algorithm.num_learning_epochs = epochs
    train_cfg.algorithm.num_mini_batches = mbs


@pytest.fixture(scope="module")
def iteration():
    jc, jtrain = jax_registry.get_cfgs(TASK)
    tc, ttrain = task_registry.get_cfgs(TASK)
    for c, tr in ((jc, jtrain), (tc, ttrain)):
        c.env.num_envs = N
        c.control.decimation = DECIMATION
        cut(tr)
    jc.sim.use_pallas = "lanes"
    tenv, _ = task_registry.make_env(TASK, env_cfg=tc, device="cpu")
    trun = OnPolicyRunner(tenv, ttrain, device="cpu")
    assert trun.recurrent
    rng = np.random.RandomState(0)
    obs = rng.randn(N, tenv.obs_dim).astype(np.float32)
    cobs = rng.randn(N, tenv.pri_obs_dim).astype(np.float32)
    h0 = [(0.3 * rng.randn(1, N, 256)).astype(np.float32) for _ in range(4)]
    jenv, _ = jax_registry.make_env(TASK, env_cfg=jc)
    jrun = JaxRunner(jenv, jtrain)
    assert jrun.recurrent and jenv._post_fold
    net, alg = jrun.net, jrun.alg
    params = net.init(jax.random.PRNGKey(3))
    js0 = jax.jit(jenv.init_state)(jax.random.PRNGKey(1))
    act = jax.jit(net.act_evaluate_rnn)
    key = jax.random.PRNGKey(11)
    # the JAX runner's _rollout / _iteration for the recurrent net, as a host
    # loop over its pieces (same statements, same key splits); the env step
    # runs eagerly (its jit costs more than the steps)
    es, o, co, hidden = js0, jnp.asarray(obs), jnp.asarray(cobs), JaxHidden(*map(jnp.asarray, h0))
    trans, noise, blocks, k = [], [], [], key
    for _ in range(T):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (N, tenv.num_actions))))
        _, k_block = jax.random.split(es.rng)
        blocks.append(np.asarray(jax.random.uniform(k_block, (N, jenv._step_u_cols[1]))))
        actions, logp, mu, sigma, values, hidden = act(params, o, co, hidden, k_act)
        with jax.disable_jit():
            es, out = jenv.step(es, actions)
        rewards = out.rew + alg.gamma * values * out.extras["time_outs"]
        trans.append(dict(obs=o, critic_obs=co, actions=actions, rewards=rewards, dones=out.reset,
                          values=values, log_prob=logp, mu=mu, sigma=sigma))
        live = (1.0 - out.reset.astype(jnp.float32))[None, :, None]
        hidden = type(hidden)(*(h * live for h in hidden))
        o, co = out.obs, out.pri_obs
    batch = {kk: np.stack([np.asarray(tr[kk]) for tr in trans]) for kk in trans[0]}
    last_values, _ = net.evaluate_rnn(params, co, hidden)
    jb = JaxTransition(**{kk: jnp.asarray(v) for kk, v in batch.items()})
    ret, adv = alg.compute_returns(jb, last_values)
    k_update = jax.random.PRNGKey(13)
    jst = alg.init(params)
    jst2, jm = alg.update_recurrent(jst, jb, ret, adv, k_update, JaxHidden(*map(jnp.asarray, h0)))
    _, used = trun.alg.recurrent_geometry(N)
    perm = np.asarray(jax.random.permutation(k_update, N)[:used])

    recurrent_from_numpy(trun.net, jax.tree.map(np.asarray, params))
    p0 = trun.net.params_flat.clone()
    noise, blocks = torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(blocks))

    def port_state(dtype):
        cast = (lambda d: as_float64(d)) if dtype == torch.float64 else (lambda d: d)
        return RunnerState(env_state=env_state_from_numpy(cast(jax_state_to_numpy(js0))),
                           obs=torch.from_numpy(obs).to(dtype), critic_obs=torch.from_numpy(cobs).to(dtype),
                           rng=torch.Generator().manual_seed(0), ppo=trun.alg.init(p0.clone().to(dtype)),
                           hidden=Hidden(*(torch.from_numpy(h).to(dtype) for h in h0)))

    before = dict(LAUNCHES)
    rs, tb, _ = trun.rollout(port_state(torch.float32), noise=noise, u=blocks)
    tlast, _ = trun.net.evaluate_rnn(rs.critic_obs, rs.hidden)
    tret, _ = trun.alg.compute_returns(tb, tlast)
    tst2, tm = trun.iteration(port_state(torch.float32), noise=noise, u=blocks, perm=perm)
    assert LAUNCHES == before   # CPU tensors launch no kernel
    net32 = trun.net
    trun.net = copy.deepcopy(net32).double()
    trun.net.bind(p0.clone().double())
    rs64, tb64, _ = trun.rollout(port_state(torch.float64), noise=noise.double(), u=blocks.double())
    last64, _ = trun.net.evaluate_rnn(rs64.critic_obs, rs64.hidden)
    ret64, _ = trun.alg.compute_returns(tb64, last64)
    trun.net = net32
    return dict(jax=(batch, hidden, np.asarray(ret), jst2, jm), port=(tb, rs, tret.numpy(), tst2, tm),
                port64=(tb64, rs64, ret64.numpy()), p0=p0, net=net32,
                lr=float(jst.learning_rate), steps=4, runner=trun, port_state=port_state,
                draws=dict(noise=noise, u=blocks, perm=torch.from_numpy(perm)))


@pytest.mark.parametrize("field", FIELDS)
def test_recurrent_rollout_buffer_matches(iteration, field):
    jb, tb, tb64 = iteration["jax"][0], iteration["port"][0], iteration["port64"][0]
    got, want = getattr(tb, field).numpy(), jb[field]
    assert got.shape == want.shape
    if field == "dones":
        np.testing.assert_array_equal(got, want)
        return
    for t in range(T):
        assert_close_widened(got[t], want[t], getattr(tb64, field)[t].numpy(), err_msg=f"{field} {t}")


def test_recurrent_memory_and_returns_match(iteration):
    jh, rs, rs64 = iteration["jax"][1], iteration["port"][1], iteration["port64"][1]
    for g, w, g64, name in zip(rs.hidden, jh, rs64.hidden, Hidden._fields):
        assert_close_widened(g.numpy(), np.asarray(w), g64.numpy(), err_msg=name)
    for t in range(T):
        assert_close_widened(iteration["port"][2][t], iteration["jax"][2][t], iteration["port64"][2][t],
                             err_msg=f"returns {t}")


def check_update(iteration, tst2, tm):
    _, _, _, jst2, jm = iteration["jax"]
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    assert int(tst2.ppo.count) == iteration["steps"]
    net, lr, steps = iteration["net"], iteration["lr"], iteration["steps"]
    want = np.asarray(ravel_pytree(jst2.params)[0])
    got = flat_to_jax_order(net, tst2.ppo.params)
    start = flat_to_jax_order(net, iteration["p0"])
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * steps)
    d_got, d_want = got - start, want - start
    assert np.linalg.norm(d_want) > 0
    assert np.linalg.norm(d_got - d_want) <= 0.02 * np.linalg.norm(d_want)
    assert tst2.hidden is not None and tst2.hidden.ha.shape == (1, N, 256)


def test_recurrent_iteration_update_matches(iteration):
    check_update(iteration, *iteration["port"][3:])


def test_compiled_recurrent_iteration_matches(iteration, monkeypatch):
    """The compiled iteration (``_train_iter``, the CUDA graphs stood in as
    tests/test_torch_graphs.py does on the CPU: a replay runs the graph's
    body again) from the same state and draws, held to JAX by the same
    rules: the collection's buffer, the new memory and the returns, then
    the update's metrics and params."""
    from test_torch_graphs import stand_in_graphs

    stand_in_graphs(monkeypatch)
    trun = iteration["runner"]
    try:
        st, m = trun._train_iter(iteration["port_state"](torch.float32), **iteration["draws"])
        got = trun.compiled.last
        jb, jh, jret = iteration["jax"][:3]
        tb64, rs64, ret64 = iteration["port64"]
        for field in FIELDS:
            g, w = getattr(got["batch"], field).numpy(), jb[field]
            for t in range(T):
                if field == "dones":
                    np.testing.assert_array_equal(g[t], w[t])
                else:
                    assert_close_widened(g[t], w[t], getattr(tb64, field)[t].numpy(), err_msg=f"{field} {t}")
        for g, w, g64, name in zip(st.hidden, jh, rs64.hidden, Hidden._fields):
            assert_close_widened(g.numpy(), np.asarray(w), g64.numpy(), err_msg=name)
        for t in range(T):
            assert_close_widened(got["returns"][t].numpy(), jret[t], ret64[t], err_msg=f"returns {t}")
        check_update(iteration, st, m)
        assert trun.compiled.update.replays == iteration["steps"] - 1   # one grad step's graph
    finally:
        trun.compiled = None


# ---------------------------------------------------------------------------
# train.py, resume, play, export
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory, monkeypatch_module):
    from wiki_grx_gym_tpu_torch.scripts.train import train
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    root = str(tmp_path_factory.mktemp("logs"))
    get_cfgs = task_registry.get_cfgs

    def short(name):
        env_cfg, train_cfg = get_cfgs(name)
        cut(train_cfg, steps=8, epochs=1, mbs=2)
        return env_cfg, train_cfg

    monkeypatch_module.setattr(task_registry, "get_cfgs", short)
    args = ["--task", TASK, "--device", "cpu", "--num_envs", "4"]
    runner, state = train(get_args(args + ["--max_iterations", "2"]), log_root=root)
    return root, args, runner, state


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_lstm_writes_model_2_and_resumes_exactly(trained):
    root, args, runner, state = trained
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    assert runner.recurrent and runner.current_learning_iteration == 2
    assert int(state.ppo.count) == 2 * 1 * 2
    assert all(torch.isfinite(x).all() for x in (state.ppo.params, state.ppo.m, state.ppo.v))
    run = os.listdir(root)[0]
    assert run.endswith("_gr1t1_lower_limb_lstm")
    rargs = get_args(args + ["--resume", "--load_run", run, "--checkpoint", "2"])
    env, _ = task_registry.make_env(TASK, args=rargs, device="cpu")
    runner2, _ = task_registry.make_alg_runner(env, TASK, args=rargs, log_root=root)
    loaded = runner2._loaded_state
    assert runner2.current_learning_iteration == 2
    for name in ("params", "m", "v", "count", "learning_rate"):
        a, b = getattr(loaded.ppo, name), getattr(state.ppo, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert all(float(h.abs().max()) == 0.0 for h in loaded.hidden)   # the memory is not saved
    assert runner2.net.params_flat.data_ptr() == loaded.ppo.params.data_ptr()


def test_stateful_policy_reset_reproduces_the_first_action(trained):
    _, _, runner, state = trained
    runner.net.bind(state.ppo.params)
    policy = runner.get_inference_policy()
    obs = state.obs
    a1 = policy(obs)
    a2 = policy(obs)
    assert not torch.equal(a1, a2)   # the memory moved
    policy.reset()
    assert torch.equal(policy(obs), a1)


def test_play_exports_the_jax_format_and_the_loader_refuses_it(trained):
    from wiki_grx_gym_tpu.learn.recurrent import ActorCriticRecurrent as JaxRecurrent
    from wiki_grx_gym_tpu.learn.recurrent import LSTMLayerParams, RecurrentParams
    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    root, args, runner, state = trained
    logger = play(get_args(args), num_steps=4, log_root=root)
    assert len(logger.rew_log["rew_total"]) == 4
    assert all(np.isfinite(v).all() for vals in {**logger.state_log, **logger.rew_log}.values()
               for v in vals)
    path = os.path.join(root, "exported", "policies", "policy.npz")
    tree = recurrent_to_numpy(runner.net, state.ppo.params)
    jparams = RecurrentParams(
        memory_a=[LSTMLayerParams(**{k: jnp.asarray(v) for k, v in layer.items()}) for layer in tree["memory_a"]],
        memory_c=[LSTMLayerParams(**{k: jnp.asarray(v) for k, v in layer.items()}) for layer in tree["memory_c"]],
        actor=[(jnp.asarray(w), jnp.asarray(b)) for w, b in tree["actor"]],
        critic=[(jnp.asarray(w), jnp.asarray(b)) for w, b in tree["critic"]],
        std=jnp.asarray(tree["std"]))
    _, train_cfg = jax_registry.get_cfgs(TASK)
    jpath = os.path.join(root, "jax_policy.npz")
    jax_export_policy_npz(JaxRecurrent(39, 168, 10, train_cfg.policy), jparams, jpath)
    got, want = np.load(path), np.load(jpath)
    assert got.files == want.files
    assert {"lstm0_w_ih", "lstm0_w_hh", "lstm0_b_ih", "lstm0_b_hh"} <= set(got.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="lstm0_w_ih"):
        load_policy_npz(path)
    with pytest.raises(Exception):   # JAX's loader: a shape error at the first product
        jax_load_policy_npz(path)(np.zeros((1, 39), np.float32))
