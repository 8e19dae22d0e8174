"""Port parity for the slice as a whole: the actor-critic, the runner's
rollout and the play loop.

- Networks: the JAX ``ActorCritic`` params, converted with
  ``convert.actor_critic_from_numpy``, give the same ``act_inference``,
  ``evaluate``, ``log_prob`` and ``joint_mean_value`` (rtol 1e-5; atol 1e-6
  for outputs near zero).
- Rollout: a T=3, 4-env JAX ``OnPolicyRunner._rollout`` (as a host loop
  over its jitted pieces) against the port's ``OnPolicyRunner.rollout``
  from the same converted env state,
  observations and params, with the action noise and the per-step U blocks
  rebuilt from the JAX keys and injected into the port. The env is the
  GR1T1 training config (decimation 10), as in tests/test_torch_env.py, with
  its tolerances: rtol 1e-4 / atol 1e-5, widened at each step by 3x the
  port's float32 noise floor (the port's rollout run again in float64 from
  the same state, noise and U).
- Iteration: the same T=3 rollout carried through the port's whole
  ``OnPolicyRunner.iteration`` (rollout, last values, GAE, one PPO update on
  the default ``mega`` path, i.e. K3's plain version with bf16 operands)
  against the JAX pieces (``compute_returns`` and ``PPO.update`` with the
  whole-update kernel forced, interpreter mode, bf16 storage), 2 epochs x 2
  minibatches, the block permutation computed in JAX from the update key.
  Returns and advantages are held as the rollout buffers are; metrics and LR
  at rtol 1e-3 (the rollout's float32 floor feeds the loss); params at atol
  2 x LR x steps element by element (an entry whose gradient is at the
  noise level may step either way: Adam moves it ~LR per step), and the
  whole update, port against JAX, within 2% in L2.
- Play: the port's ``scripts/play.py`` loop for a few steps on the CPU from a
  ``policy.npz`` written by the JAX ``export_policy_npz``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_env import N, as_float64, assert_close_widened, jax_state_to_numpy, make_envs
from wiki_grx_gym_tpu.learn.networks import ActorCritic as JaxActorCritic
from wiki_grx_gym_tpu.learn.runner import OnPolicyRunner as JaxRunner
from wiki_grx_gym_tpu.utils.helpers import export_policy_npz, load_policy_npz
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu_torch.convert import (actor_critic_from_numpy, env_state_from_numpy,
                                            flat_to_jax_order)
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, RunnerState

T = 3


def _params_numpy(p):
    return {
        "actor": [(np.asarray(w), np.asarray(b)) for w, b in p.actor],
        "critic": [(np.asarray(w), np.asarray(b)) for w, b in p.critic],
        "std": np.asarray(p.std),
    }


@pytest.fixture(scope="module")
def nets():
    _, train_cfg = torch_registry.get_cfgs("GR1T1")
    jnet = JaxActorCritic(39, 168, 10, train_cfg.policy)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3))
    # a std away from its init value, so the conversion of std is exercised
    params = params.replace(std=params.std * jnp.linspace(0.5, 1.5, 10))
    tnet = actor_critic_from_numpy(ActorCritic(39, 168, 10, train_cfg.policy), _params_numpy(params))
    return jnet, params, tnet


def _obs(seed, n=64):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 39).astype(np.float32), rng.randn(n, 168).astype(np.float32)


NET_TOL = dict(rtol=1e-5, atol=1e-6)


def test_act_inference_matches(nets):
    jnet, params, tnet = nets
    obs, _ = _obs(0)
    np.testing.assert_allclose(tnet.act_inference(torch.from_numpy(obs)).detach().numpy(),
                               np.asarray(jnet.act_inference(params, jnp.asarray(obs))), **NET_TOL)


def test_evaluate_matches(nets):
    jnet, params, tnet = nets
    _, cobs = _obs(1)
    np.testing.assert_allclose(tnet.evaluate(torch.from_numpy(cobs)).detach().numpy(),
                               np.asarray(jnet.evaluate(params, jnp.asarray(cobs))), **NET_TOL)


def test_log_prob_and_std_match(nets):
    jnet, params, tnet = nets
    obs, _ = _obs(2)
    eps = np.random.RandomState(5).randn(64, 10).astype(np.float32)
    mean = np.asarray(jnet.action_mean(params, jnp.asarray(obs)))
    std = np.broadcast_to(np.asarray(jnet.std(params)), mean.shape)
    actions = mean + std * eps
    want = np.asarray(jnet.log_prob(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(actions)))
    a, lp, mu, sigma = tnet.act(torch.from_numpy(obs), torch.from_numpy(eps))
    np.testing.assert_allclose(sigma.detach().numpy(), std, **NET_TOL)
    np.testing.assert_allclose(a.detach().numpy(), actions, **NET_TOL)
    np.testing.assert_allclose(lp.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_joint_mean_value_matches(nets):
    jnet, params, tnet = nets
    obs, cobs = _obs(3)
    jm, jv = jnet.joint_mean_value(params, jnp.asarray(obs), jnp.asarray(cobs))
    tm, tv = tnet.joint_mean_value(torch.from_numpy(obs), torch.from_numpy(cobs))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), **NET_TOL)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **NET_TOL)


def test_port_init_is_torch_default_linear_init():
    _, train_cfg = torch_registry.get_cfgs("GR1T1")
    net = ActorCritic(39, 168, 10, train_cfg.policy, generator=torch.Generator().manual_seed(0))
    for lin in net.linears():
        bound = 1.0 / np.sqrt(lin.in_features)
        assert float(lin.weight.detach().abs().max()) <= bound and float(lin.bias.detach().abs().max()) <= bound
    assert torch.equal(net.std(), torch.full((10,), 0.2))


# ---------------------------------------------------------------------------
# the rollout
# ---------------------------------------------------------------------------


def jax_rollout(jrun, env_state, obs, critic_obs, params, key):
    """``OnPolicyRunner._rollout`` of the JAX package (non-recurrent, separate
    actor and critic stacks), restated as a host loop over its jitted
    pieces: jitting the whole scan takes over 150 s on the CPU, the env step
    alone about 45 s. Same statements, same key splits, same order."""
    env, net = jrun.env, jrun.net
    assert not jrun.recurrent and not jrun.alg.fused_trunk
    step = jax.jit(env.step)
    act = jax.jit(net.act)
    evaluate = jax.jit(net.evaluate)
    trans, acc = [], {"rew": 0.0, "done": 0.0, "ep_sums": 0.0, "ep_len_done": 0.0}
    for _ in range(jrun.num_steps_per_env):
        key, k_act = jax.random.split(key)
        actions, logp, mu, sigma = act(params, obs, k_act)
        values = evaluate(params, critic_obs)
        env_state, out = step(env_state, actions)
        rewards = out.rew + jrun.alg.gamma * values * out.extras["time_outs"]
        trans.append(dict(obs=obs, critic_obs=critic_obs, actions=actions, rewards=rewards,
                          dones=out.reset, values=values, log_prob=logp, mu=mu, sigma=sigma))
        acc = {
            "rew": acc["rew"] + out.rew,
            "done": acc["done"] + out.reset.astype(jnp.float32),
            "ep_sums": acc["ep_sums"] + out.extras["episode_done_sums"],
            "ep_len_done": acc["ep_len_done"] + out.extras["ep_len_done"],
        }
        obs, critic_obs = out.obs, out.pri_obs
    batch = {k: np.stack([np.asarray(tr[k]) for tr in trans]) for k in trans[0]}
    return env_state, obs, critic_obs, jax.device_get(acc), batch


@pytest.fixture(scope="module")
def rollouts(nets):
    from wiki_grx_gym_tpu.envs import task_registry as jax_registry

    jnet, params, _ = nets
    jenv, tenv = make_envs()
    _, jtrain = jax_registry.get_cfgs("GR1T1")
    _, ttrain = torch_registry.get_cfgs("GR1T1")
    for cfg in (jtrain, ttrain):
        cfg.runner.num_steps_per_env = T
        # 12 samples (3 steps x 4 envs) fill 2 minibatches, not GR1T1's 25
        cfg.algorithm.num_mini_batches = 2
        cfg.algorithm.num_learning_epochs = 2
    jtrain.algorithm.fused_update = True   # the whole-update kernel, as on the TPU
    jrun = JaxRunner(jenv, jtrain)
    trun = OnPolicyRunner(tenv, ttrain, device="cpu")
    actor_critic_from_numpy(trun.net, _params_numpy(params))

    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(1))
    obs, cobs = _obs(7, N)
    key = jax.random.PRNGKey(11)

    # the noise and U blocks the JAX rollout draws, rebuilt from its keys
    noise, blocks, k, rng = [], [], key, js.rng
    for _ in range(T):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (N, 10))))
        rng, k_block = jax.random.split(rng)
        blocks.append(np.asarray(jax.random.uniform(k_block, (N, jenv._step_u_cols[1]))))

    jout = jax_rollout(jrun, js, jnp.asarray(obs), jnp.asarray(cobs), params, key)

    noise, blocks = torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(blocks))
    ts = RunnerState(env_state=env_state_from_numpy(jax_state_to_numpy(js)),
                     obs=torch.from_numpy(obs), critic_obs=torch.from_numpy(cobs),
                     rng=torch.Generator().manual_seed(0))
    tout = trun.rollout(ts, noise=noise, u=blocks)

    # one whole iteration: the port's runner against the JAX pieces
    k_update = jax.random.PRNGKey(13)
    jst = jrun.alg.init(params)
    jb = JaxTransition(**{k: jnp.asarray(v) for k, v in jout[4].items()})
    jret, jadv = jrun.alg.compute_returns(jb, jnet.evaluate(params, jout[2]))
    jst2, jmetrics = jrun.alg.update(jst, jb, jret, jadv, k_update)
    _, n_blocks, used, _ = trun.alg.shuffle_geometry(T, N)
    perm = np.asarray(jax.random.permutation(k_update, n_blocks)[:used])
    assert trun.alg.path == "mega"
    ts_it = ts.replace(env_state=env_state_from_numpy(jax_state_to_numpy(js)),
                       rng=torch.Generator().manual_seed(0),
                       ppo=trun.alg.init(trun.net.params_flat.clone()))
    p0 = trun.net.params_flat.clone()
    tst_it, tmetrics = trun.iteration(ts_it, noise=noise, u=blocks, perm=perm)
    tb = tout[1]
    last = trun.net.evaluate(tout[0].critic_obs)
    tret, tadv = trun.alg.compute_returns(tb, last)
    iteration = dict(jax=(jst2, jmetrics, np.asarray(jret), np.asarray(jadv)),
                     port=(tst_it, tmetrics, tret.numpy(), tadv.numpy()),
                     p0=p0, lr=float(jst.learning_rate), steps=4, net=trun.net)
    trun.net.bind(p0)

    # the same rollout in float64: the port's float32 noise floor
    trun.net = copy.deepcopy(trun.net).double()
    ts64 = RunnerState(env_state=env_state_from_numpy(as_float64(jax_state_to_numpy(js))),
                       obs=torch.from_numpy(obs).double(),
                       critic_obs=torch.from_numpy(cobs).double(),
                       rng=torch.Generator().manual_seed(0))
    tout64 = trun.rollout(ts64, noise=noise.double(), u=blocks.double())
    assert tout64[0].obs.dtype == torch.float64
    last64 = trun.net.evaluate(tout64[0].critic_obs)
    ret64, adv64 = trun.alg.compute_returns(tout64[1], last64)
    iteration["port64"] = (ret64.numpy(), adv64.numpy())
    return jout, tout, tout64, iteration


@pytest.mark.parametrize("field", ["obs", "critic_obs", "actions", "rewards", "values",
                                   "log_prob", "mu", "sigma", "dones"])
def test_transition_buffer_matches(rollouts, field):
    (_, _, _, _, jb), (_, tb, _), (_, tb64, _), _ = rollouts
    got, want = getattr(tb, field).numpy(), jb[field]
    assert got.shape == want.shape == (T, N) + got.shape[2:]
    if field == "dones":
        np.testing.assert_array_equal(got, want)
    else:
        for t in range(T):
            assert_close_widened(got[t], want[t], getattr(tb64, field)[t].numpy(),
                                 err_msg=f"{field} step {t}")


@pytest.mark.parametrize("name", ["rew", "done", "ep_sums", "ep_len_done"])
def test_rollout_accumulators_match(rollouts, name):
    (_, _, _, ja, _), (_, _, ta), (_, _, ta64), _ = rollouts
    assert_close_widened(ta[name].numpy(), np.asarray(ja[name]), ta64[name].numpy(), err_msg=name)


def test_rollout_end_state_matches(rollouts):
    (js, jo, jc, _, _), (ts, _, _), (ts64, _, _), _ = rollouts
    assert_close_widened(ts.obs.numpy(), np.asarray(jo), ts64.obs.numpy(), err_msg="obs")
    assert_close_widened(ts.critic_obs.numpy(), np.asarray(jc), ts64.critic_obs.numpy(),
                         err_msg="critic_obs")
    assert_close_widened(ts.env_state.physics.q.numpy(), np.asarray(js.physics.q),
                         ts64.env_state.physics.q.numpy(), err_msg="q")
    np.testing.assert_array_equal(ts.env_state.episode_length.numpy(),
                                  np.asarray(js.episode_length))


@pytest.mark.parametrize("which", ["returns", "advantages"])
def test_iteration_gae_matches(rollouts, which):
    it = rollouts[3]
    i = 2 if which == "returns" else 3
    got, want, f64 = it["port"][i], it["jax"][i], it["port64"][i - 2]
    for t in range(T):
        assert_close_widened(got[t], want[t], f64[t], err_msg=f"{which} step {t}")


def test_iteration_update_matches(rollouts):
    it = rollouts[3]
    (jst2, jm, _, _), (tst, tm, _, _) = it["jax"], it["port"]
    for k in ("value_loss", "surrogate_loss", "kl", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    for k in ("mean_step_reward", "done_count", "mean_action_std"):
        assert np.isfinite(float(tm[k]))
    assert int(tst.ppo.count) == it["steps"]
    lr, steps, net = it["lr"], it["steps"], it["net"]
    want = np.asarray(ravel_pytree(jst2.params)[0])
    got = flat_to_jax_order(net, tst.ppo.params)
    start = flat_to_jax_order(net, it["p0"])
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * steps)
    d_got, d_want = got - start, want - start
    assert np.linalg.norm(d_want) > 0
    assert np.linalg.norm(d_got - d_want) <= 0.02 * np.linalg.norm(d_want)


# ---------------------------------------------------------------------------
# play from a JAX-exported policy.npz
# ---------------------------------------------------------------------------


def test_play_runs_from_jax_exported_policy_npz(nets, tmp_path):
    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    jnet, params, _ = nets
    path = str(tmp_path / "policy.npz")
    export_policy_npz(jnet, params, path)
    args = get_args(["--task", "GR1T1", "--policy", path, "--device", "cpu", "--num_envs", "4"])
    logger = play(args, num_steps=3, log_root=str(tmp_path))
    assert len(logger.rew_log["rew_total"]) == 3
    assert all(np.isfinite(v).all() for vals in {**logger.state_log, **logger.rew_log}.values()
               for v in vals)


def test_npz_actor_matches_numpy_loader(nets, tmp_path):
    from wiki_grx_gym_tpu_torch.convert import load_actor_npz

    jnet, params, _ = nets
    path = str(tmp_path / "policy.npz")
    export_policy_npz(jnet, params, path)
    _, train_cfg = torch_registry.get_cfgs("GR1T1")
    net = load_actor_npz(ActorCritic(39, 168, 10, train_cfg.policy), path)
    obs, _ = _obs(9)
    np.testing.assert_allclose(net.act_inference(torch.from_numpy(obs)).detach().numpy(),
                               load_policy_npz(path)(obs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(net.std().detach().numpy(), np.asarray(params.std))
