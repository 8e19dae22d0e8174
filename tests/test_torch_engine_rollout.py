"""Port parity for the engine path's compiled collection: the port's per-step
collection (``learn/graphs.py``: A1 one rollout step's graph replayed T
times with the step index on the device, then A2 the last values, GAE and
the update's inputs; the graphs stood in as in tests/test_torch_graphs.py)
against JAX's rollout with ``use_pallas=False`` (its vmapped
``physics_step`` under ``lax.scan`` inside ``env.step``), on the CPU.

GR1T1 on the plane at 4 envs, decimation 2, T = 3 steps, with
tests/test_torch_engine_env.py's start: env 0 times out at step 0 and env 1
at step 1 (the timeout bootstrap and the done sums), every robot lowered
until its lowest contact sphere is 4 mm in the ground (the steps run the
contact). JAX's rollout is tests/test_torch_rollout.py's ``jax_rollout`` (a
host loop over its jitted pieces, the same key splits); the port's
``_train_iter`` starts from the converted state, observations and params,
with the action noise and the per-step U blocks rebuilt from JAX's keys and
the update's block permutation from JAX's update key injected. Compared:
the Transition buffer, the ``acc`` sums, the end state (observations, the
physics, the episode counters) and GAE's returns and advantages (JAX's
``compute_returns`` on its own buffer). Tolerances are
tests/test_torch_engine_env.py's: rtol 1e-4 / atol 1e-5, widened by 3x the
port's float32 noise floor (the port's eager rollout and GAE run again in
float64 from the same state, noise and U); counters and booleans exact."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine_env import configure
from test_torch_env import PHYS, as_float64, assert_close_widened
from test_torch_graphs import stand_in_graphs
from test_torch_rollout import T, _params_numpy, jax_rollout
from test_torch_terrain_env import state_to_numpy
from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.learn.ppo import Transition as JaxTransition
from wiki_grx_gym_tpu.learn.runner import OnPolicyRunner as JaxRunner
from wiki_grx_gym_tpu_torch.convert import actor_critic_from_numpy, env_state_from_numpy
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, RunnerState
from wiki_grx_gym_tpu_torch.sim import cuda_step

N = 4


def _train(cfg):
    cfg.runner.num_steps_per_env = T
    cfg.algorithm.num_mini_batches = 2   # 12 samples (3 steps x 4 envs)
    cfg.algorithm.num_learning_epochs = 1
    return cfg


@pytest.fixture(scope="module")
def collections():
    jc, jtrain = jax_registry.get_cfgs("GR1T1")
    tc, ttrain = torch_registry.get_cfgs("GR1T1")
    jenv, _ = jax_registry.make_env("GR1T1", env_cfg=configure(jc, "plane"))
    tenv, _ = torch_registry.make_env("GR1T1", env_cfg=configure(tc, "plane"), device="cpu")
    assert jenv._pallas_mode() is None and tenv.backend == "engine"
    jrun = JaxRunner(jenv, _train(jtrain))
    trun = OnPolicyRunner(tenv, _train(ttrain), device="cpu")
    params = jax.jit(jrun.net.init)(jax.random.PRNGKey(3))
    actor_critic_from_numpy(trun.net, _params_numpy(params))
    p0 = trun.net.params_flat.clone()

    js = jax.jit(jenv.init_state)(jax.random.PRNGKey(0))
    ml = jenv.max_episode_length
    js = js.replace(episode_length=jnp.asarray([ml, ml - 1, 3, 7], jnp.int32))
    pos, r = cuda_step.point_positions(tenv, env_state_from_numpy(state_to_numpy(js)))
    gap = (pos[..., 2] - r - tenv.height_fn(pos[..., 0], pos[..., 1])).amin(dim=1)
    js = js.replace(physics=js.physics.replace(
        base_pos=js.physics.base_pos.at[:, 2].add(-jnp.asarray(gap.numpy()) - 0.004)))
    rng = np.random.RandomState(7)
    obs = rng.randn(N, tenv.obs_dim).astype(np.float32)
    cobs = rng.randn(N, tenv.pri_obs_dim).astype(np.float32)

    # the noise and U blocks the JAX rollout draws, rebuilt from its keys
    key = jax.random.PRNGKey(11)
    noise, blocks, k, g = [], [], key, js.rng
    for _ in range(T):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (N, tenv.num_actions))))
        g, k_block = jax.random.split(g)
        blocks.append(np.asarray(jax.random.uniform(k_block, (N, jenv._step_u_cols[1]))))
    noise, blocks = torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(blocks))
    _, n_blocks, used, _ = trun.alg.shuffle_geometry(T, N)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(jax.random.PRNGKey(13), n_blocks)[:used]))

    # JAX: the rollout and GAE
    j_state, j_obs, j_cobs, j_acc, j_batch = jax_rollout(jrun, js, jnp.asarray(obs), jnp.asarray(cobs), params, key)
    jb = JaxTransition(**{k: jnp.asarray(v) for k, v in j_batch.items()})
    j_ret, j_adv = jrun.alg.compute_returns(jb, jax.jit(jrun.net.evaluate)(params, j_cobs))
    jax_out = {"state": state_to_numpy(j_state), "obs": np.asarray(j_obs), "critic_obs": np.asarray(j_cobs),
               "acc": {k: np.asarray(v) for k, v in j_acc.items()}, "batch": j_batch,
               "returns": np.asarray(j_ret), "advantages": np.asarray(j_adv)}

    # the port: the per-step collection (graphs stood in), injected draws
    state = RunnerState(env_state=env_state_from_numpy(state_to_numpy(js)), obs=torch.from_numpy(obs),
                        critic_obs=torch.from_numpy(cobs), rng=torch.Generator().manual_seed(0),
                        ppo=trun.alg.init(p0.clone()))
    with pytest.MonkeyPatch.context() as mp:
        stand_in_graphs(mp)
        s, _ = trun._train_iter(state, noise=noise, u=blocks, perm=perm)
        ci = trun.compiled
        assert ci.per_step and ci.collect["inject"].replays == T - 1 and ci.tail["inject"].replays == 0
        last = {k: copy.deepcopy(v) for k, v in ci.last.items()}
        port = {"state": s.env_state, "obs": s.obs.clone(), "critic_obs": s.critic_obs.clone(), **last}

    # the port's float32 noise floor: its eager rollout and GAE in float64
    trun.net.bind(p0)
    trun.net = copy.deepcopy(trun.net).double()
    s64 = RunnerState(env_state=env_state_from_numpy(as_float64(state_to_numpy(js))),
                      obs=torch.from_numpy(obs).double(), critic_obs=torch.from_numpy(cobs).double(),
                      rng=torch.Generator().manual_seed(0))
    rs64, b64, acc64 = trun.rollout(s64, noise=noise.double(), u=blocks.double())
    _, ret64, adv64 = trun._returns(rs64, b64)
    port64 = {"state": rs64.env_state, "obs": rs64.obs, "critic_obs": rs64.critic_obs, "batch": b64,
              "acc": acc64, "returns": ret64, "advantages": adv64}
    return jax_out, port, port64


@pytest.mark.parametrize("field", ["obs", "critic_obs", "actions", "rewards", "values", "log_prob", "mu",
                                   "sigma", "dones"])
def test_transition_buffer_matches_jax(collections, field):
    jax_out, port, port64 = collections
    got, want = getattr(port["batch"], field).numpy(), jax_out["batch"][field]
    assert got.shape == want.shape == (T, N) + got.shape[2:]
    if field == "dones":
        np.testing.assert_array_equal(got, want)
        assert want[0][0] and want[1][1]   # the planted timeouts
        return
    for t in range(T):
        assert_close_widened(got[t], want[t], getattr(port64["batch"], field)[t].numpy(),
                             err_msg=f"{field} step {t}")


@pytest.mark.parametrize("name", ["rew", "done", "ep_sums", "ep_len_done"])
def test_acc_sums_match_jax(collections, name):
    jax_out, port, port64 = collections
    assert_close_widened(port["acc"][name].numpy(), jax_out["acc"][name], port64["acc"][name].numpy(),
                         err_msg=name)


def test_end_state_matches_jax(collections):
    jax_out, port, port64 = collections
    for k in ("obs", "critic_obs"):
        assert_close_widened(port[k].numpy(), jax_out[k], port64[k].numpy(), err_msg=k)
    for k in PHYS:
        assert_close_widened(getattr(port["state"].physics, k).numpy(), jax_out["state"]["physics"][k],
                             getattr(port64["state"].physics, k).numpy(), err_msg=k)
    for k in ("episode_length", "common_step", "feet_contact_last"):
        np.testing.assert_array_equal(getattr(port["state"], k).numpy(), jax_out["state"][k], err_msg=k)


@pytest.mark.parametrize("which", ["returns", "advantages"])
def test_gae_matches_jax(collections, which):
    jax_out, port, port64 = collections
    got, want, f64 = port[which].numpy(), jax_out[which], port64[which].numpy()
    for t in range(T):
        assert_close_widened(got[t], want[t], f64[t], err_msg=f"{which} step {t}")
