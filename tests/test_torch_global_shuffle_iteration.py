"""A dp2 training iteration under the reference's global shuffle
(``algorithm.permutation_groups = 1``, the run JAX's CLI makes on a mesh)
against the port's one-process iteration with ``permutation_groups = 1``,
over two gloo ranks (CPU).

tests/test_torch_parallel.py's iteration (8 GR1T1 envs, decimation 2, 4
steps, the command curriculum on, half the envs timing out, 2 minibatches x
1 epoch) on the path both runs select, the mega path (K3's plain version
on the gathered global batch on every rank): from the same initial state
(each rank its slice), with the action noise, the env's uniform blocks and
the block permutation of the global batch injected, the metrics at rtol
1e-4 / atol 6e-5 and the params at rtol 2e-5 / atol 4e-5 (JAX's dp1-vs-dp8
tolerances, tests/test_parallel.py), the command range equal; the ranks end
bit-identical. The spawn joins within 120 s.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import JOIN_S, N_ENVS, STEPS, WORLD, _threads
from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner, RunnerState
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn


def iteration_cfgs():
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    cfg.control.decimation = 2
    cfg.commands.curriculum = True
    train_cfg.runner.num_steps_per_env = STEPS
    train_cfg.algorithm.num_mini_batches = 2
    train_cfg.algorithm.num_learning_epochs = 1
    train_cfg.algorithm.permutation_groups = 1
    return cfg, train_cfg


def one_process_start():
    """The one-process runner and its initial state, half the envs a few
    steps from their timeout; the injected noise, uniform blocks and block
    permutation of the global batch."""
    cfg, train_cfg = iteration_cfgs()
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, train_cfg, device="cpu")
    s0 = runner.init_state()
    ep = s0.env_state.episode_length.clone()
    ep[::2] = env.max_episode_length - 2
    s0 = s0.replace(env_state=s0.env_state.replace(episode_length=ep))
    rng = np.random.RandomState(17)
    noise = torch.from_numpy(rng.randn(STEPS, N_ENVS, env.num_actions).astype(np.float32))
    u = torch.from_numpy(rng.rand(STEPS, N_ENVS, env._step_u_cols[1]).astype(np.float32))
    n_blocks, used = runner.alg.perm_size(STEPS, N_ENVS)
    perm = torch.from_numpy(rng.permutation(n_blocks)[:used])
    return runner, s0, noise, u, perm


def iteration_worker(rank, world, init, out_dir):
    _threads()
    dp = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        _, s0, noise, u, perm = one_process_start()
        cfg, train_cfg = iteration_cfgs()
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None, dp=dp)
        assert runner.alg.path == "mega" and runner.alg.gathered and runner.rule_path == "mega+global"
        assert runner.alg.perm_size(STEPS, env.num_envs)[1] == len(perm)   # the global batch's blocks
        lo, hi = env.shard
        mine = lambda x: sharding.shard_env_state(x, lo, hi, N_ENVS)
        start = runner.init_state()
        state = RunnerState(env_state=mine(s0.env_state), obs=mine(s0.obs), critic_obs=mine(s0.critic_obs),
                            rng=start.rng, ppo=start.ppo)
        state, metrics = runner.iteration(state, noise=noise[:, lo:hi], u=u[:, lo:hi], perm=perm)
        digests = sharding.check_replicas_identical(dp, state.ppo)
        torch.save(dict(metrics={k: float(v) for k, v in metrics.items()}, params=state.ppo.params,
                        digests=digests, cmd_range=state.env_state.cmd_lin_vel_x_range),
                   f"{out_dir}/iteration_rank{rank}.pt")
    finally:
        mesh.destroy(dp)


@pytest.fixture(scope="module")
def global_iteration(tmp_path_factory):
    runner, s0, noise, u, perm = one_process_start()
    assert runner.alg.path == "mega" and not runner.alg.gathered
    state, metrics = runner.iteration(s0, noise=noise, u=u, perm=perm)
    out_dir = tmp_path_factory.mktemp("global_iteration")
    spawn(iteration_worker, WORLD, args=(str(out_dir),), rendezvous_dir=str(out_dir), timeout_s=JOIN_S)
    ranks = [torch.load(out_dir / f"iteration_rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ({k: float(v) for k, v in metrics.items()}, state), ranks


def test_dp2_global_shuffle_iteration_matches_one_process(global_iteration):
    (m1, s1), ranks = global_iteration
    assert m1["done_count"] == N_ENVS // 2   # the planted timeouts reset half the envs
    for r in ranks:
        for k in m1:
            np.testing.assert_allclose(r["metrics"][k], m1[k], rtol=1e-4, atol=6e-5, err_msg=k)
        np.testing.assert_allclose(r["params"].numpy(), s1.ppo.params.numpy(), rtol=2e-5, atol=4e-5)
        assert torch.equal(r["cmd_range"], s1.env_state.cmd_lin_vel_x_range)
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    assert torch.equal(ranks[0]["digests"], ranks[1]["digests"])
