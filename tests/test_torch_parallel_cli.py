"""The data-parallel entry points of the port, and what they refuse.

- ``--num_mp 2`` (tensor parallelism) builds the dp x mp mesh before the
  runner and passes it at construction (two gloo ranks through
  ``scripts/train.py``'s ``train``: the rank's net is its shard, PPO on the
  xla path); ``--num_mp 2`` without ``--distributed`` raises, and so does a
  world that ``num_mp`` does not divide; torchrun's variables without
  ``--distributed`` raise; ``init_distributed`` refuses a partial group
  description; ``shard_bounds`` refuses env counts the ranks do not divide.
- The reference hazard: JAX's ``task_registry.make_alg_runner`` builds the
  runner, and so its PPO, with no mesh, and its CLI sets ``runner.mesh``
  afterwards (``scripts/train.py:24-26``): that PPO keeps ``perm_groups ==
  1`` and no dp kernel path whatever mesh is set. The port's runner is
  built with the group (as JAX's ``bench_scaling`` and
  ``tests/test_parallel.py`` build theirs): ``permutation_groups = 0``
  resolves to the group's size and the step path runs K2 per shard.
- A rank's env is its slice of the global one: the plane's origin grid and
  the terrain types follow the global env index.
- ``scripts/multihost_dryrun.py`` over two gloo processes exits 0 (finite
  losses, bit-identical ranks, only rank 0 wrote logs and a checkpoint), and
  over four at dp2 x mp2 (``--num_mp 2``: finite losses, params moved,
  identical peers).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from wiki_grx_gym_tpu_torch.envs import task_registry
from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
from wiki_grx_gym_tpu_torch.parallel.launch import spawn
from wiki_grx_gym_tpu_torch.scripts.train import train
from wiki_grx_gym_tpu_torch.sim import cuda_step
from wiki_grx_gym_tpu_torch.utils.helpers import get_args

ROOT = Path(__file__).resolve().parents[1]


def cli_mp_worker(rank, world, init, out_dir):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = mesh.init_distributed(init_method=init, world_size=world, rank=rank, device="cpu", timeout_s=60)
    try:
        args = get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", "4", "--max_iterations", "0",
                         "--distributed", "--num_mp", "2"])
        with pytest.raises(ValueError, match="--num_mp 2 needs --distributed and the mesh"):
            train(args, log_root=None, dp=group)   # the group without its mesh
        runner, _ = train(args, log_root=None, dp=mesh.make_mesh(args.num_mp, group))
        alg, net = runner.alg, runner.net
        torch.save(dict(mp=(runner.mp.world, runner.mp.rank), dp=(runner.dp.world, runner.dp.rank),
                        params=net.num_params, full=net.full_num_params, path=alg.path, groups=alg.perm_groups,
                        ppo_mp=alg.mp is runner.mp, net_mp=net.mp is runner.mp, lead=runner.is_lead),
                   os.path.join(out_dir, f"cli_rank{rank}.pt"))
    finally:
        mesh.destroy(group)


def test_num_mp_2_raises_naming_14b(tmp_path):
    """``--num_mp 2`` builds the dp x mp mesh at construction (it was refused
    before, ROADMAP item 14b); ``--num_mp 2`` without ``--distributed``
    raises; ``world % num_mp`` raises."""
    spawn(cli_mp_worker, 2, args=(str(tmp_path),), rendezvous_dir=str(tmp_path), timeout_s=120)
    for r in range(2):
        got = torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
        assert got["mp"] == (2, r) and got["dp"] == (1, 0) and got["lead"] == (r == 0)
        assert got["path"] == "xla" and got["groups"] == 1 and got["ppo_mp"] and got["net_mp"]
        assert got["full"] == 436885 and got["params"] < got["full"]
    with pytest.raises(ValueError, match="needs --distributed"):
        train(get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", "2", "--num_mp", "2"]), log_root=None)
    from wiki_grx_gym_tpu_torch.scripts.train import main
    with pytest.raises(ValueError, match="needs --distributed"):
        main(["--task", "GR1T1", "--device", "cpu", "--num_mp", "2"])
    with pytest.raises(ValueError, match="not divisible by num_mp=2"):
        mesh.make_mesh(2, mesh.DataParallel(world=3, rank=0, device=torch.device("cpu")))
    with pytest.raises(ValueError, match="--distributed"):
        mesh.make_mesh(num_mp=2)
    assert mesh.make_mesh(num_mp=1) is None
    args = get_args(["--distributed", "--dist_backend", "gloo"])
    assert args.distributed and args.dist_backend == "gloo" and args.num_mp == 1


def test_distributed_runs_refuse_to_fall_back(monkeypatch):
    args = get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", "2"])
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="--distributed"):
        train(args, log_root=None)
    with pytest.raises(ValueError, match="torchrun"):
        mesh.init_distributed(init_method="file:///nowhere", world_size=2, rank=0, device="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k)
    with pytest.raises(ValueError, match="init_method, world_size and rank"):
        mesh.init_distributed(world_size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        mesh.init_distributed(backend="nccl", init_method="file:///nowhere", world_size=1, rank=0, device="cpu")
    with pytest.raises(RuntimeError, match="a data-parallel run"):
        train(get_args(["--task", "GR1T1", "--device", "cpu", "--num_envs", "2", "--distributed"]),
              log_root=None)


def test_shard_bounds():
    assert [sharding.shard_bounds(4096, 2, r) for r in range(2)] == [(0, 2048), (2048, 4096)]
    assert sharding.rank_seed(5, 0) == 5 and sharding.rank_seed(5, 1) != 6
    with pytest.raises(ValueError, match="not divisible"):
        sharding.shard_bounds(10, 4, 0)
    with pytest.raises(ValueError, match="outside"):
        sharding.shard_bounds(8, 2, 2)


def test_jax_cli_builds_ppo_without_the_mesh():
    """Pinned reference hazard (ROADMAP queue 3): the JAX CLI's runner has
    perm_groups 1 and no dp kernel mesh on a dp2 mesh set after the fact;
    the same runner built with the mesh has both."""
    import jax

    from wiki_grx_gym_tpu.envs import task_registry as jax_registry
    from wiki_grx_gym_tpu.learn.runner import OnPolicyRunner as JaxRunner
    from wiki_grx_gym_tpu.parallel.mesh import make_mesh as jax_make_mesh

    cfg, train_cfg = jax_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 4
    train_cfg.algorithm.fused_update = True
    env, _ = jax_registry.make_env("GR1T1", env_cfg=cfg)
    mesh2 = jax_make_mesh(num_mp=1, devices=jax.devices()[:2])
    runner, _ = jax_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    runner.mesh = mesh2   # scripts/train.py:24-26
    assert runner.alg.perm_groups == 1 and runner.alg.fused_dp_mesh is None
    built = JaxRunner(env, train_cfg, log_dir=None, mesh=mesh2)
    assert built.alg.perm_groups == 2 and built.alg.fused_dp_mesh is mesh2


def test_port_runner_takes_the_group_at_construction():
    """A rank's runner (no process group is needed to build one): groups =
    the world, the step path; its env is its slice of the global env."""
    dp = mesh.DataParallel(world=2, rank=1, device=torch.device("cpu"))
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 8
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu", dp=dp)
    assert env.num_envs == 4 and env.shard == (4, 8) and env.num_envs_global == 8
    runner = OnPolicyRunner(env, train_cfg, device="cpu", dp=dp)
    assert runner.alg.perm_groups == 2 and runner.alg.local_groups == 1 and runner.alg.path == "step"
    assert not runner.is_lead and runner.rank_seed == sharding.rank_seed(train_cfg.seed, 1)
    full, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    assert (env._origins_np == full._origins_np[4:8]).all()
    with pytest.raises(ValueError, match="must hold envs"):
        OnPolicyRunner(full, train_cfg, device="cpu", dp=dp)
    # terrain types in equal blocks of the global envs
    cuda_step.terrain_config("heightfield", 2, 2)(cfg)
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu", dp=dp)
    full, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    mine = env.terrain.sample_origins(g, 4, cfg.terrain, offset=4, total=8)[2]
    assert torch.equal(mine, full.terrain.sample_origins(g, 8, cfg.terrain)[2][4:8])


def test_multihost_dryrun_exits_0(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "wiki_grx_gym_tpu_torch.scripts.multihost_dryrun",
                          "--procs", "2", "--iters", "2", "--num-envs", "8", "--log-root", str(tmp_path / "logs"),
                          "--timeout", "100"],
                         capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=150)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "-> OK" in res.stdout
    assert '"digests_equal": true' in res.stdout
    assert sorted(os.listdir(tmp_path / "logs")) == ["rank0"]


def test_multihost_dryrun_dp2_mp2_exits_0(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "wiki_grx_gym_tpu_torch.scripts.multihost_dryrun",
                          "--procs", "4", "--num_mp", "2", "--iters", "1", "--num-envs", "8",
                          "--log-root", str(tmp_path / "logs"), "--timeout", "100"],
                         capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=150)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "-> OK" in res.stdout and res.stdout.count('"digests_equal": true') == 4
    assert res.stdout.count('"path": "xla"') == 4 and '"num_mp": 2' in res.stdout
    assert sorted(os.listdir(tmp_path / "logs")) == ["rank0"]
