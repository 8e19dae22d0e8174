"""The port stands alone: importing ``wiki_grx_gym_tpu_torch`` and every
submodule (and ``chip_smoke.py``) loads no ``jax*`` module and nothing of
the JAX package; the entry points refuse ``device="cuda"`` without a card
and refuse what is outside the slice."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from wiki_grx_gym_tpu_torch.sim import cuda_step

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "wiki_grx_gym_tpu_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _run(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), env=env, timeout=300)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'flax', 'optax', 'orbax')) or m == 'wiki_grx_gym_tpu' or m.startswith('wiki_grx_gym_tpu.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] >= 20
    assert out["bad"] == []
    # the data-parallel and symmetry modules are among them
    assert {"wiki_grx_gym_tpu_torch.parallel.mesh", "wiki_grx_gym_tpu_torch.parallel.sharding",
            "wiki_grx_gym_tpu_torch.parallel.launch", "wiki_grx_gym_tpu_torch.learn.symmetry",
            "wiki_grx_gym_tpu_torch.scripts.bench_scaling",
            "wiki_grx_gym_tpu_torch.scripts.multihost_dryrun"} <= set(_modules())


NEW_MODULES = [
    "wiki_grx_gym_tpu_torch.utils.logger", "wiki_grx_gym_tpu_torch.deploy.runtime",
    "wiki_grx_gym_tpu_torch.models.urdf", "wiki_grx_gym_tpu_torch.models.mjcf",
    "wiki_grx_gym_tpu_torch.models.serialize", "wiki_grx_gym_tpu_torch.tools.import_urdf",
    "wiki_grx_gym_tpu_torch.tools.eval_tracking", "wiki_grx_gym_tpu_torch.tools.visualize",
    "wiki_grx_gym_tpu_torch.scripts.play", "wiki_grx_gym_tpu_torch.learn.runner",
]


def test_eval_and_deploy_modules_import_with_jax_blocked():
    """The eval and deploy modules import with any import of ``jax`` (and its
    kin) or of the JAX package made to fail, and then compile a robot, write
    a ``.grxpolicy`` and read it through the native runtime."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'wiki_grx_gym_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
        "import numpy as np, torch, tempfile, os\n"
        "from wiki_grx_gym_tpu_torch.models.urdf import compile_robot\n"
        "from wiki_grx_gym_tpu_torch.deploy.runtime import NativePolicy, export_policy_bin\n"
        "from wiki_grx_gym_tpu_torch.envs import task_registry\n"
        "from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic\n"
        "m = compile_robot('<robot name=\"r\"><link name=\"a\"/></robot>')\n"
        "_, tc = task_registry.get_cfgs('GR1T1')\n"
        "d = tempfile.mkdtemp()\n"
        "export_policy_bin(ActorCritic(39, 168, 10, tc.policy), os.path.join(d, 'p.grxpolicy'))\n"
        "print(m.num_bodies, NativePolicy(os.path.join(d, 'p.grxpolicy'))(np.zeros(39)).shape)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "1 (10,)"


def test_port_sources_do_not_import_jax():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import flax", "import optax")), (f, s)
            assert not (s.startswith(("import wiki_grx_gym_tpu", "from wiki_grx_gym_tpu"))
                        and "wiki_grx_gym_tpu_torch" not in s), (f, s)


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run for real")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from wiki_grx_gym_tpu_torch import resolve_device
    from wiki_grx_gym_tpu_torch.envs import task_registry

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        task_registry.make_env("GR1T1")   # the default device is cuda
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("mutate,ctrl", [
    pytest.param(lambda c: setattr(c.control, "control_type", "T"), 2, id="mutate0-control_type"),
    pytest.param(lambda c: setattr(c.control, "control_type", "V"), 1, id="mutate1-item 11"),
    pytest.param(lambda c: (cuda_step.terrain_config("heightfield", 2, 2)(c),
                            setattr(c.control, "control_type", "V")), 1, id="mutate2-item 11"),
    pytest.param(lambda c: (cuda_step.terrain_config("trimesh", 2, 2)(c),
                            setattr(c.control, "control_type", "T")), 2, id="mutate3-item 11"),
    pytest.param(lambda c: (cuda_step.heading_config(c), setattr(c.control, "control_type", "V")), 1,
                 id="mutate4-item 11"),
])
def test_env_refuses_outside_the_slice(mutate, ctrl):
    """The V and T control modes, which the env refused before, build on the
    plane, on terrain and with heading commands, and K1 has a program for
    each (its control law ``ctrl`` in the sizes; ``last_qd`` an input for
    V). An unknown control type is refused."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    mutate(cfg)
    op = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")[0].decimation_op
    assert op.kernel_support_error() is None
    assert op.sizes.CTRL == ctrl and op.deci.control_type == cfg.control.control_type
    assert op.with_last_qd == (ctrl == 1 or op.post is not None)
    assert (op.deci.damping_coeff is None) == (ctrl == 2)
    cfg.control.control_type = "X"
    with pytest.raises(ValueError, match="control_type"):
        task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")


@pytest.mark.parametrize("task", ["GR1T1_full", "GR1T2_full"])
def test_full_body_tasks_refused(task):
    """The 32-DOF tasks build (K1 takes up to 32 dofs), with heading
    commands too, and with the V control law (refused before): K1's
    program then reads ``last_qd`` and has a kernel."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    cfg, _ = task_registry.get_cfgs(task)
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    assert env.num_dof == 32 and env.obs_dim == 105
    cuda_step.heading_config(cfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device="cpu")
    assert not env._post_fold and env.decimation_op.kernel_support_error() is None
    cfg.control.control_type = "V"
    op = task_registry.make_env(task, env_cfg=cfg, device="cpu")[0].decimation_op
    assert op.kernel_support_error() is None and op.with_last_qd and op.sizes.CTRL == 1
    assert op.sizes.ND == 32 and op.post is None


def test_lstm_runner_refused():
    """The recurrent task, which the runner refused before, builds its
    runner with the LSTM actor-critic on the recurrent update path; so does
    it with the symmetry loss (refused before, ROADMAP queue 1 item 13),
    whose recurrent form is then PPO's extra loss term."""
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

    cfg, train = task_registry.get_cfgs("GR1T1_lstm")
    cfg.env.num_envs = 2
    env, _ = task_registry.make_env("GR1T1_lstm", env_cfg=cfg, device="cpu")
    runner = OnPolicyRunner(env, train, device="cpu")
    assert runner.recurrent and isinstance(runner.net, ActorCriticRecurrent)
    assert runner.net.num_params == 1_333_397
    train.algorithm.symmetry_coef = 0.5
    runner = OnPolicyRunner(env, train, device="cpu")
    assert runner.recurrent and runner.alg.extra_loss_fn.__qualname__.startswith("make_mirror_loss_recurrent")


def test_kernel_path_refuses_unsupported_programs():
    """On a CUDA tensor the wrapper launches K1 or raises. K1 is built for
    each program's sizes, terrain mode and fold, so the full-body tasks,
    GR1T2 and GR1T1 without self-collision pairs (other sizes than the
    GR1T1 lower limb's), and GR1T1 on heightfield and trimesh terrain and
    with heading commands (programs without the post fold) all have a
    kernel; so do the V and T control laws and the fold with every reward
    term and penalized contact groups, which were refused before."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    def no_pairs(c):
        c.asset.self_collisions = 1

    for task, mutate, program in [
            ("GR1T1", None, (0, 1)), ("GR1T1_full", None, (0, 1)), ("GR1T2_full", None, (0, 1)),
            ("GR1T2", None, (0, 1)), ("GR1T1", no_pairs, (0, 1)),
            ("GR1T1", cuda_step.terrain_config("heightfield", 2, 2), (1, 0)),
            ("GR1T1", cuda_step.terrain_config("trimesh", 2, 2), (2, 0)),
            ("GR1T1", cuda_step.heading_config, (0, 0))]:
        cfg, _ = task_registry.get_cfgs(task)
        cfg.env.num_envs = 2
        if mutate is not None:
            mutate(cfg)
        op = task_registry.make_env(task, env_cfg=cfg, device="cpu")[0].decimation_op
        assert op.kernel_support_error() is None, (task, mutate)
        assert (op.sizes.TERRAIN, op.sizes.FOLD) == program, (task, mutate)
        if mutate is no_pairs:
            assert op.sizes.NPAIR == 0
    for control in ("V", "T"):   # refused before; a program each now
        cfg, _ = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = 2
        cfg.control.control_type = control
        op = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")[0].decimation_op
        assert op.kernel_support_error() is None and op.sizes.CTRL == "PVT".index(control)
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = 2
    cfg.rewards.scales.collision = -1.0   # without a lane form before
    cfg.asset.penalize_contacts_on = ["thigh", "shank"]   # refused by the kernel before
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device="cpu")
    op = env.decimation_op
    assert "collision" in op.post.reward_names and op.kernel_support_error() is None
    assert (op.sizes.NPEN, op.sizes.NPENP) == (4, 8)
