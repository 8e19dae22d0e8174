"""Port parity: config tree, task registry, robot specs.

The PyTorch port keeps its own copies of the config classes and robot JSON
files; these tests hold them equal to the JAX package's."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from wiki_grx_gym_tpu.envs import task_registry as jax_registry
from wiki_grx_gym_tpu.envs.base_config import class_to_dict as jax_class_to_dict
from wiki_grx_gym_tpu.models.serialize import load_robot as jax_load_robot
from wiki_grx_gym_tpu_torch.envs import task_registry as torch_registry
from wiki_grx_gym_tpu_torch.envs.base_config import class_to_dict as torch_class_to_dict
from wiki_grx_gym_tpu_torch.models.robot import ARRAY_FIELDS
from wiki_grx_gym_tpu_torch.models.serialize import load_robot as torch_load_robot

ROOT = Path(__file__).resolve().parents[1]
JAX_RES = ROOT / "wiki_grx_gym_tpu/models/resources"
TORCH_RES = ROOT / "wiki_grx_gym_tpu_torch/models/resources"
TASKS = sorted(jax_registry.get_task_names())
SPECS = sorted(p.name for p in JAX_RES.glob("*.json"))


def test_registry_names_and_aliases_match():
    assert torch_registry.get_task_names() == jax_registry.get_task_names()
    for name in TASKS:
        assert (torch_registry.env_cfgs[name].__name__ == jax_registry.env_cfgs[name].__name__)
        assert (torch_registry.train_cfgs[name].__name__ == jax_registry.train_cfgs[name].__name__)


@pytest.mark.parametrize("task", TASKS)
def test_config_trees_equal(task):
    je, jt = jax_registry.get_cfgs(task)
    te, tt = torch_registry.get_cfgs(task)
    assert torch_class_to_dict(te) == jax_class_to_dict(je)
    assert torch_class_to_dict(tt) == jax_class_to_dict(jt)


@pytest.mark.parametrize("spec", SPECS)
def test_resource_copies_byte_identical(spec):
    assert (TORCH_RES / spec).exists(), spec
    assert filecmp.cmp(JAX_RES / spec, TORCH_RES / spec, shallow=False)


@pytest.mark.parametrize("spec", SPECS)
def test_load_robot_matches_field_by_field(spec):
    jm = jax_load_robot(str(JAX_RES / spec))
    tm = torch_load_robot(str(TORCH_RES / spec))
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("parent", "point_body", "point_link", "name", "body_names", "dof_names",
              "link_names", "link_frames", "gravity_scale"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert (tm.num_bodies, tm.num_dof, tm.num_points) == (jm.num_bodies, jm.num_dof, jm.num_points)
    for sub in ("foot_roll", "knee", "ankle", "thigh"):
        assert tm.find_links(sub) == jm.find_links(sub)
        assert tm.find_dofs(sub) == jm.find_dofs(sub)
