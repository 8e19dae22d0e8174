"""The port's robot importers against the JAX package's (``models/urdf.py``,
``models/mjcf.py``, ``models/serialize.py``, ``tools/import_urdf.py``).

The robots are the inline ones of tests/test_urdf.py (the pendulum) and
tests/test_mjcf.py (the three-link leg as URDF and as MJCF, the hinge with
an anchor, a box geom turned by euler, by quat and not at all), copied
here. For each:

- ``compile_robot``: every array field bit-identical (both compute in
  float64 and cast to float32 once, at the end) and every static field
  equal;
- ``parse_mjcf``: the same intermediate (links, joints, transforms) exactly;
- ``save_robot``: the same JSON text; the port's ``load_robot`` reads it
  back bit for bit;
- an unsupported joint raises NotImplementedError in both;
- ``python -m wiki_grx_gym_tpu_torch.tools.import_urdf`` writes the JSON
  that ``tools/import_urdf.py`` writes.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wiki_grx_gym_tpu.models import mjcf as jax_mjcf
from wiki_grx_gym_tpu.models import serialize as jax_serialize
from wiki_grx_gym_tpu.models import urdf as jax_urdf
from wiki_grx_gym_tpu_torch.models import mjcf, serialize, urdf
from wiki_grx_gym_tpu_torch.models.robot import ARRAY_FIELDS

ROOT = Path(__file__).resolve().parents[1]

PENDULUM = """
<robot name="pendulum">
  <link name="base">
    <inertial><origin xyz="0 0 0"/><mass value="100.0"/>
      <inertia ixx="1" ixy="0" ixz="0" iyy="1" iyz="0" izz="1"/></inertial>
  </link>
  <link name="bob">
    <inertial><origin xyz="0 0 -1.0"/><mass value="2.0"/>
      <inertia ixx="1e-6" ixy="0" ixz="0" iyy="1e-6" iyz="0" izz="1e-6"/></inertial>
    <collision><origin xyz="0 0 -1.0"/><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="base"/><child link="bob"/>
    <origin xyz="0 0 0" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-3" upper="3" effort="100" velocity="50"/>
  </joint>
</robot>
"""

LEG_URDF = """
<robot name="leg">
  <link name="base">
    <inertial><mass value="5.0"/><origin xyz="0 0 0.1"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.05" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><sphere radius="0.12"/></geometry></collision>
  </link>
  <link name="thigh">
    <inertial><mass value="2.0"/><origin xyz="0 0 -0.15"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.004" ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="shank">
    <inertial><mass value="1.0"/><origin xyz="0 0 -0.12"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.002" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 -0.3"/><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
  <link name="foot">
    <inertial><mass value="0.3"/><origin xyz="0.02 0 -0.02"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.05 0 -0.03"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <joint name="hip_pitch" type="revolute">
    <parent link="base"/><child link="thigh"/>
    <origin xyz="0 0.1 -0.05"/><axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.2" effort="100" velocity="20"/>
  </joint>
  <joint name="knee_pitch" type="revolute">
    <parent link="thigh"/><child link="shank"/>
    <origin xyz="0 0 -0.3"/><axis xyz="0 1 0"/>
    <limit lower="-0.1" upper="2.0" effort="120" velocity="18"/>
  </joint>
  <joint name="ankle_weld" type="fixed">
    <parent link="shank"/><child link="foot"/>
    <origin xyz="0 0 -0.35"/>
  </joint>
</robot>
"""

LEG_MJCF = """
<mujoco model="leg">
  <compiler angle="degree"/>
  <default>
    <joint type="hinge" limited="true"/>
  </default>
  <worldbody>
    <body name="base" pos="0 0 0">
      <freejoint/>
      <inertial pos="0 0 0.1" mass="5.0" diaginertia="0.1 0.1 0.05"/>
      <geom type="sphere" size="0.12"/>
      <body name="thigh" pos="0 0.1 -0.05">
        <joint name="hip_pitch" axis="0 1 0" range="-85.94366926962348 68.75493541569878"
               actuatorfrcrange="-100 100"/>
        <inertial pos="0 0 -0.15" mass="2.0" diaginertia="0.02 0.02 0.004"/>
        <body name="shank" pos="0 0 -0.3">
          <joint name="knee_pitch" axis="0 1 0" range="-5.729577951308232 114.59155902616465"
                 actuatorfrcrange="-120 120"/>
          <inertial pos="0 0 -0.12" mass="1.0" diaginertia="0.01 0.01 0.002"/>
          <geom type="sphere" size="0.04" pos="0 0 -0.3"/>
          <body name="foot" pos="0 0 -0.35">
            <inertial pos="0.02 0 -0.02" mass="0.3" diaginertia="0.001 0.001 0.001"/>
            <geom type="sphere" size="0.03" pos="0.05 0 -0.03"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

ANCHOR_MJCF = """
<mujoco model="anchor">
  <compiler angle="radian"/>
  <worldbody>
    <body name="base">
      <inertial pos="0 0 0" mass="3.0" diaginertia="0.1 0.1 0.1"/>
      <body name="arm" pos="0.2 0 0">
        <joint name="j" type="hinge" axis="0 0 1" pos="0.05 0 0" range="-1 1" limited="true"/>
        <inertial pos="0.15 0 0" mass="1.0" diaginertia="0.01 0.01 0.01"/>
        <geom type="sphere" size="0.02" pos="0.3 0 0"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

BOX_MJCF = """
<mujoco model="g"><compiler angle="degree"/><worldbody>
  <body name="base">
    <inertial pos="0 0 0" mass="2.0" diaginertia="0.1 0.1 0.1"/>
    <geom type="box" size="0.3 0.05 0.05" pos="0 0 0" {orient}/>
  </body>
</worldbody></mujoco>
"""

SLIDE_MJCF = """
<mujoco><worldbody><body name="b0">
  <inertial pos="0 0 0" mass="1" diaginertia="1 1 1"/>
  <body name="b1"><joint type="slide" axis="0 0 1"/>
    <inertial pos="0 0 0" mass="1" diaginertia="1 1 1"/></body>
</body></worldbody></mujoco>
"""

ROBOTS = {
    "pendulum": (PENDULUM, 0.0),
    "leg_urdf": (LEG_URDF, 0.01),
    "leg_mjcf": (LEG_MJCF, 0.01),
    "anchor_mjcf": (ANCHOR_MJCF, 0.0),
    "box_euler_mjcf": (BOX_MJCF.format(orient='euler="0 0 90"'), 0.0),
    "box_quat_mjcf": (BOX_MJCF.format(orient='quat="0.7071067811865476 0 0 0.7071067811865476"'), 0.0),
    "box_mjcf": (BOX_MJCF.format(orient=""), 0.0),
}
MJCF = [k for k in ROBOTS if k.endswith("_mjcf")]
STATIC = ("parent", "point_body", "point_link", "name", "body_names", "dof_names", "link_names",
          "link_frames", "gravity_scale")


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_same_model(got, want):
    for f in ARRAY_FIELDS:
        g = getattr(got, f)
        assert g.dtype.is_floating_point and g.device.type == "cpu", f
        assert same_bits(g.numpy(), getattr(want, f)), f
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", list(ROBOTS))
def test_compile_robot_is_bit_identical(name):
    xml, armature = ROBOTS[name]
    got, want = urdf.compile_robot(xml, armature=armature), jax_urdf.compile_robot(xml, armature=armature)
    assert_same_model(got, want)
    assert got.num_dof == want.num_dof and got.num_points == want.num_points > 0
    assert got.summary() == want.summary()


def as_plain(x):
    """A parsed intermediate as nested dicts/lists of numpy and scalars."""
    if dataclasses.is_dataclass(x):
        return {f.name: as_plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_plain(v) for v in x]
    return x


def assert_same_plain(got, want, where="root"):
    assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want)), where
    if isinstance(got, dict):
        assert list(got) == list(want), where
        for k in got:
            assert_same_plain(got[k], want[k], f"{where}.{k}")
    elif isinstance(got, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_plain(g, w, f"{where}[{i}]")
    elif isinstance(got, np.ndarray):
        assert same_bits(got, want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("name", MJCF)
def test_parse_mjcf_is_the_same_intermediate(name):
    xml, _ = ROBOTS[name]
    assert_same_plain(as_plain(mjcf.parse_mjcf(xml)), as_plain(jax_mjcf.parse_mjcf(xml)))


@pytest.mark.parametrize("name", ["pendulum", "leg_urdf"])
def test_parse_urdf_is_the_same_intermediate(name):
    xml, _ = ROBOTS[name]
    assert_same_plain(as_plain(urdf.parse_urdf(xml)), as_plain(jax_urdf.parse_urdf(xml)))


@pytest.mark.parametrize("name", list(ROBOTS))
def test_save_robot_writes_the_same_json(name, tmp_path):
    xml, armature = ROBOTS[name]
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    serialize.save_robot(urdf.compile_robot(xml, armature=armature), str(got))
    jax_serialize.save_robot(jax_urdf.compile_robot(xml, armature=armature), str(want))
    assert got.read_text() == want.read_text()
    back = serialize.load_robot(str(got))
    assert_same_model(back, jax_serialize.load_robot(str(want)))


def test_unsupported_joint_raises_in_both():
    with pytest.raises(NotImplementedError, match="slide") as port:
        urdf.compile_robot(SLIDE_MJCF)
    with pytest.raises(NotImplementedError, match="slide") as ref:
        jax_urdf.compile_robot(SLIDE_MJCF)
    assert str(port.value) == str(ref.value)
    prismatic = PENDULUM.replace('type="revolute"', 'type="prismatic"')
    with pytest.raises(NotImplementedError, match="prismatic"):
        urdf.compile_robot(prismatic)


def test_import_urdf_tool_writes_the_jax_tools_json(tmp_path):
    src = tmp_path / "leg.urdf"
    src.write_text(LEG_URDF)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    runs = {
        "port": [sys.executable, "-m", "wiki_grx_gym_tpu_torch.tools.import_urdf"],
        "jax": [sys.executable, str(ROOT / "tools" / "import_urdf.py")],
    }
    for tag, cmd in runs.items():
        res = subprocess.run(cmd + [str(src), str(tmp_path / f"{tag}.json"), "--armature", "0.02"],
                             capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=300)
        assert res.returncode == 0, res.stderr
        assert "'num_dof': 2" in res.stdout
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
