"""Parity of the port's URDF and BVH readers and writer
(momentum_tpu_torch/io/urdf.py, bvh.py) and of character_io's dispatch of
the part-2 formats with momentum_tpu's on the CPU.

URDF: the arm of tests/test_io.py:239 and a robot with every joint kind
(revolute, continuous, prismatic, fixed), an off-axis axis folded into the
pre-rotation and inertial bodies: every table equal to JAX's load, from a
path and from the XML text. BVH: JAX's file read by the port (tables
equal, the motion within ROT_TOL: the rotations are re-extracted in float32
on the host by each package's rotation_matrix_to_euler_zyx, whose atan2 and
asin round apart by up to an ulp, 3e-8 rad on the full-body rig), the
port's file equal to JAX's byte for byte, a hand-written
file with XYZ and YXZ channel orders, and the full-body rig. Every loader
builds on the CPU when asked and defaults to the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from momentum_tpu import io as jio
import momentum_tpu_torch.io as tio
from momentum_tpu_torch.character import Character as TCharacter
from momentum_tpu_torch.testing import workloads as w
from test_torch_port_helpers import (
    assert_io_tables_equal, io_jax_rig, jax_fullbody_character, port_of)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

import test_torch_port_io_fbx as fbx_tests

FK_TOL = 1e-6
ROT_TOL = 1e-6  # float32 Euler re-extraction, each package's atan2 and asin

ARM = """<robot name="arm">
  <link name="base"/>
  <link name="upper"/>
  <link name="lower"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0.5 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-1.57" upper="1.57"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="lower"/>
    <origin xyz="0 1 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="0.1"/>
  </joint>
</robot>"""

ROBOT = """<robot name="rover">
  <link name="chassis">
    <inertial><mass value="12.5"/><origin xyz="0 0.1 0" rpy="0.1 0 0.2"/>
      <inertia ixx="1.0" ixy="0.01" ixz="0" iyy="2.0" iyz="0.02" izz="3.0"/></inertial>
  </link>
  <link name="mast"/>
  <link name="wheel">
    <inertial><mass value="0.75"/><inertia ixx="0.1" iyy="0.1" izz="0.2"/></inertial>
  </link>
  <link name="slider"/>
  <link name="camera"/>
  <link name="massless"><inertial><mass value="0"/></inertial></link>
  <joint name="mast_yaw" type="revolute">
    <parent link="chassis"/><child link="mast"/>
    <origin xyz="0.1 0.4 -0.2" rpy="0.3 -0.2 0.5"/>
    <axis xyz="0.3 0.5 0.8"/>
    <limit lower="-0.7" upper="0.9"/>
  </joint>
  <joint name="wheel_spin" type="continuous">
    <parent link="chassis"/><child link="wheel"/>
    <origin xyz="0.5 0 0.3"/>
    <axis xyz="-1 0 0"/>
  </joint>
  <joint name="lift" type="prismatic">
    <parent link="mast"/><child link="slider"/>
    <axis xyz="0 1 0"/>
    <limit lower="0" upper="0.25"/>
  </joint>
  <joint name="camera_mount" type="fixed">
    <parent link="slider"/><child link="camera"/>
    <origin xyz="0 0.05 0" rpy="0 1.5707963 0"/>
  </joint>
  <joint name="weightless" type="fixed">
    <parent link="chassis"/><child link="massless"/>
  </joint>
</robot>"""


@pytest.fixture(scope="module")
def rigs():
    j = io_jax_rig()
    return j, port_of(j)


@pytest.mark.parametrize("xml", [ARM, ROBOT], ids=["arm", "robot"])
def test_urdf_tables_are_jax_tables(xml, tmp_path):
    """load_urdf of the XML text and of a file: JAX's skeleton, parameter
    transform, limits, bodies and name; FK of a pose JAX's states."""
    path = tmp_path / "robot.urdf"
    path.write_text(xml)
    want_char = jio.load_urdf(xml)
    want = fbx_tests._jax_tables(want_char, "c")
    for source in (xml, str(path)):
        got = tio.load_urdf(source, device="cpu")
        assert_io_tables_equal(w.character_tables(got, "c"), want, FK_TOL)
        assert got.name == want_char.name
    assert got.limits.minmax_index.device.type == "cpu"
    theta = np.linspace(-0.4, 0.6, got.num_model_parameters).astype(np.float32)
    np.testing.assert_allclose(got.skeleton_states(torch.as_tensor(theta)).numpy(),
                               np.asarray(want_char.skeleton_states(jnp.asarray(theta))),
                               rtol=0, atol=1e-6)
    assert TCharacter.load_urdf(str(path), device="cpu").skeleton.joint_names == \
        want_char.skeleton.joint_names


def test_urdf_arm_moves_as_the_reference_test_says():
    """tests/test_io.py's arm: a quarter turn of the shoulder about URDF z
    takes the lower link to (-1, 0.5, 0)."""
    char = tio.load_urdf(ARM, device="cpu")
    states = char.skeleton_states(torch.as_tensor([np.pi / 2, 0.0], dtype=torch.float32))
    np.testing.assert_allclose(states[2, :3].numpy(), [-1.0, 0.5, 0.0], atol=1e-5)
    with pytest.raises(ValueError, match="no root link"):
        tio.load_urdf('<robot><link name="a"/><joint name="j" type="fixed"><parent link="a"/>'
                      '<child link="a"/></joint></robot>', device="cpu")


def _joint_params(jchar, frames=4, seed=11):
    rng = np.random.default_rng(seed)
    motion = rng.uniform(-0.4, 0.4, (frames, jchar.num_model_parameters)).astype(np.float32)
    return np.array(jchar.parameter_transform.apply(jnp.asarray(motion)))


def test_bvh_both_ways(rigs, tmp_path):
    """save_bvh gives JAX's bytes; load_bvh of JAX's file gives JAX's
    character and motion; JAX's load of the port's file its own."""
    j, t = rigs
    jp = _joint_params(j)
    tio.save_bvh(str(tmp_path / "t.bvh"), t, torch.as_tensor(jp), fps=30.0)
    jio.save_bvh(str(tmp_path / "j.bvh"), j, jp, fps=30.0)
    assert (tmp_path / "t.bvh").read_bytes() == (tmp_path / "j.bvh").read_bytes()
    got, motion, fps = tio.load_bvh(str(tmp_path / "j.bvh"), device="cpu")
    want, want_motion, want_fps = jio.load_bvh(str(tmp_path / "j.bvh"))
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
    np.testing.assert_allclose(motion.numpy(), np.asarray(want_motion), rtol=0, atol=ROT_TOL)
    assert fps == want_fps and motion.dtype == torch.float32 and motion.device.type == "cpu"


BVH_ORDERS = """HIERARCHY
ROOT hips
{
  OFFSET 0.0 1.0 0.0
  CHANNELS 6 Xposition Yposition Zposition Xrotation Yrotation Zrotation
  JOINT spine
  {
    OFFSET 0.0 0.5 0.1
    CHANNELS 3 Yrotation Xrotation Zrotation
    End Site
    {
      OFFSET 0.0 0.3 0.0
    }
  }
}
MOTION
Frames: 3
Frame Time: 0.04
0.1 1.0 -0.2 10 20 30 -15 25 40
0.2 1.1 -0.1 -80 45 170 5 -89 12
0.3 1.2 0.0 0 0 0 90 0 -90
"""


def test_bvh_channel_orders(tmp_path):
    """A hand-written file with XYZ and YXZ rotation channels (converted
    through the rotation matrix to momentum's ZYX, a pole at 90°): JAX's
    tables and motion, the end site as a joint."""
    path = tmp_path / "orders.bvh"
    path.write_text(BVH_ORDERS)
    got, motion, fps = tio.load_bvh(str(path), device="cpu")
    want, want_motion, want_fps = jio.load_bvh(str(path))
    assert got.skeleton.joint_names == ("hips", "spine", "spine_end")
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
    np.testing.assert_allclose(motion.numpy(), np.asarray(want_motion), rtol=0, atol=ROT_TOL)
    assert fps == want_fps == 25.0


def test_bvh_fullbody(tmp_path):
    """The full-body rig's 8 frames: JAX's bytes; the port's load of the
    file JAX's tables and motion (within ROT_TOL)."""
    j = jax_fullbody_character()
    t = port_of(j)
    jp = _joint_params(j, 8)
    tio.save_bvh(str(tmp_path / "t.bvh"), t, torch.as_tensor(jp), fps=120.0)
    jio.save_bvh(str(tmp_path / "j.bvh"), j, jp, fps=120.0)
    assert (tmp_path / "t.bvh").read_bytes() == (tmp_path / "j.bvh").read_bytes()
    got, motion, _ = tio.load_bvh(str(tmp_path / "t.bvh"), device="cpu")
    want, want_motion, _ = jio.load_bvh(str(tmp_path / "t.bvh"))
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
    np.testing.assert_allclose(motion.numpy(), np.asarray(want_motion), rtol=0, atol=ROT_TOL)


# ---- character_io's dispatch of the part-2 formats ----

@pytest.mark.parametrize("ext", [".fbx", ".usd", ".usda", ".usdc", ".bvh"])
def test_save_character_and_load_full_character(rigs, ext, tmp_path):
    """save_character by extension writes JAX's file (decoded, the computed
    matrices within FK_TOL); load_full_character of JAX's file gives JAX's
    character."""
    j, t = rigs
    motion = np.random.default_rng(2).uniform(-0.3, 0.3, (3, j.num_model_parameters))
    motion = motion.astype(np.float32)
    tio.save_character(str(tmp_path / f"t{ext}"), t, motion=torch.as_tensor(motion), fps=30.0)
    jio.save_character(str(tmp_path / f"j{ext}"), j, motion=motion, fps=30.0)
    mine, theirs = (tmp_path / f"t{ext}").read_bytes(), (tmp_path / f"j{ext}").read_bytes()
    if ext == ".fbx":
        fbx_tests.assert_fbx_documents_match(mine, theirs)
    elif ext == ".bvh":
        assert mine == theirs
    else:
        import test_torch_port_io_usd as usd_tests
        from momentum_tpu.io import usd as jusd

        read = (jusd.read_usdc if mine[:8] == b"PXR-USDC"
                else lambda p: jusd.parse_usda(open(p).read()))
        usd_tests.assert_stages_match(read(str(tmp_path / f"t{ext}")),
                                      read(str(tmp_path / f"j{ext}")))
    got = tio.load_full_character(str(tmp_path / f"j{ext}"), device="cpu")
    want = jio.load_full_character(str(tmp_path / f"j{ext}"))
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
    tio.save_character(str(tmp_path / f"rest{ext}"), t)
    jio.save_character(str(tmp_path / f"jrest{ext}"), j)
    assert tio.character_format(f"x{ext}") == jio.character_format(f"x{ext}")


def test_load_full_character_urdf_with_side_cars(tmp_path):
    """A URDF with a .model side-car, through load_full_character, as
    JAX's."""
    (tmp_path / "arm.urdf").write_text(ARM)
    jchar = jio.load_urdf(ARM)
    with open(tmp_path / "arm.model", "w") as f:
        f.write(jio.write_model_definition(jchar.parameter_transform, jchar.skeleton,
                                           jchar.limits))
    args = [str(tmp_path / "arm.urdf"), str(tmp_path / "arm.model")]
    got = tio.load_full_character(*args, device="cpu")
    want = jio.load_full_character(*args)
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
