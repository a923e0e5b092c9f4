"""Parity of the port's FBX layer (momentum_tpu_torch/io/fbx.py,
fbx_writer.py, fbx_builder.py) with momentum_tpu's on the CPU.

For each case: (a) JAX writes and the port reads onto the CPU, every table
equal to what JAX's loader returns, the sampled motion bit for bit; (b) the
port writes and JAX reads, the same; (c) the port's bytes equal JAX's for
the same object. The writer writes one set of computed floats, the
clusters' bind matrices from each package's FK of the rest pose: where the
bytes differ, the two documents are decoded and held node by node, those
matrices within FK_TOL (1e-6, the io tests' tolerance for FK-computed
tables) and every other value exactly. Both binary layouts (7400, u32
record offsets; 7500, u64), a zlib array past the writer's 1024-byte
threshold, and the ASCII 7.4 and 6.1 documents of tests/test_fbx_ascii.py
(rebuilt here) are covered, on the small io rig and on the full-body rig.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from momentum_tpu import io as jio
from momentum_tpu.character.character import Character as JCharacter
from momentum_tpu.io import fbx as jfbx
from momentum_tpu.testing.fixtures import create_test_character
import momentum_tpu_torch.io as tio
from momentum_tpu_torch.character import Character as TCharacter
from momentum_tpu_torch.io import fbx as tfbx
from momentum_tpu_torch.testing import workloads as w
from test_torch_port_helpers import (
    assert_io_tables_equal, io_jax_rig, jax_fullbody_character, port_of)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import jax_reference  # noqa: E402

FK_TOL = 1e-6
FK_ARRAYS = ("Transform", "TransformLink")  # the clusters' bind matrices, from FK


@pytest.fixture(scope="module")
def rigs():
    j = io_jax_rig()
    return j, port_of(j)


@pytest.fixture(scope="module")
def fullbody():
    j = jax_fullbody_character()
    return j, port_of(j)


def _motion(char, frames=5, seed=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.3, 0.3, (frames, char.num_model_parameters)).astype(np.float32)


def _flatten(node, path=""):
    """(path, name, props) of every node of a parsed FBX tree, depth first."""
    here = f"{path}/{node.name}"
    out = [(here, node.name, node.props)]
    for c in node.children:
        out.extend(_flatten(c, here))
    return out


def assert_fbx_documents_match(a: bytes, b: bytes):
    """Byte equality, or the decoded trees equal node by node with the FK
    bind matrices within FK_TOL."""
    if a == b:
        return
    ta, tb = _flatten(tfbx._parse(a)[0]), _flatten(tfbx._parse(b)[0])
    assert [(p, n) for p, n, _ in ta] == [(p, n) for p, n, _ in tb]
    for (path, name, pa), (_, _, pb) in zip(ta, tb):
        assert len(pa) == len(pb), path
        for x, y in zip(pa, pb):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, path
                if name in FK_ARRAYS:
                    np.testing.assert_allclose(x, y, rtol=0, atol=FK_TOL, err_msg=path)
                else:
                    np.testing.assert_array_equal(x, y, err_msg=path)
            else:
                assert x == y, path


def _jax_tables(char, prefix):
    return jax_reference.io_tables(char, prefix)


# ---- the writers: the port's bytes ----

WRITES = ("model", "motion_7400", "motion_7500", "joint_params", "no_mesh")


def _write(pkg, case, jchar, tchar, path):
    """Write the rig's FBX for `case` with `pkg` ("jax" or "port")."""
    char, io = (jchar, jio) if pkg == "jax" else (tchar, tio)
    motion = _motion(jchar)
    wrap = (lambda a: a) if pkg == "jax" else torch.as_tensor
    if case == "model":
        io.save_fbx_model(str(path), char)
    elif case.startswith("motion"):
        io.save_fbx(str(path), char, motion=wrap(motion), fps=30.0, version=int(case[-4:]))
    elif case == "joint_params":
        jp = np.array(jchar.parameter_transform.apply(jnp.asarray(motion)))
        jp[:, 6::7] = 0.1  # every joint scaled, so every Lcl Scaling curve is written
        io.save_fbx_with_joint_params(str(path), char, wrap(jp), fps=24.0)
    elif case == "no_mesh":
        bare = dataclasses.replace(char, mesh=None, skin_weights=None, inverse_bind_pose=None)
        io.save_fbx(str(path), bare, motion=wrap(motion))


@pytest.mark.parametrize("case", WRITES)
def test_port_bytes_are_jax_bytes(rigs, case, tmp_path):
    """(c) save_fbx, save_fbx_model and save_fbx_with_joint_params give
    JAX's document."""
    j, t = rigs
    _write("port", case, j, t, tmp_path / "t.fbx")
    _write("jax", case, j, t, tmp_path / "j.fbx")
    assert_fbx_documents_match((tmp_path / "t.fbx").read_bytes(),
                               (tmp_path / "j.fbx").read_bytes())


@pytest.mark.parametrize("case", WRITES)
def test_jax_writes_port_reads(rigs, case, tmp_path):
    """(a) load_fbx and load_fbx_with_motion on JAX's file: JAX's tables and
    JAX's sampled motion bit for bit, on the CPU."""
    j, t = rigs
    path = tmp_path / "j.fbx"
    _write("jax", case, j, t, path)
    got, motion, fps = tio.load_fbx_with_motion(str(path), fps=30.0, device="cpu")
    want, want_motion, want_fps = jio.load_fbx_with_motion(str(path), fps=30.0)
    assert_io_tables_equal(w.character_tables(got, "c"), _jax_tables(want, "c"), FK_TOL)
    np.testing.assert_array_equal(motion.numpy(), np.asarray(want_motion))
    assert fps == want_fps and motion.device.type == "cpu" and motion.dtype == torch.float32
    assert_io_tables_equal(w.character_tables(tio.load_fbx(path.read_bytes(), device="cpu"),
                                              "c"), _jax_tables(want, "c"), FK_TOL)


@pytest.mark.parametrize("case", WRITES)
def test_port_writes_jax_reads(rigs, case, tmp_path):
    """(b) JAX's loaders on the port's file give what they give on JAX's."""
    j, t = rigs
    _write("port", case, j, t, tmp_path / "t.fbx")
    _write("jax", case, j, t, tmp_path / "j.fbx")
    got, got_motion, _ = jio.load_fbx_with_motion(str(tmp_path / "t.fbx"), fps=30.0)
    want, want_motion, _ = jio.load_fbx_with_motion(str(tmp_path / "j.fbx"), fps=30.0)
    assert_io_tables_equal(_jax_tables(got, "c"), _jax_tables(want, "c"), FK_TOL)
    np.testing.assert_array_equal(np.asarray(got_motion), np.asarray(want_motion))


def test_zlib_array_past_the_threshold(tmp_path):
    """The 12-joint test rig's vertex array (> 1024 bytes) takes the zlib
    branch (tests/test_fbx_writer.py:148): JAX's bytes, at least one array
    with encoding 1 in the file, and the port's reader inflates it to the
    written vertices."""
    j = create_test_character(12)
    t = port_of(j)
    assert j.mesh.vertices.size * 8 > 1024
    tio.save_fbx_model(str(tmp_path / "t.fbx"), t)
    jio.save_fbx_model(str(tmp_path / "j.fbx"), j)
    data = (tmp_path / "t.fbx").read_bytes()
    assert_fbx_documents_match(data, (tmp_path / "j.fbx").read_bytes())
    geometry = tfbx._parse(data)[0].first("Objects").first("Geometry")
    raw = data[data.index(b"Vertices") + len(b"Vertices"):]
    assert raw[:1] == b"d" and int.from_bytes(raw[5:9], "little") == 1  # encoding 1: zlib
    np.testing.assert_array_equal(geometry.first("Vertices").props[0].reshape(-1, 3)
                                  .astype(np.float32), np.asarray(j.mesh.vertices))
    got = tio.load_fbx(str(tmp_path / "j.fbx"), device="cpu")
    np.testing.assert_array_equal(got.mesh.vertices.numpy(), np.asarray(j.mesh.vertices))


# ---- ASCII containers (tests/test_fbx_ascii.py's documents) ----

ASCII_74 = """\
; FBX 7.4.0 project file
FBXHeaderExtension:  {
\tFBXHeaderVersion: 1003
\tFBXVersion: 7400
}
Objects:  {
\tModel: 1001, "Model::root", "Root" {
\t\tProperties70:  {
\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",0,0,0
\t\t}
\t}
\tModel: 1002, "Model::child", "LimbNode" {
\t\tProperties70:  {
\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",0,2,0
\t\t\tP: "PreRotation", "Vector3D", "Vector", "",0,0,90
\t\t}
\t}
\tGeometry: 2001, "Geometry::mesh", "Mesh" {
\t\tVertices: *12 {
\t\t\ta: 0,0,0, 1,0,0, 1,1,0, 0,1,0
\t\t}
\t\tPolygonVertexIndex: *4 {
\t\t\ta: 0,1,2,-4
\t\t}
\t}
\tModel: 3001, "Model::meshnode", "Mesh" {
\t}
\tDeformer: 4001, "Deformer::skin", "Skin" {
\t}
\tDeformer: 4002, "SubDeformer::cl", "Cluster" {
\t\tIndexes: *4 {
\t\t\ta: 0,1,2,3
\t\t}
\t\tWeights: *4 {
\t\t\ta: 1,1,1,1
\t\t}
\t}
}
Connections:  {
\tC: "OO",1002,1001
\tC: "OO",2001,3001
\tC: "OO",4001,2001
\tC: "OO",4002,4001
\tC: "OO",1002,4002
}
"""

ASCII_6100 = """\
; FBX 6.1.0 project file
FBXHeaderExtension:  {
\tFBXHeaderVersion: 1003
\tFBXVersion: 6100
}
Objects:  {
\tModel: "Model::root", "Root" {
\t\tProperties60:  {
\t\t\tProperty: "Lcl Translation", "Lcl Translation", "A+",0,0,0
\t\t}
\t}
\tModel: "Model::child", "LimbNode" {
\t\tProperties60:  {
\t\t\tProperty: "Lcl Translation", "Lcl Translation", "A+",1,2,3
\t\t}
\t}
}
Connections:  {
\tConnect: "OO", "Model::child", "Model::root"
\tConnect: "OO", "Model::root", "Model::Scene"
}
"""


@pytest.mark.parametrize("text", [ASCII_74, ASCII_6100], ids=["7400", "6100"])
def test_ascii_documents(text, tmp_path):
    """The 7.4 text (uids, `*N { a: }` arrays, C records, a skinned quad)
    and the 6.1 text (no uids, Connect records, Properties60): JAX's
    tables, from a path and from bytes."""
    path = tmp_path / "rig.fbx"
    path.write_text(text)
    want = _jax_tables(jio.load_fbx(str(path)), "c")
    assert_io_tables_equal(w.character_tables(tio.load_fbx(str(path), device="cpu"), "c"),
                           want, FK_TOL)
    assert_io_tables_equal(w.character_tables(tio.load_fbx(text.encode(), device="cpu"), "c"),
                           want, FK_TOL)


def test_ascii_normalization_and_bad_input(tmp_path):
    """_normalize_ascii gives JAX's node tree; neither binary nor text
    raises JAX's ValueError."""
    for text in (ASCII_74, ASCII_6100):
        got, got_v = tfbx._parse(text.encode())
        want, want_v = jfbx._parse(text.encode())
        assert got_v == want_v
        assert [(p, n, repr(v)) for p, n, v in _flatten(got)] == \
            [(p, n, repr(v)) for p, n, v in _flatten(want)]
    bad = tmp_path / "nope.fbx"
    bad.write_text("this is not an fbx file at all\n")
    with pytest.raises(ValueError, match="not an FBX file"):
        tio.load_fbx(str(bad), device="cpu")


def test_namespaces_are_stripped_on_load(rigs, tmp_path):
    """"ns:" prefixes dropped by default, kept with strip_namespaces=False."""
    j, t = rigs
    names = tuple(f"rig:skel:{n}" for n in t.skeleton.joint_names)
    bare = dataclasses.replace(t, skeleton=dataclasses.replace(t.skeleton, joint_names=names),
                               mesh=None, skin_weights=None, inverse_bind_pose=None)
    tio.save_fbx_model(str(tmp_path / "ns.fbx"), bare)
    assert tio.load_fbx(str(tmp_path / "ns.fbx"), device="cpu").skeleton.joint_names == \
        t.skeleton.joint_names
    kept = tio.load_fbx(str(tmp_path / "ns.fbx"), strip_namespaces=False, device="cpu")
    assert kept.skeleton.joint_names == names
    assert kept.skeleton.joint_names == jio.load_fbx(
        str(tmp_path / "ns.fbx"), strip_namespaces=False).skeleton.joint_names


# ---- FbxBuilder and the Character's FBX members ----

def _builder(pkg, jchar, tchar, clip):
    """A scene of every entry kind: the rig with motion, a rigid body, an
    animated mesh, the clip's markers."""
    if pkg == "jax":
        from momentum_tpu.io.fbx_builder import FbxBuilder
        from momentum_tpu.tracking import MarkerSequence
        char, kw, wrap = jchar, {}, jnp.asarray
    else:
        from momentum_tpu_torch.io.fbx_builder import FbxBuilder
        from momentum_tpu_torch.tracking import MarkerSequence
        char, kw, wrap = tchar, {"device": "cpu"}, torch.as_tensor
    pos, occ = clip
    jp = np.zeros((3, 7), np.float32)
    jp[:, 0] = [0.0, 0.5, 1.0]
    return (FbxBuilder().add_character(char, name="rig")
            .add_motion(wrap(_motion(jchar, 4)), fps=30.0, character_name="rig")
            .add_rigid_body(char, name="prop", parent_joint=2)
            .add_animated_mesh(char.mesh, name="moving", fps=30.0, joint_params=jp,
                               translation_offset=(0.0, 1.0, 0.0), **kw)
            .add_marker_sequence(MarkerSequence(positions=wrap(pos), occluded=wrap(occ),
                                                names=("a", "b", "c")), fps=30.0, **kw))


def test_fbx_builder_bytes(rigs, tmp_path):
    """FbxBuilder.to_bytes and save: JAX's document for every entry kind;
    one character with motion gives save_fbx's bytes."""
    j, t = rigs
    rng = np.random.default_rng(8)
    clip = (rng.uniform(-1, 1, (4, 3, 3)).astype(np.float32), rng.random((4, 3)) < 0.3)
    got = _builder("port", j, t, clip).to_bytes()
    assert_fbx_documents_match(got, _builder("jax", j, t, clip).to_bytes())
    _builder("port", j, t, clip).save(tmp_path / "s.fbx")
    assert (tmp_path / "s.fbx").read_bytes() == got
    motion = torch.as_tensor(_motion(j, 4))
    tio.save_fbx(str(tmp_path / "one.fbx"), t, motion=motion, fps=30.0)
    one = tio.FbxBuilder().add_character(t).add_motion(motion, fps=30.0).to_bytes()
    assert one == (tmp_path / "one.fbx").read_bytes()
    with pytest.raises(ValueError, match="nothing to save"):
        tio.FbxBuilder().to_bytes()


def test_character_fbx_members(rigs, tmp_path):
    """Character.load_fbx, load_fbx_from_bytes, load_fbx_with_motion(_from_bytes),
    save_fbx and save_fbx_with_joint_params against JAX's members."""
    j, t = rigs
    motion = _motion(j)
    t.save_fbx(str(tmp_path / "t.fbx"), motion=torch.as_tensor(motion), fps=30.0)
    j.save_fbx(str(tmp_path / "j.fbx"), motion=motion, fps=30.0)
    assert_fbx_documents_match((tmp_path / "t.fbx").read_bytes(),
                               (tmp_path / "j.fbx").read_bytes())
    jp = np.array(j.parameter_transform.apply(jnp.asarray(motion)))
    t.save_fbx_with_joint_params(str(tmp_path / "tp.fbx"), torch.as_tensor(jp), fps=30.0)
    j.save_fbx_with_joint_params(str(tmp_path / "jp.fbx"), jp, fps=30.0)
    assert_fbx_documents_match((tmp_path / "tp.fbx").read_bytes(),
                               (tmp_path / "jp.fbx").read_bytes())
    data = (tmp_path / "j.fbx").read_bytes()
    want = _jax_tables(JCharacter.load_fbx(str(tmp_path / "j.fbx")), "c")
    for got in (TCharacter.load_fbx(str(tmp_path / "j.fbx"), device="cpu"),
                TCharacter.load_fbx_from_bytes(data, device="cpu"),
                TCharacter.load_fbx_with_motion(str(tmp_path / "j.fbx"), 30.0, device="cpu")[0],
                TCharacter.load_fbx_with_motion_from_bytes(data, 30.0, device="cpu")[0]):
        assert_io_tables_equal(w.character_tables(got, "c"), want, FK_TOL)
    _, got_motion, _ = TCharacter.load_fbx_with_motion_from_bytes(data, 30.0, device="cpu")
    np.testing.assert_array_equal(got_motion.numpy(), np.asarray(
        JCharacter.load_fbx_with_motion_from_bytes(data, 30.0)[1]))


def test_save_with_skel_states_fbx(rigs, tmp_path):
    """Character.save_with_skel_states to .fbx (inverse FK to joint curves):
    the joint parameters loaded back reproduce JAX's within 1e-5 and FK of
    them the written states within 1e-5 (each package's inverse FK, atan2
    and asin in float32)."""
    j, t = rigs
    motion = _motion(j, 4)
    states = t.skeleton_states(torch.as_tensor(motion))
    t.save_with_skel_states(str(tmp_path / "t.fbx"), states, fps=30.0)
    j.save_with_skel_states(str(tmp_path / "j.fbx"), jnp.asarray(states.numpy()), fps=30.0)
    _, got, _ = tio.load_fbx_with_motion(str(tmp_path / "t.fbx"), fps=30.0, device="cpu")
    _, want, _ = jio.load_fbx_with_motion(str(tmp_path / "j.fbx"), fps=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    from momentum_tpu_torch.character import fk

    np.testing.assert_allclose(fk.global_skel_states(t.skeleton, got).numpy(), states.numpy(),
                               rtol=0, atol=1e-5)


def test_fullbody_rig_both_ways(fullbody, tmp_path):
    """The full-body rig (51 joints, pre-rotations, no mesh) with 8 frames:
    JAX's bytes; each package reads the other's file as its own."""
    j, t = fullbody
    motion = _motion(j, 8)
    tio.save_fbx(str(tmp_path / "t.fbx"), t, motion=torch.as_tensor(motion), fps=30.0)
    jio.save_fbx(str(tmp_path / "j.fbx"), j, motion=motion, fps=30.0)
    assert_fbx_documents_match((tmp_path / "t.fbx").read_bytes(),
                               (tmp_path / "j.fbx").read_bytes())
    got, got_motion, _ = tio.load_fbx_with_motion(str(tmp_path / "j.fbx"), 30.0, device="cpu")
    want, want_motion, _ = jio.load_fbx_with_motion(str(tmp_path / "j.fbx"), 30.0)
    assert_io_tables_equal(w.character_tables(got, "c"), _jax_tables(want, "c"), FK_TOL)
    np.testing.assert_array_equal(got_motion.numpy(), np.asarray(want_motion))
