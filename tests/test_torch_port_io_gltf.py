"""Parity of the port's glTF layer (momentum_tpu_torch/io/gltf.py,
gltf_builder.py) and the Character's and compat's file members with
momentum_tpu on the CPU: the full-body rig with bodies, a motion, markers,
an identity and timestamps, and a small rig with every table the format
carries (collision capsules, all seven limit record types, parameter sets,
pose presets), each (a) written by JAX and read by the port, (b) written by
the port and read by JAX, (c) written by both to equal bytes; the
skeleton-state load on both of its branches (FB_momentum motion through the
rig, and standard animation channels by GltfBuilder.add_skeleton_states),
multi-character files, the joints' re-sort on a file whose nodes are not in
parent-first order, the animation fallback of load_character_glb, and IK at
B = 64 on a loaded rig against the in-memory rig.

Tolerances: tables read from a file equal bit for bit (both parse the same
JSON text and binary chunk into float32); the inverse bind poses each
package computes by FK within 1e-6; skeleton states by FK within 2e-5 (the
JAX gltf_builder test's 5e-5, and the port's FK_TOL); the animation
fallback's motion, through each package's rig pseudo-inverse and
quaternion-to-Euler, within 1e-5.
"""

import dataclasses
import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from momentum_tpu import compat as jcompat
from momentum_tpu import io as jio
from momentum_tpu.character.character import Character as JCharacter
from momentum_tpu.io.gltf import (
    load_character_glb_with_skel_states as jload_states, load_motion_timestamps as jtimestamps)
from momentum_tpu.tracking import MarkerSequence as JMarkerSequence
import momentum_tpu_torch.io as tio
from momentum_tpu_torch import compat as tcompat
from momentum_tpu_torch.character import Character as TCharacter
from momentum_tpu_torch.io.gltf import (
    load_character_glb_with_skel_states as tload_states, load_motion_timestamps as ttimestamps)
from momentum_tpu_torch.testing import workloads as w
from test_torch_port_helpers import assert_io_tables_equal, io_jax_rig, port_of
from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import jax_reference  # noqa: E402

COMPUTED_TOL = 1e-6
FK_TOL = 2e-5


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


@pytest.fixture(scope="module")
def small():
    j = io_jax_rig()
    return j, port_of(j)


@pytest.fixture(scope="module")
def fullbody():
    j = jax_reference.io_character()
    return j, port_of(j)


def _extras(jchar, frames=4, seed=11):
    """(motion, markers (JAX, port), identity, timestamps) for a rig."""
    rng = np.random.default_rng(seed)
    motion = rng.uniform(-0.3, 0.3, (frames, jchar.num_model_parameters)).astype(np.float32)
    n = jchar.locators.num_locators
    pos = rng.normal(0, 1, (frames, n, 3)).astype(np.float32)
    occ = rng.random((frames, n)) < 0.2
    jm = JMarkerSequence(positions=jnp.asarray(pos), occluded=jnp.asarray(occ),
                         names=tuple(jchar.locators.names))
    from momentum_tpu_torch.tracking import MarkerSequence

    tm = MarkerSequence(positions=torch.as_tensor(pos), occluded=torch.as_tensor(occ),
                        names=tuple(jchar.locators.names))
    identity = rng.normal(0, 0.01, jchar.skeleton.num_joints * 7).astype(np.float32)
    return motion, (jm, tm), identity, 1000 + 10 * np.arange(frames, dtype=np.int64)


def _glb_pair(j, t, tmp_path, with_extras=True):
    """(JAX's .glb, the port's .glb) of the same rig with the same extras."""
    kw_j, kw_t = {}, {}
    if with_extras:
        motion, (jm, tm), identity, ts = _extras(j)
        kw_j = dict(motion=motion, fps=60.0, markers=jm, identity=identity, timestamps=ts)
        kw_t = dict(motion=torch.as_tensor(motion), fps=60.0, markers=tm,
                    identity=torch.as_tensor(identity), timestamps=ts)
    jio.save_character_glb(str(tmp_path / "j.glb"), j, **kw_j)
    tio.save_character_glb(str(tmp_path / "t.glb"), t, **kw_t)
    return tmp_path / "j.glb", tmp_path / "t.glb"


def _jax_load(source):
    char, motion, fps, markers = jio.load_character_glb(source, return_markers=True)
    out = jax_reference.io_tables(char, "c")
    out.update({"m.fps": np.asarray(fps)})
    if motion is not None:
        out["m.motion"] = np.asarray(motion)
    if markers is not None:
        out.update({"m.positions": np.asarray(markers.positions),
                    "m.occluded": np.asarray(markers.occluded),
                    "m.names": np.asarray(list(markers.names))})
    out["m.timestamps"] = jtimestamps(source)
    for k, v in zip(("lm.motion", "lm.names", "lm.identity", "lm.joints"),
                    jio.load_motion(source)):
        if v is not None:
            out[k] = np.asarray(v)
    return out


def _port_load(source):
    char, motion, fps, markers = tio.load_character_glb(source, return_markers=True,
                                                        device="cpu")
    out = w.character_tables(char, "c")
    out.update({"m.fps": np.asarray(fps)})
    if motion is not None:
        assert motion.device.type == "cpu"
        out["m.motion"] = _np(motion)
    if markers is not None:
        out.update({"m.positions": _np(markers.positions), "m.occluded": _np(markers.occluded),
                    "m.names": np.asarray(list(markers.names))})
    out["m.timestamps"] = ttimestamps(source)
    for k, v in zip(("lm.motion", "lm.names", "lm.identity", "lm.joints"),
                    tcompat.load_motion(source)):
        if v is not None:
            out[k] = np.asarray(v)
    return out


RIGS = ("small", "fullbody")


@pytest.mark.parametrize("rig", RIGS)
def test_glb_jax_writes_port_reads(rig, request, tmp_path):
    """(a) the port's load of JAX's .glb (rig, motion, markers, identity,
    timestamps) is JAX's load, from the path and from the bytes."""
    j, t = request.getfixturevalue(rig)
    jpath, _ = _glb_pair(j, t, tmp_path)
    want = _jax_load(str(jpath))
    assert_io_tables_equal(_port_load(str(jpath)), want, COMPUTED_TOL)
    assert_io_tables_equal(_port_load(jpath.read_bytes()), want, COMPUTED_TOL)


@pytest.mark.parametrize("rig", RIGS)
def test_glb_port_writes_jax_reads(rig, request, tmp_path):
    """(b) JAX's load of the port's .glb is its load of its own."""
    j, t = request.getfixturevalue(rig)
    jpath, tpath = _glb_pair(j, t, tmp_path)
    assert_io_tables_equal(_jax_load(str(tpath)), _jax_load(str(jpath)), COMPUTED_TOL)


@pytest.mark.parametrize("rig", RIGS)
@pytest.mark.parametrize("with_extras", [False, True], ids=["rig", "rig_motion_markers"])
def test_glb_bytes_are_jax_bytes(rig, with_extras, request, tmp_path):
    """(c) the port's .glb is JAX's byte for byte (the inverse bind
    matrices are the bridged rig's, turned into 4×4 by the same products),
    and to_gltf is JAX's document."""
    j, t = request.getfixturevalue(rig)
    jpath, tpath = _glb_pair(j, t, tmp_path, with_extras)
    assert tpath.read_bytes() == jpath.read_bytes()
    if not with_extras:
        assert t.to_gltf(fps=30.0) == j.to_gltf(fps=30.0)


def _states(j, frames=5, seed=12):
    motion = np.random.default_rng(seed).uniform(-0.4, 0.4, (frames, j.num_model_parameters))
    return motion.astype(np.float32), np.asarray(
        jax.vmap(j.skeleton_states)(jnp.asarray(motion, jnp.float32)))


@pytest.mark.parametrize("branch", ["model_motion", "animation_channels"])
def test_load_with_skel_states(small, branch, tmp_path):
    """load_gltf_with_skel_states on both branches against JAX's at 2e-5:
    FB_momentum model-parameter motion through the rig, and the standard
    animation channels of GltfBuilder.add_skeleton_states (global → local
    on the writer's side, sampled joint parameters → FK on the loader's);
    each package's file loads in the other to the written states."""
    j, t = small
    motion, states = _states(j)
    if branch == "model_motion":
        jio.save_character_glb(str(tmp_path / "j.glb"), j, motion=motion, fps=24.0)
        t.save_gltf(str(tmp_path / "t.glb"), motion=torch.as_tensor(motion), fps=24.0)
    else:
        jio.GltfBuilder().add_character(j).add_skeleton_states(states).set_fps(24.0).save(
            str(tmp_path / "j.glb"))
        t.save_gltf_from_skel_states(str(tmp_path / "t.glb"), torch.tensor(states), 24.0)
    for name in ("j.glb", "t.glb"):
        path = tmp_path / name
        _, jstates, jfps = jload_states(str(path))
        char, got, fps = TCharacter.load_gltf_with_skel_states(str(path), device="cpu")
        assert got.device.type == "cpu" and fps == jfps and abs(fps - 24.0) < 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(jstates), rtol=0, atol=FK_TOL)
        np.testing.assert_allclose(got.numpy(), states, rtol=0, atol=FK_TOL)
        _, again, _ = TCharacter.load_gltf_with_skel_states_from_bytes(path.read_bytes(),
                                                                      device="cpu")
        np.testing.assert_array_equal(again.numpy(), got.numpy())
    if branch == "animation_channels":
        # the channels' bytes: the port's global → local conversion against
        # JAX's, each written value within float32 rounding of the other
        a, b = ((tmp_path / n).read_bytes() for n in ("t.glb", "j.glb"))
        assert len(a) == len(b)
        ja, jb = (json.loads(x[20:20 + struct.unpack_from("<I", x, 12)[0]]) for x in (a, b))
        assert ja == jb
        off = 20 + struct.unpack_from("<I", a, 12)[0] + 8
        fa, fb = (np.frombuffer(x[off:], np.float32) for x in (a, b))
        np.testing.assert_allclose(fa, fb, rtol=0, atol=2e-6)


def test_animation_fallback_motion(small, tmp_path):
    """load_character_glb on a file with animation channels and no
    FB_momentum motion: the motion through the rig's pseudo-inverse, JAX's
    within 1e-5."""
    j, _ = small
    _, states = _states(j, seed=13)
    jio.GltfBuilder().add_character(j).add_skeleton_states(states).set_fps(30.0).save(
        str(tmp_path / "a.glb"))
    doc_bytes = (tmp_path / "a.glb").read_bytes()
    jc, jm, jfps = jio.load_character_glb(doc_bytes)
    tc, tm, tfps = TCharacter.load_gltf_with_motion_from_bytes(doc_bytes, device="cpu")
    assert tfps == jfps
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-5)


def test_multi_character_builder(small, fullbody, tmp_path):
    """GltfBuilder with two characters, a motion, skeleton states and
    markers: JAX's bytes within float32 rounding of the local states; both
    packages' load_all_characters_glb on both files equal; add_mesh."""
    js, ts = small
    jf, tf = fullbody
    motion, (jm, tm), _, _ = _extras(js)
    _, states = _states(jf, frames=3)
    rng = np.random.default_rng(14)
    verts = rng.normal(size=(5, 3)).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4]], np.int32)
    (jio.GltfBuilder().add_character(js, "a").add_motion(motion).add_character(jf, "b")
     .add_skeleton_states(states).add_marker_sequence(jm).add_mesh(verts, faces, name="prop")
     .save(str(tmp_path / "j.glb")))
    (tio.GltfBuilder().add_character(ts, "a").add_motion(torch.as_tensor(motion))
     .add_character(tf, "b").add_skeleton_states(torch.as_tensor(states))
     .add_marker_sequence(tm).add_mesh(verts, faces, name="prop", device="cpu")
     .save(str(tmp_path / "t.glb")))
    for name in ("j.glb", "t.glb"):
        got = tio.load_all_characters_glb(str(tmp_path / name), device="cpu")
        want = jio.load_all_characters_glb(str(tmp_path / name))
        assert [g[0] for g in got] == [x[0] for x in want] == ["a", "b", "prop"]
        for (_, gc, gm), (_, wc, wm) in zip(got, want):
            assert_io_tables_equal(w.character_tables(gc, "c"),
                                   jax_reference.io_tables(wc, "c"), COMPUTED_TOL)
            assert gc.name == wc.name
            assert (gm is None) == (wm is None)
            if gm is not None:
                np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    a, b = ((tmp_path / n).read_bytes() for n in ("t.glb", "j.glb"))
    ja, jb = (json.loads(x[20:20 + struct.unpack_from("<I", x, 12)[0]]) for x in (a, b))
    assert ja == jb and len(a) == len(b)


def _unsorted_doc(jchar, tmp_path):
    """JAX's .glb of a rig with its joint nodes written children-first
    (reversed), the references between nodes renumbered."""
    jio.save_character_glb(str(tmp_path / "sorted.glb"), jchar)
    path_bytes = (tmp_path / "sorted.glb").read_bytes()
    jlen = struct.unpack_from("<I", path_bytes, 12)[0]
    doc = json.loads(path_bytes[20:20 + jlen])
    blob = path_bytes[20 + jlen + 8:]
    nj = jchar.skeleton.num_joints
    n = len(doc["nodes"])
    new_of = {old: (nj - 1 - old if old < nj else old) for old in range(n)}
    nodes = [None] * n
    for old, node in enumerate(doc["nodes"]):
        node = dict(node)
        if "children" in node:
            node["children"] = [new_of[c] for c in node["children"]]
        nodes[new_of[old]] = node
    doc["nodes"] = nodes
    doc["scenes"][0]["nodes"] = [new_of[i] for i in doc["scenes"][0]["nodes"]]
    doc["skins"][0]["joints"] = [new_of[i] for i in doc["skins"][0]["joints"]]
    doc["skins"][0]["skeleton"] = new_of[doc["skins"][0]["skeleton"]]
    jbytes = json.dumps(doc).encode()
    jbytes += b" " * ((-len(jbytes)) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 28 + len(jbytes) + len(blob))
            + struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
            + struct.pack("<II", len(blob), 0x004E4942) + blob)


def test_joint_resort(small, tmp_path):
    """A file whose joint nodes come children-first: the port re-sorts the
    joints parent-first and remaps the skin as JAX does."""
    j, _ = small
    data = _unsorted_doc(j, tmp_path)
    jc, _, _ = jio.load_character_glb(data)
    tc = TCharacter.load_gltf_from_bytes(data, device="cpu")
    assert_io_tables_equal(w.character_tables(tc, "c"), jax_reference.io_tables(jc, "c"),
                           COMPUTED_TOL)
    assert set(tc.skeleton.joint_names) == set(j.skeleton.joint_names)


def test_character_file_members(small, tmp_path):
    """Character's file members against JAX's: load_gltf, the legacy JSON
    from a path, bytes and a string, to_legacy_json_string, save by
    extension, load_motion_timestamps, load_locators / save_locators,
    load_model_definition."""
    j, t = small
    motion = np.zeros((2, t.num_model_parameters), np.float32)
    t.save(str(tmp_path / "t.glb"), motion=torch.as_tensor(motion))
    j.save(str(tmp_path / "j.glb"), motion=motion)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    assert_io_tables_equal(w.character_tables(TCharacter.load_gltf(str(tmp_path / "j.glb"),
                                                                   device="cpu"), "c"),
                           jax_reference.io_tables(JCharacter.load_gltf(str(tmp_path / "j.glb")),
                                                   "c"), COMPUTED_TOL)
    text = t.to_legacy_json_string()
    assert text == j.to_legacy_json_string()
    t.save_legacy_json(str(tmp_path / "t.json"))
    for got, want in ((TCharacter.load_legacy_json(str(tmp_path / "t.json"), device="cpu"),
                       JCharacter.load_legacy_json(str(tmp_path / "t.json"))),
                      (TCharacter.load_legacy_json_from_bytes(text.encode(), device="cpu"),
                       JCharacter.load_legacy_json_from_bytes(text.encode())),
                      (TCharacter.load_legacy_json_from_string(text, device="cpu"),
                       JCharacter.load_legacy_json_from_string(text))):
        assert_io_tables_equal(w.character_tables(got, "c"), jax_reference.io_tables(want, "c"))
    np.testing.assert_array_equal(TCharacter.load_motion_timestamps(str(tmp_path / "t.glb")),
                                  JCharacter.load_motion_timestamps(str(tmp_path / "j.glb")))
    t.save_locators(str(tmp_path / "t.locators"))
    j.save_locators(str(tmp_path / "j.locators"))
    assert (tmp_path / "t.locators").read_bytes() == (tmp_path / "j.locators").read_bytes()
    re_t = t.load_locators(str(tmp_path / "j.locators"))
    re_j = j.load_locators(str(tmp_path / "j.locators"))
    for k in ("parent", "offset", "locked", "limit_weight", "skin_offset"):
        np.testing.assert_array_equal(_np(getattr(re_t.locators, k)),
                                      np.asarray(getattr(re_j.locators, k)))
    model = jio.write_model_definition(j.parameter_transform, j.skeleton, j.limits)
    got, want = t.load_model_definition(model), j.load_model_definition(model)
    np.testing.assert_array_equal(got.parameter_transform.transform.numpy(),
                                  np.asarray(want.parameter_transform.transform))
    assert got.parameter_transform.parameter_sets == want.parameter_transform.parameter_sets
    with pytest.raises(ValueError):
        t.save_with_skel_states(str(tmp_path / "x.abc"), t.bind_pose()[None])


def test_ik_on_a_loaded_rig(fullbody, tmp_path):
    """IK at B = 64 (the main path's recipe) on the full-body rig written to
    .glb and loaded again equals IK on the in-memory rig, bit for bit."""
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem, make_solve_batch

    char, ef0, targets, x0 = build_fullbody_ik_problem(64, seed=3, device="cpu")
    char.save_gltf(str(tmp_path / "r.glb"))
    loaded = TCharacter.load_gltf(str(tmp_path / "r.glb"), device="cpu")
    want = make_solve_batch(char, ef0, 64)(targets, x0)
    got = make_solve_batch(loaded, ef0, 64)(targets, x0)
    np.testing.assert_array_equal(got.params.numpy(), want.params.numpy())
    np.testing.assert_array_equal(got.error.numpy(), want.error.numpy())
    assert float((want.error < 1e-5).float().mean()) > 0.9
