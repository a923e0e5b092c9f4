"""Parity of the port's file layer (momentum_tpu_torch/io) with
momentum_tpu.io on the CPU, for every part-1 format but glTF
(tests/test_torch_port_io_gltf.py): the .model definition, .locators in
both spaces, the legacy JSON, .mppca, .mmo, TRC, C3D (the tools writer's
real and integer files, Intel, DEC and MIPS), OBJ and the blend- and pose-shape files, the
JSON schemas of limits and bodies, the marker loaders (subjects, up axis,
bytes), the dispatch of character_io, compat's loaders and Mppca's file
members, and the committed reference files of tools/jax_reference_io.

For each format: (a) JAX writes and the port reads onto the CPU, every table
equal to what JAX's loader returns; (b) the port writes and JAX reads, the
same; (c) the port's bytes equal JAX's for the same object. Tables read
from a file are equal bit for bit (both parse the same text or bytes into
float32); the ones computed by FK or a rotation (a locator's global
position) within 1e-6, the JAX io tests' 1e-5 and tighter. The global
.locators text differs from JAX's in float digits where the two FK's bind
poses round apart, so (c) compares its decoded positions at 1e-6 instead.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from momentum_tpu import compat as jcompat
from momentum_tpu import io as jio
from momentum_tpu.character.blend_shape import BlendShape as JBlendShape
from momentum_tpu.character.pose_shape import PoseShape as JPoseShape
from momentum_tpu.errors.pose_prior import Mppca as JMppca
from momentum_tpu.io import shape as jshape
from momentum_tpu.io.limits_json import (
    limits_from_json as jlimits_from_json, limits_to_json as jlimits_to_json)
from momentum_tpu.io._physical import body_from_json as jbody_from_json
from momentum_tpu.io._physical import body_to_json as jbody_to_json
import momentum_tpu_torch.io as tio
from momentum_tpu_torch import compat as tcompat
from momentum_tpu_torch.character.blend_shape import BlendShape as TBlendShape
from momentum_tpu_torch.character.pose_shape import PoseShape as TPoseShape
from momentum_tpu_torch.errors.pose_prior import Mppca as TMppca
from momentum_tpu_torch.io import shape as tshape
from momentum_tpu_torch.io._physical import body_from_json as tbody_from_json
from momentum_tpu_torch.io._physical import body_to_json as tbody_to_json
from momentum_tpu_torch.io.limits_json import (
    limits_from_json as tlimits_from_json, limits_to_json as tlimits_to_json)
from momentum_tpu_torch.testing import workloads as w
from test_torch_port_helpers import assert_io_tables_equal, io_jax_rig, port_of
from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import c3d_writer  # noqa: E402
import jax_reference  # noqa: E402

COMPUTED_TOL = 1e-6


@pytest.fixture(scope="module")
def rigs():
    j = io_jax_rig()
    return j, port_of(j)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _fields(obj, names, prefix):
    return {f"{prefix}.{k}": _np(getattr(obj, k)) for k in names}


# ---- the formats, each with a JAX and a port writer and reader ----

def _prior(jchar):
    rng = np.random.default_rng(3)
    p = jchar.num_model_parameters
    return JMppca.from_components(
        pi=np.asarray([0.7, 0.3]), mu=rng.normal(0, 0.1, (2, p)).astype(np.float32),
        w_list=[rng.normal(0, 0.05, (p, 3)).astype(np.float32) for _ in range(2)],
        sigma2=np.asarray([0.5, 1.5]), names=jchar.parameter_transform.names)


def _port_prior(jp):
    return TMppca(**{k: torch.as_tensor(np.array(getattr(jp, k))) for k in
                     ("mu", "cinv", "l", "rpre")}, names=jp.names)


def _shapes(jchar):
    rng = np.random.default_rng(4)
    v = jchar.mesh.num_vertices
    verts = np.asarray(jchar.mesh.vertices)
    bs = JBlendShape(base_shape=jnp.asarray(verts),
                     shape_vectors=jnp.asarray(rng.normal(0, 0.05, (3, v, 3)).astype(np.float32)))
    ps = JPoseShape(base_rot=jchar.skeleton.pre_rotation[1],
                    base_shape=jnp.asarray(verts + rng.normal(0, 0.01, verts.shape)
                                           .astype(np.float32)),
                    shape_vectors=jnp.asarray(rng.normal(0, 0.02, (v, 3, 8)).astype(np.float32)),
                    base_joint=1, joint_map=(2, 3))
    return bs, ps


def _port_shapes(bs, ps):
    return (TBlendShape(base_shape=torch.as_tensor(np.asarray(bs.base_shape)),
                        shape_vectors=torch.as_tensor(np.asarray(bs.shape_vectors))),
            TPoseShape(base_rot=torch.as_tensor(np.asarray(ps.base_rot)),
                       base_shape=torch.as_tensor(np.asarray(ps.base_shape)),
                       shape_vectors=torch.as_tensor(np.asarray(ps.shape_vectors)),
                       base_joint=ps.base_joint, joint_map=ps.joint_map))


def _clip(names, frames=6, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2000.0, 2000.0, (frames, len(names), 3)).astype(np.float32)
    occ = rng.random((frames, len(names))) < 0.2
    return np.where(occ[..., None], np.nan, pos).astype(np.float32), occ


def _locator_fields(loc, prefix):
    out = _fields(loc, ("parent", "offset", "weight", "locked", "limit_weight",
                        "limit_origin", "attached_to_skin", "skin_offset"), prefix)
    out[f"{prefix}.names"] = np.asarray(list(loc.names))
    return out


def _model_tables(pt, limits, prefix):
    out = {f"{prefix}.transform": _np(pt.transform), f"{prefix}.offsets": _np(pt.offsets),
           f"{prefix}.names": np.asarray(list(pt.names)),
           f"{prefix}.sets": np.asarray(json.dumps({k: list(v) for k, v in
                                                    pt.parameter_sets.items()}))}
    out.update(_fields(limits, w.IO_LIMIT_KEYS, prefix))
    return out


def _write(pkg, fmt, jchar, tchar, path):
    """Write the rig's `fmt` file with `pkg` ("jax" or "port")."""
    char = jchar if pkg == "jax" else tchar
    io = jio if pkg == "jax" else tio
    if fmt == "model":
        with open(path, "w") as f:
            f.write(io.write_model_definition(char.parameter_transform, char.skeleton,
                                              char.limits))
    elif fmt in ("locators_local", "locators_global"):
        io.save_locators(path, char, fmt.split("_")[1])
    elif fmt == "legacy_json":
        io.save_legacy_json(path, char)
    elif fmt == "mppca":
        prior = _prior(jchar)
        io.save_mppca(path, prior if pkg == "jax" else _port_prior(prior))
    elif fmt == "mmo":
        motion = np.random.default_rng(6).normal(0, 0.3, (5, char.num_model_parameters))
        motion = motion.astype(np.float32)
        io.save_mmo(path, motion if pkg == "jax" else torch.as_tensor(motion),
                    np.arange(char.num_joints, dtype=np.float32),
                    list(char.parameter_transform.names), list(char.skeleton.joint_names))
    elif fmt == "trc":
        pos, occ = _clip(list(char.locators.names))
        raw = (jio.markers if pkg == "jax" else tio.markers).RawMarkerData(
            pos, occ, list(char.locators.names), 120.0)
        io.save_trc(path, raw)
    elif fmt == "blend_shape":
        bs, ps = _shapes(jchar)
        (jshape if pkg == "jax" else tshape).save_blend_shape(
            path, bs if pkg == "jax" else _port_shapes(bs, ps)[0])
    elif fmt == "pose_shape":
        bs, ps = _shapes(jchar)
        (jshape if pkg == "jax" else tshape).save_pose_shape(
            path, ps if pkg == "jax" else _port_shapes(bs, ps)[1], char)


def _read(pkg, fmt, jchar, tchar, path):
    """What `pkg`'s loader gives for the rig's `fmt` file, as numpy."""
    char = jchar if pkg == "jax" else tchar
    io = jio if pkg == "jax" else tio
    if fmt == "model":
        return _model_tables(*io.load_model_definition(str(path), char.skeleton), "model")
    if fmt in ("locators_local", "locators_global"):
        return _locator_fields(io.load_locators(str(path), char), "loc")
    if fmt == "legacy_json":
        got = io.load_legacy_json(str(path)) if pkg == "jax" else io.load_legacy_json(
            str(path), device="cpu")
        return (jax_reference.io_tables(got, "json") if pkg == "jax"
                else w.character_tables(got, "json"))
    if fmt == "mppca":
        mp = io.load_mppca(str(path)) if pkg == "jax" else io.load_mppca(str(path), "cpu")
        out = _fields(mp, ("mu", "cinv", "l", "rpre"), "mppca")
        out["mppca.names"] = np.asarray(list(mp.names))
        return out
    if fmt == "mmo":
        poses, scale, pn, jn = io.load_mmo(str(path))
        return {"mmo.poses": poses, "mmo.scale": scale, "mmo.pn": np.asarray(pn),
                "mmo.jn": np.asarray(jn)}
    if fmt == "trc":
        raw = io.load_trc(str(path))
        return {"trc.positions": raw.positions, "trc.occluded": raw.occluded,
                "trc.names": np.asarray(raw.names), "trc.fps": np.asarray(raw.fps)}
    if fmt == "blend_shape":
        mod = jshape if pkg == "jax" else tshape
        bs = mod.load_blend_shape(str(path)) if pkg == "jax" else mod.load_blend_shape(
            str(path), device="cpu")
        return _fields(bs, ("base_shape", "shape_vectors"), "bs")
    if fmt == "pose_shape":
        mod = jshape if pkg == "jax" else tshape
        ps = mod.load_pose_shape(str(path), char)
        out = _fields(ps, ("base_rot", "base_shape", "shape_vectors"), "ps")
        out.update({"ps.base_joint": np.asarray(ps.base_joint),
                    "ps.joint_map": np.asarray(ps.joint_map)})
        return out
    raise ValueError(fmt)


FORMATS = ("model", "locators_local", "locators_global", "legacy_json", "mppca", "mmo", "trc",
           "blend_shape", "pose_shape")
SUFFIX = {"model": ".model", "locators_local": ".locators", "locators_global": ".locators",
          "legacy_json": ".json", "mppca": ".mppca", "mmo": ".mmo", "trc": ".trc",
          "blend_shape": ".bin", "pose_shape": ".bin"}


def _tol(fmt):
    """The global .locators hold their offsets through the bind pose, an FK
    in each package."""
    return COMPUTED_TOL if fmt == "locators_global" else 0.0


def _assert_equal(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype.kind == b.dtype.kind and a.shape == b.shape, k
        if tol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_writes_port_reads(rigs, fmt, tmp_path):
    """(a) the port's loader on JAX's file gives what JAX's gives."""
    j, t = rigs
    path = tmp_path / f"a{SUFFIX[fmt]}"
    _write("jax", fmt, j, t, path)
    _assert_equal(_read("port", fmt, j, t, path), _read("jax", fmt, j, t, path), 0.0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_writes_jax_reads(rigs, fmt, tmp_path):
    """(b) JAX's loader on the port's file gives what it gives on its own
    file."""
    j, t = rigs
    mine, theirs = tmp_path / f"t{SUFFIX[fmt]}", tmp_path / f"j{SUFFIX[fmt]}"
    _write("port", fmt, j, t, mine)
    _write("jax", fmt, j, t, theirs)
    _assert_equal(_read("jax", fmt, j, t, mine), _read("jax", fmt, j, t, theirs), _tol(fmt))


@pytest.mark.parametrize("fmt", FORMATS + ("obj",))
def test_port_bytes_are_jax_bytes(rigs, fmt, tmp_path, monkeypatch):
    """(c) the port's writer gives JAX's bytes for the same object (a TRC
    header names its file: both are written under one relative name); the
    global .locators, whose positions come from each package's FK, within
    1e-6 on the decoded positions."""
    j, t = rigs
    name = f"x{SUFFIX.get(fmt, '.obj')}"
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    mine, theirs = tmp_path / "t" / name, tmp_path / "j" / name
    if fmt == "trc":
        monkeypatch.chdir(tmp_path / "t")
        _write("port", fmt, j, t, name)
        monkeypatch.chdir(tmp_path / "j")
        _write("jax", fmt, j, t, name)
    elif fmt == "obj":
        jio.save_obj(str(theirs), j.mesh.vertices, j.mesh.faces, j.mesh.normals)
        tio.save_obj(str(mine), t.mesh.vertices, t.mesh.faces, t.mesh.normals)
    else:
        _write("port", fmt, j, t, mine)
        _write("jax", fmt, j, t, theirs)
    a, b = mine.read_bytes(), theirs.read_bytes()
    if fmt != "locators_global":
        assert a == b
        return
    da, db = json.loads(a), json.loads(b)
    for ea, eb in zip(da["locators"], db["locators"]):
        assert {k: v for k, v in ea.items() if not k.startswith("global")} == \
            {k: v for k, v in eb.items() if not k.startswith("global")}
        np.testing.assert_allclose([ea[f"global{c}"] for c in "XYZ"],
                                   [eb[f"global{c}"] for c in "XYZ"], rtol=0, atol=COMPUTED_TOL)


def test_blend_shape_base_and_trims(rigs, tmp_path):
    """load_blend_shape_base and the expected_shapes / expected_vertices
    trims, against JAX's."""
    j, t = rigs
    bs, _ = _shapes(j)
    path = str(tmp_path / "b.bin")
    jshape.save_blend_shape(path, bs)
    np.testing.assert_array_equal(tshape.load_blend_shape_base(path, device="cpu").numpy(),
                                  np.asarray(jshape.load_blend_shape_base(path)))
    got = tshape.load_blend_shape(path, expected_shapes=2, expected_vertices=7, device="cpu")
    want = jshape.load_blend_shape(path, expected_shapes=2, expected_vertices=7)
    np.testing.assert_array_equal(got.base_shape.numpy(), np.asarray(want.base_shape))
    np.testing.assert_array_equal(got.shape_vectors.numpy(), np.asarray(want.shape_vectors))


# ---- JSON schemas ----

def test_limits_json_both_ways(rigs):
    """Every limit record type to JSON equal to JAX's, and back through
    each package's limits_from_json to equal tables."""
    j, t = rigs
    doc = tlimits_to_json(t)
    assert doc == jlimits_to_json(j)
    assert len({e["type"] for e in doc}) == 7
    got = tlimits_from_json(t, jlimits_to_json(j))
    want = jlimits_from_json(j, doc)
    for k in w.IO_LIMIT_KEYS:
        np.testing.assert_array_equal(_np(getattr(got, k)), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.minmax_index.device.type == "cpu"


def test_body_json_both_ways(rigs):
    pp = rigs[1].physical_properties
    jpp = rigs[0].physical_properties
    for b in range(pp.num_bodies):
        args = [getattr(pp, k)[b] for k in ("mass", "center_of_mass_offset", "inertia",
                                            "inertia_rotation")]
        jargs = [np.asarray(getattr(jpp, k))[b] for k in ("mass", "center_of_mass_offset",
                                                          "inertia", "inertia_rotation")]
        doc = tbody_to_json(float(args[0]), *args[1:])
        assert doc == jbody_to_json(*jargs)
        for a, e in zip(tbody_from_json(doc), jbody_from_json(doc)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(e))


# ---- markers ----

def _c3d_take(tmp_path, processor, point_format):
    names = [f"Sub:M{i}" for i in range(5)] + ["X0", "X1"]
    pos, occ = _clip(names, frames=9, seed=8)
    path = tmp_path / f"{processor}_{point_format}.c3d"
    c3d_writer.save_c3d(path, pos, occ, names, rate=100.0, processor=processor,
                        point_format=point_format)
    return path, pos, occ, names


@pytest.mark.parametrize("processor,point_format", [("intel", "real"), ("intel", "integer"),
                                                    ("dec", "real"), ("dec", "integer"),
                                                    ("mips", "real"), ("mips", "integer")])
def test_c3d_reader(tmp_path, processor, point_format):
    """The port's C3D reader on the tools writer's files: JAX's reader's
    result exactly, the written positions exactly in the real format and
    within half the scale in the integer one, the occlusion, labels and
    rate."""
    path, pos, occ, names = _c3d_take(tmp_path, processor, point_format)
    got, want = tio.load_c3d(str(path)), jio.load_c3d(str(path))
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.occluded, want.occluded)
    assert got.names == want.names == names
    assert got.fps == want.fps == 100.0
    np.testing.assert_array_equal(got.occluded, occ)
    atol = 0.0 if point_format == "real" else 0.5 * np.nanmax(np.abs(pos)) / 32000 + 1e-3
    np.testing.assert_allclose(got.positions[~occ], pos[~occ], rtol=0, atol=atol)
    assert np.isnan(got.positions[occ]).all()
    same = tio.load_c3d(path.read_bytes())
    np.testing.assert_array_equal(same.positions, got.positions)


def test_marker_loaders_split_subjects_and_axes(tmp_path):
    """load_markers / load_markers_from_bytes: the subject split, the up
    axis, each format by bytes, against JAX's."""
    path, *_ = _c3d_take(tmp_path, "intel", "real")
    for kw in (dict(), dict(main_subject_only=False), dict(up="z"), dict(up="x")):
        got, want = tio.load_markers(str(path), **kw), jio.load_markers(str(path), **kw)
        assert [m.name for m in got] == [m.name for m in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.positions, b.positions)
            np.testing.assert_array_equal(a.occluded, b.occluded)
            assert a.names == b.names and a.fps == b.fps
    got = tcompat.load_markers_from_bytes(path.read_bytes(), ".c3d", main_subject_only=False)
    want = jcompat.load_markers_from_bytes(path.read_bytes(), ".c3d", main_subject_only=False)
    assert [m.names for m in got] == [m.names for m in want]
    with pytest.raises(ValueError):
        tio.load_markers(str(tmp_path / "x.abc"))


def test_raw_markers_to_marker_sequence(tmp_path):
    """to_marker_sequence: JAX's positions (0 where occluded), on the
    device asked for."""
    path, *_ = _c3d_take(tmp_path, "dec", "real")
    got = tio.load_markers(str(path))[0].to_marker_sequence(device="cpu")
    want = jio.load_markers(str(path))[0].to_marker_sequence()
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.occluded.numpy(), np.asarray(want.occluded))
    assert got.names == want.names and got.positions.device.type == "cpu"


# ---- dispatch, compat, Mppca members ----

def test_full_character_with_side_cars(rigs, tmp_path):
    """load_full_character composes a legacy JSON with the .model and
    .locators side-cars as JAX's does; save_character by extension."""
    j, t = rigs
    jio.save_legacy_json(str(tmp_path / "c.json"), j)
    with open(tmp_path / "c.model", "w") as f:
        f.write(jio.write_model_definition(j.parameter_transform, j.skeleton, j.limits))
    jio.save_locators(str(tmp_path / "c.locators"), j)
    args = [str(tmp_path / n) for n in ("c.json", "c.model", "c.locators")]
    got = tio.load_full_character(*args, device="cpu")
    want = jio.load_full_character(*args)
    assert_io_tables_equal(w.character_tables(got, "c"), jax_reference.io_tables(want, "c"))
    for ext in (".json", ".obj", ".mmo"):
        motion = np.zeros((2, t.num_model_parameters), np.float32)
        tio.save_character(str(tmp_path / f"t{ext}"), t, motion=torch.as_tensor(motion))
        jio.save_character(str(tmp_path / f"j{ext}"), j, motion=motion)
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes(), ext
    assert tio.character_format("a.GLB") == jio.character_format("a.GLB") == "gltf"


@pytest.mark.parametrize("ext", [".fbx", ".usd", ".usda", ".usdc", ".urdf", ".bvh"])
def test_part_2_formats_raise(rigs, ext, tmp_path):
    """FBX, USD, URDF and BVH, which raised NotImplementedError until the
    file layer's second part, now round-trip: save_character by extension
    (URDF, which has no writer, from the arm of tests/test_io.py) and
    load_full_character of the file give the rig JAX's loader gives on the
    same file; save_with_skel_states for .fbx and .usd* reads back to the
    written states within 1e-5 (inverse FK in float32)."""
    from momentum_tpu_torch.io import fbx, usd

    j, t = rigs
    path = str(tmp_path / f"c{ext}")
    if ext == ".urdf":
        import test_torch_port_io_urdf_bvh as urdf_tests

        pathlib.Path(path).write_text(urdf_tests.ARM)
    else:
        tio.save_character(path, t, motion=torch.zeros(2, t.num_model_parameters))
    got = tio.load_full_character(path, device="cpu")
    want = jio.load_full_character(path)
    assert_io_tables_equal(w.character_tables(got, "c"), jax_reference.io_tables(want, "c"),
                           COMPUTED_TOL)
    assert got.skeleton.joint_parent.device.type == "cpu"
    if ext in (".fbx", ".usd", ".usda", ".usdc"):
        states = t.skeleton_states(torch.as_tensor(
            np.random.default_rng(1).uniform(-0.3, 0.3, (3, t.num_model_parameters)),
            dtype=torch.float32))
        t.save_with_skel_states(str(tmp_path / f"s{ext}"), states, fps=30.0)
        if ext == ".fbx":
            back, jp, _ = fbx.load_fbx_with_motion(str(tmp_path / f"s{ext}"), 30.0, device="cpu")
            back = back.skeleton_states(jp)
        else:
            _, back, _ = usd.load_character_with_skel_states(str(tmp_path / f"s{ext}"),
                                                             device="cpu")
        np.testing.assert_allclose(back.numpy(), states.numpy(), rtol=0, atol=1e-5)


def test_mppca_members(rigs, tmp_path):
    """Mppca.to_bytes / from_bytes / save / load: JAX's bytes, JAX's
    tables."""
    jp = _prior(rigs[0])
    tp = _port_prior(jp)
    assert tp.to_bytes() == jp.to_bytes()
    back = TMppca.from_bytes(jp.to_bytes(), device="cpu")
    tp.save(str(tmp_path / "p.mppca"))
    loaded = TMppca.load(str(tmp_path / "p.mppca"), device="cpu")
    want = JMppca.from_bytes(jp.to_bytes())
    for got in (back, loaded):
        for k in ("mu", "cinv", "l", "rpre"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
        assert got.names == want.names


def test_export_motion_objs(rigs, tmp_path):
    """export_motion_objs skins each strided frame (FK and skinning) and
    writes JAX's OBJ text to within the last printed digit (the two skin
    in float32 apart), with JAX's file names."""
    j, t = rigs
    motion = np.random.default_rng(9).normal(0, 0.3, (5, t.num_model_parameters))
    motion = motion.astype(np.float32)
    got = tio.export_motion_objs(str(tmp_path / "t"), t, torch.as_tensor(motion), stride=2)
    want = jio.export_motion_objs(str(tmp_path / "j"), j, jnp.asarray(motion), stride=2)
    assert [pathlib.Path(p).name[1:] for p in got] == [pathlib.Path(p).name[1:] for p in want]
    for a, b in zip(got, want):
        va = np.asarray([ln.split()[1:] for ln in open(a) if ln.startswith("v ")], float)
        vb = np.asarray([ln.split()[1:] for ln in open(b) if ln.startswith("v ")], float)
        np.testing.assert_allclose(va, vb, rtol=0, atol=2e-6)
        fa = [ln for ln in open(a) if ln.startswith("f ")]
        assert fa == [ln for ln in open(b) if ln.startswith("f ")]


# ---- the committed reference files ----

def test_reference_files_load_as_jax_loaded_them():
    """Every file of tools/jax_reference_io, read by the port onto the CPU,
    gives what JAX's loaders gave (jax_reference_io.npz): bit for bit, the
    FK-computed inverse bind poses and skeleton states within 1e-6."""
    directory = REPO / w.IO_REFERENCE_DIR
    want = dict(np.load(directory / "jax_reference_io.npz"))
    assert_io_tables_equal(w.io_reference_loads(str(directory), device="cpu"), want,
                           COMPUTED_TOL)


def test_reference_take_c3d_holds_the_trc():
    """The committed take's real-format C3D positions, printed to the TRC's
    5 decimals, are the TRC's; the integer file's within half its scale."""
    directory = REPO / w.IO_REFERENCE_DIR
    trc = tio.load_markers(str(directory / "take.trc"))[0]
    real = tio.load_markers(str(directory / "take_real.c3d"))[0]
    integer = tio.load_markers(str(directory / "take_integer.c3d"))[0]
    assert real.names == trc.names == integer.names
    np.testing.assert_array_equal(real.occluded, trc.occluded)
    vis = ~trc.occluded
    printed = np.asarray([float(f"{v:.5f}") for v in real.positions[vis].reshape(-1)],
                         np.float32)
    np.testing.assert_array_equal(printed, trc.positions[vis].reshape(-1))
    scale = np.abs(trc.positions[vis]).max() / 32000
    np.testing.assert_allclose(integer.positions[vis], trc.positions[vis], rtol=0,
                               atol=0.5 * scale + 1e-3)


def test_io_exports_jax_io_names():
    """momentum_tpu_torch.io exports every name of momentum_tpu.io, and each
    of its modules (those of both parts of the file layer) the names of
    JAX's module of that name."""
    import types

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), types.ModuleType)}

    assert public(jio) <= public(tio), sorted(public(jio) - public(tio))
    for name in ("_physical", "limits_json", "locators", "model_definition", "legacy_json",
                 "gltf", "gltf_builder", "pose_prior", "shape", "markers", "motion", "obj",
                 "character_io", "bvh", "urdf", "fbx", "fbx_writer", "fbx_builder",
                 "usdc_crate", "usd"):
        jmod = __import__(f"momentum_tpu.io.{name}", fromlist=["x"])
        tmod = __import__(f"momentum_tpu_torch.io.{name}", fromlist=["x"])
        assert set(jmod.__all__) <= set(tmod.__all__), name
