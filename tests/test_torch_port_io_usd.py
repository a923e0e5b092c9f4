"""Parity of the port's USD layer (momentum_tpu_torch/io/usd.py and
usdc_crate.py) with momentum_tpu's on the CPU.

The document model (the usda tokenizer, parser and writer, the crate's
writer and reader, the earlier private container's reader) is numpy and
bytes code: on the same stage the port's text and crate bytes are JAX's
exactly. A character's stage also carries computed floats, the rest and
bind poses (the bind pose by FK) and a motion's per-frame local transforms
(Euler angles to quaternions to matrices, each package in float32 on its
own): the port's files are decoded and held to JAX's attribute by
attribute, those three matrix attributes within FK_TOL (1e-6) and every
other value exactly. Loads hold every table bit for bit (the joints' rest
rotations and offsets come from the same float32 matrices through each
package's from_matrix, and agree exactly here), the inverse bind pose
within FK_TOL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from momentum_tpu import io as jio
from momentum_tpu.io import usd as jusd
from momentum_tpu.io import usdc_crate as juc
import momentum_tpu_torch.io as tio
from momentum_tpu_torch.character import fk
from momentum_tpu_torch.io import usd as tusd
from momentum_tpu_torch.io import usdc_crate as tuc
from momentum_tpu_torch.testing import workloads as w
from test_torch_port_helpers import (
    assert_io_tables_equal, io_jax_rig, jax_fullbody_character, port_of)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

import test_torch_port_io_fbx as fbx_tests

FK_TOL = 1e-6
COMPUTED_ATTRS = ("bindTransforms", "restTransforms", "transforms")


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


def _items(stage):
    """(prim path, what, value) of every prim, attribute and sample of a
    stage, in order."""
    out = [("", "meta", stage.meta)]

    def walk(prim, path):
        here = f"{path}/{prim.name}"
        out.append((here, "prim", (prim.type, prim.meta)))
        for a in prim.attrs.values():
            out.append((f"{here}.{a.name}", "attr", (a.type, a.meta, a.uniform)))
            out.append((f"{here}.{a.name}", a.name, a.value))
            for k in sorted(a.time_samples):
                out.append((f"{here}.{a.name}[{k}]", a.name, a.time_samples[k]))
        for c in prim.children:
            walk(c, here)

    for r in stage.roots:
        walk(r, "")
    return out


def assert_stages_match(got, want):
    """Two stages equal item by item, the computed matrix attributes within
    FK_TOL."""
    a, b = _items(got), _items(want)
    assert [(p, k) for p, k, _ in a] == [(p, k) for p, k, _ in b]
    for (path, what, x), (_, _, y) in zip(a, b):
        if what in COMPUTED_ATTRS:
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                       rtol=0, atol=FK_TOL, err_msg=path)
        else:
            assert x == y, path


def _read_stage(path):
    """A file as JAX's document model parses it."""
    if str(path).endswith(".usdc"):
        return jusd.read_usdc(str(path))
    return jusd.parse_usda(open(path).read())


# ---- writers ----

CASES = [("usda", True), ("usda", False), ("usdc", True), ("usdc", False)]
IDS = ["usda_motion", "usda_rest", "usdc_motion", "usdc_rest"]


@pytest.mark.parametrize("ext,with_motion", CASES, ids=IDS)
def test_port_files_hold_jax_files(rigs, ext, with_motion, tmp_path):
    """(c) save_usd's file, decoded, is JAX's: every prim, attribute and
    time sample, the matrices within FK_TOL."""
    j, t = rigs
    motion = _motion(j) if with_motion else None
    tio.save_usd(str(tmp_path / f"t.{ext}"), t,
                 motion=None if motion is None else torch.as_tensor(motion), fps=30.0)
    jio.save_usd(str(tmp_path / f"j.{ext}"), j, motion=motion, fps=30.0)
    assert_stages_match(_read_stage(tmp_path / f"t.{ext}"), _read_stage(tmp_path / f"j.{ext}"))


@pytest.mark.parametrize("ext,with_motion", CASES, ids=IDS)
def test_jax_writes_port_reads(rigs, ext, with_motion, tmp_path):
    """(a) load_usd on JAX's file: JAX's tables and motion bit for bit, on
    the CPU; load_usda and the bytes loaders alike."""
    j, t = rigs
    path = tmp_path / f"j.{ext}"
    jio.save_usd(str(path), j, motion=_motion(j) if with_motion else None, fps=30.0)
    got, motion = tio.load_usd(str(path), device="cpu")
    want, want_motion = jio.load_usd(str(path))
    assert_io_tables_equal(w.character_tables(got, "c"),
                           fbx_tests._jax_tables(want, "c"), FK_TOL)
    assert got.name == want.name and got.skeleton.joint_parent.device.type == "cpu"
    if with_motion:
        np.testing.assert_array_equal(motion.numpy(), want_motion)
    else:
        assert motion is None and want_motion is None
    from_bytes = tusd.load_character_from_bytes(path.read_bytes(), device="cpu")
    assert_io_tables_equal(w.character_tables(from_bytes, "c"),
                           fbx_tests._jax_tables(want, "c"), FK_TOL)
    if ext == "usda":
        assert_io_tables_equal(w.character_tables(tio.load_usda(str(path), device="cpu")[0],
                                                  "c"), fbx_tests._jax_tables(want, "c"), FK_TOL)


@pytest.mark.parametrize("ext", ["usda", "usdc"])
def test_port_writes_jax_reads(rigs, ext, tmp_path):
    """(b) JAX's load_usd on the port's file gives what it gives on its own."""
    j, t = rigs
    motion = _motion(j)
    tio.save_usd(str(tmp_path / f"t.{ext}"), t, motion=torch.as_tensor(motion), fps=30.0)
    jio.save_usd(str(tmp_path / f"j.{ext}"), j, motion=motion, fps=30.0)
    got, got_motion = jio.load_usd(str(tmp_path / f"t.{ext}"))
    want, want_motion = jio.load_usd(str(tmp_path / f"j.{ext}"))
    got_tables, want_tables = fbx_tests._jax_tables(got, "c"), fbx_tests._jax_tables(want, "c")
    for k in ("c.pre_rotation", "c.translation_offset"):  # from the bind matrices, FK_TOL
        np.testing.assert_allclose(got_tables.pop(k), want_tables.pop(k), rtol=0, atol=FK_TOL)
    assert_io_tables_equal(got_tables, want_tables, FK_TOL)
    np.testing.assert_array_equal(got_motion, want_motion)


# ---- the document model: text and crate bytes ----

def _demo_text(jchar):
    return jusd.write_usda(jusd._character_to_stage(jchar, _motion(jchar, 2), 30.0))


def test_usda_text_and_crate_bytes_are_jax_bytes(rigs, tmp_path):
    """On the same text, parse_usda + write_usda gives JAX's text and
    write_crate JAX's crate bytes; read_crate reads JAX's crate to JAX's
    stage."""
    text = _demo_text(rigs[0])
    tstage, jstage = tusd.parse_usda(text), jusd.parse_usda(text)
    again = tusd.write_usda(tstage)
    assert again == jusd.write_usda(jstage)
    assert tusd.write_usda(tusd.parse_usda(again)) == again
    tuc.write_crate(tstage, str(tmp_path / "t.usdc"))
    juc.write_crate(jstage, str(tmp_path / "j.usdc"))
    data = (tmp_path / "j.usdc").read_bytes()
    assert (tmp_path / "t.usdc").read_bytes() == data
    assert_stages_match(tuc.read_crate(data), juc.read_crate(data))
    assert_stages_match(tusd.read_usdc(str(tmp_path / "j.usdc")),
                        jusd.read_usdc(str(tmp_path / "j.usdc")))


def test_legacy_container_still_readable(rigs, tmp_path):
    """A file of the earlier private container (version 0.0.1, JAX's
    _write_usdc_legacy) reads to JAX's stage and character."""
    j, _ = rigs
    stage = jusd._character_to_stage(j, _motion(j, 2), 30.0)
    path = str(tmp_path / "legacy.usdc")
    jusd._write_usdc_legacy(stage, path)
    assert_stages_match(tusd.read_usdc(path), jusd.read_usdc(path))
    got, _ = tio.load_usd(path, device="cpu")
    assert_io_tables_equal(w.character_tables(got, "c"),
                           fbx_tests._jax_tables(jio.load_usd(path)[0], "c"), FK_TOL)


def test_joint_transforms_without_momentum_motion(rigs, tmp_path):
    """A SkelAnimation with joint transforms only (no momentum:motion:*):
    the (F, nJ, 4, 4) joint-local matrices JAX's loader returns; bind
    transforms only: the locals composed against the parents' inverses."""
    j, _ = rigs
    stage = jusd._character_to_stage(j, _motion(j, 3), 30.0)
    anim = stage.find("SkelAnimation")[0]
    for k in ("momentum:motion:poses", "momentum:motion:numFrames", "momentum:motion:numParams"):
        del anim.attrs[k]
    del stage.find("Skeleton")[0].attrs["restTransforms"]
    path = tmp_path / "t.usda"
    path.write_text(jusd.write_usda(stage))
    got, motion = tio.load_usd(str(path), device="cpu")
    want, want_motion = jio.load_usd(str(path))
    assert motion.shape == (3, j.num_joints, 4, 4)
    np.testing.assert_array_equal(motion, want_motion)
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)


# ---- the binding surface ----

def test_binding_surface(rigs, tmp_path):
    """load_character_with_motion and load_character_with_skel_states (one
    batched FK over every frame) against JAX's; save_character and
    is_usd_available."""
    j, t = rigs
    motion = _motion(j, 4)
    tusd.save_character(str(tmp_path / "t.usda"), t, fps=25.0, motion=torch.as_tensor(motion))
    jusd.save_character(str(tmp_path / "j.usda"), j, fps=25.0, motion=motion)
    assert_stages_match(_read_stage(tmp_path / "t.usda"), _read_stage(tmp_path / "j.usda"))
    path = str(tmp_path / "j.usda")
    char, got_motion, identity, fps = tusd.load_character_with_motion(path, device="cpu")
    _, want_motion, want_identity, want_fps = jusd.load_character_with_motion(path)
    np.testing.assert_array_equal(got_motion.numpy(), want_motion)
    np.testing.assert_array_equal(identity.numpy(), want_identity)
    assert fps == want_fps == 25.0 and identity.dtype == torch.float32
    _, states, fps = tusd.load_character_with_skel_states(path, device="cpu")
    _, want_states, _ = jusd.load_character_with_skel_states(path)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), rtol=0, atol=FK_TOL)
    data = open(path, "rb").read()
    _, states_b, _ = tusd.load_character_with_skel_states_from_bytes(data, device="cpu")
    np.testing.assert_array_equal(states_b.numpy(), states.numpy())
    _, m, _, _ = tusd.load_character_with_motion_from_bytes(data, device="cpu")
    np.testing.assert_array_equal(m.numpy(), want_motion)
    assert tusd.is_usd_available() and jusd.is_usd_available()
    tusd.save_character(str(tmp_path / "rest.usda"), t)
    _, rest, _ = tusd.load_character_with_skel_states(str(tmp_path / "rest.usda"), device="cpu")
    np.testing.assert_allclose(rest.numpy(), t.bind_pose()[None].numpy(), rtol=0, atol=FK_TOL)


@pytest.mark.parametrize("ext", [".usda", ".usdc"])
def test_save_with_skel_states_usd(rigs, ext, tmp_path):
    """Character.save_with_skel_states to USD (inverse FK, then the cached
    pseudo-inverse) and load_character_with_skel_states back: the written
    states within 1e-5 (float32 inverse FK, through the identity rig's
    model parameters), the model parameters within 1e-5 of JAX's."""
    j, t = rigs
    states = t.skeleton_states(torch.as_tensor(_motion(j, 4)))
    t.save_with_skel_states(str(tmp_path / f"t{ext}"), states, fps=30.0)
    j.save_with_skel_states(str(tmp_path / f"j{ext}"), jnp.asarray(states.numpy()), fps=30.0)
    _, got, _ = tusd.load_character_with_skel_states(str(tmp_path / f"t{ext}"), device="cpu")
    np.testing.assert_allclose(got.numpy(), states.numpy(), rtol=0, atol=1e-5)
    _, motion, _, _ = tusd.load_character_with_motion(str(tmp_path / f"t{ext}"), device="cpu")
    _, want, _, _ = jusd.load_character_with_motion(str(tmp_path / f"j{ext}"))
    np.testing.assert_allclose(motion.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ext", ["usda", "usdc"])
def test_fullbody_rig_both_ways(fullbody, ext, tmp_path):
    """The full-body rig (51 joints, pre-rotations) with 8 frames: JAX's file
    item by item; each package's load of the other's file its own."""
    j, t = fullbody
    motion = _motion(j, 8)
    tio.save_usd(str(tmp_path / f"t.{ext}"), t, motion=torch.as_tensor(motion), fps=30.0)
    jio.save_usd(str(tmp_path / f"j.{ext}"), j, motion=motion, fps=30.0)
    assert_stages_match(_read_stage(tmp_path / f"t.{ext}"), _read_stage(tmp_path / f"j.{ext}"))
    got, got_motion = tio.load_usd(str(tmp_path / f"j.{ext}"), device="cpu")
    want, want_motion = jio.load_usd(str(tmp_path / f"j.{ext}"))
    assert_io_tables_equal(w.character_tables(got, "c"), fbx_tests._jax_tables(want, "c"),
                           FK_TOL)
    np.testing.assert_array_equal(got_motion.numpy(), want_motion)
    states = fk.global_skel_states(got.skeleton, got.parameter_transform.apply(got_motion))
    np.testing.assert_allclose(states.numpy(), t.skeleton_states(torch.as_tensor(motion)).numpy(),
                               rtol=0, atol=1e-5)


def test_stage_without_skeleton_raises(tmp_path):
    path = tmp_path / "empty.usda"
    path.write_text('#usda 1.0\n\ndef Xform "Root"\n{\n}\n')
    with pytest.raises(ValueError, match="no Skeleton prim"):
        tio.load_usd(str(path), device="cpu")
    with pytest.raises(ValueError, match="no Skeleton prim"):
        jio.load_usd(str(path))
    assert dataclasses.is_dataclass(tusd.Stage)


def test_io2_reference_files_load_as_jax_loaded_them():
    """Every file of tools/jax_reference_io2 (the full-body rig as .fbx,
    .usda, .usdc and .bvh, the CMU rig as .usda + .model, the arm URDF),
    read by the port onto the CPU, gives what JAX's loaders gave
    (jax_reference_io2.npz): bit for bit, the FK-computed inverse bind pose
    and skeleton states, the USD rest rotations and offsets and the BVH
    motion within FK_TOL."""
    import pathlib

    directory = pathlib.Path(__file__).resolve().parents[1] / w.IO2_REFERENCE_DIR
    want = dict(np.load(directory / "jax_reference_io2.npz"))
    got = w.io2_reference_loads(str(directory), device="cpu")
    bad = w.io_mismatches(got, want, FK_TOL, w.IO2_COMPUTED)
    assert not bad, bad
    assert len(want) > 250
