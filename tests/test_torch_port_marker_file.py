"""Parity of the port's marker-file pipeline with momentum_tpu's on the CPU:
`process_marker_file` and `save_motion` (tracking/process_markers.py),
`app_utils` (load_character, load_character_with_identity), the tracking
package's names, and the process-markers CLI
(momentum_tpu_torch/tracking/process_markers_app.py) in a subprocess.

The pipeline runs on tests/test_process_markers_api.py's setup: the 4-joint
test rig and a synthetic 6-frame clip written as TRC. Per-frame solves of
the two packages converge to the same poses on their own arithmetic, so
the motions are held within 1e-4 of JAX's and each package's marker
residual below JAX's test's 1e-5; every output file is read back to the
returned motion (.glb and .mmo exactly, .fbx through its float32 curves
and JAX's sampler, .bvh within its 6 printed decimals). The CLI runs with
`--device cpu` on one torch thread, its .mmo equal to the in-process
pipeline with the CLI's settings; without `--device` it exits non-zero
here (no card) instead of carrying on on the CPU.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from momentum_tpu import io as jio
from momentum_tpu import tracking as jtracking
from momentum_tpu.testing.fixtures import create_test_character
from momentum_tpu.tracking.app_utils import (
    load_character as jload_character,
    load_character_with_identity as jload_character_with_identity)
import momentum_tpu_torch.io as tio
from momentum_tpu_torch import tracking as ttracking
from momentum_tpu_torch.testing import workloads as w
from momentum_tpu_torch.tracking import app_utils
from test_torch_port_helpers import assert_io_tables_equal, port_of
from test_torch_port_helpers import one_torch_thread  # noqa: F401

import test_torch_port_io_fbx as fbx_tests
import test_torch_port_io_urdf_bvh as urdf_tests

REPO = pathlib.Path(__file__).resolve().parents[1]
MOTION_TOL = 1e-4
FK_TOL = 1e-6
CLI = [sys.executable, "-m", "momentum_tpu_torch.tracking.process_markers_app"]


@pytest.fixture(scope="module")
def take(tmp_path_factory):
    """(directory, JAX rig, port rig, the clip's truth): the rig as .glb,
    the 6-frame clip as .trc."""
    d = tmp_path_factory.mktemp("take")
    char = create_test_character(4)
    rng = np.random.default_rng(12345)
    p = char.num_model_parameters
    t = np.linspace(0, 1, 6)[:, None]
    thetas = rng.uniform(0.05, 0.3, p) * np.sin(2 * np.pi * t + rng.uniform(0, 2 * np.pi, p))
    thetas[:, 0] = np.clip(thetas[:, 0], -0.09, 0.09)
    thetas[:, char.parameter_transform.parameter_index("scale_global")] = 0.0
    thetas = jnp.asarray(thetas, jnp.float32)
    positions = jax.vmap(char.locators.world_positions)(jax.vmap(char.skeleton_states)(thetas))
    jio.save_character_glb(str(d / "char.glb"), char)
    jio.save_trc(str(d / "clip.trc"), jio.RawMarkerData(
        np.asarray(positions), np.zeros(positions.shape[:2], bool), list(char.locators.names),
        fps=30.0))
    return d, char, port_of(char), np.asarray(thetas)


def _tracking(pkg, **kw):
    mod = jtracking if pkg == "jax" else ttracking
    return mod.TrackingConfig(max_iter=30, regularization=1e-5, **kw)


def _read_motion(path, fps=30.0):
    """The model-parameter motion of an output file, as numpy."""
    ext = os.path.splitext(str(path))[1]
    if ext == ".glb":
        return tio.load_character_glb(str(path), device="cpu")[1].numpy()
    if ext == ".mmo":
        return tio.load_mmo(str(path))[0]
    if ext == ".fbx":
        return tio.load_fbx_with_motion(str(path), fps, device="cpu")[1].numpy()
    return tio.load_bvh(str(path), device="cpu")[1].numpy()


@pytest.mark.parametrize("ext", [".glb", ".fbx", ".bvh", ".mmo"])
def test_process_marker_file_matches_jax(take, ext, tmp_path):
    """process_marker_file, TRC in, each output format out: the port's
    motion within MOTION_TOL of JAX's, both residuals below 1e-5; the file
    read back gives the returned motion (as joint parameters for .fbx and
    .bvh)."""
    d, jchar, tchar, _ = take
    kw = dict(character_path=str(d / "char.glb"), calibrate=False)
    got = ttracking.process_marker_file(str(d / "clip.trc"), str(tmp_path / f"t{ext}"),
                                        _tracking("port"), device="cpu", **kw)
    want = jtracking.process_marker_file(str(d / "clip.trc"), str(tmp_path / f"j{ext}"),
                                         _tracking("jax"), **kw)
    assert got.motion.device.type == "cpu"
    assert float(got.errors.max()) < 1e-5 and float(jnp.max(want.errors)) < 1e-5
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(want.motion), rtol=0,
                               atol=MOTION_TOL)
    back = _read_motion(tmp_path / f"t{ext}")
    if ext in (".glb", ".mmo"):
        np.testing.assert_array_equal(back, got.motion.numpy())
    else:
        jp = tchar.parameter_transform.apply(got.motion).numpy()
        back = back[:, :jp.shape[1]]  # a BVH adds the chain's end site as a last joint
        np.testing.assert_allclose(back, jp, rtol=0, atol=5e-7 if ext == ".fbx" else 1e-5)
        np.testing.assert_allclose(back, _read_motion(tmp_path / f"j{ext}")[:, :jp.shape[1]],
                                   rtol=0, atol=MOTION_TOL)


def test_process_marker_file_calibrates_and_raises(take, tmp_path):
    """With calibration (1 round of GN 5 on the 6 frames) from a JSON identity:
    the motion within MOTION_TOL of JAX's; an unknown output extension
    raises JAX's ValueError before anything is read."""
    d, _, _, truth = take
    (d / "identity.json").write_text(json.dumps([0.0] * truth.shape[1]))
    cfg = dict(calib_frames=6, major_iter=1, max_iter=5, regularization=1e-4)
    kw = dict(character_path=str(d / "char.glb"), identity_path=str(d / "identity.json"))
    got = ttracking.process_marker_file(
        str(d / "clip.trc"), str(tmp_path / "t.mmo"), _tracking("port"),
        ttracking.CalibrationConfig(**cfg), device="cpu", **kw)
    want = jtracking.process_marker_file(
        str(d / "clip.trc"), str(tmp_path / "j.mmo"), _tracking("jax"),
        jtracking.CalibrationConfig(**cfg), **kw)
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(want.motion), rtol=0,
                               atol=MOTION_TOL)
    for mod, kw2 in ((ttracking, {"device": "cpu"}), (jtracking, {})):
        with pytest.raises(ValueError, match="invalid output file type"):
            mod.process_marker_file(str(d / "missing.trc"), str(tmp_path / "x.obj"),
                                    character_path=str(d / "char.glb"), calibrate=False, **kw2)


@pytest.mark.parametrize("ext", [".glb", ".mmo"])
def test_save_motion_matches_jax(take, ext, tmp_path):
    """save_motion: the identity split out into the GLB identity section
    (with the markers) or baked into an .mmo's motion; the port's file
    holds JAX's (the .mmo byte for byte; the .glb's motion, markers and
    identity equal)."""
    d, jchar, tchar, truth = take
    rng = np.random.default_rng(4)
    motion = (truth + rng.normal(0, 0.01, truth.shape)).astype(np.float32)
    identity = np.zeros(truth.shape[1], np.float32)
    identity[jchar.parameter_transform.scaling_parameters] = 0.05
    raw = tio.load_trc(str(d / "clip.trc"))
    ttracking.save_motion(str(tmp_path / f"t{ext}"), tchar, torch.as_tensor(identity),
                          torch.as_tensor(motion), raw.to_marker_sequence(device="cpu"),
                          fps=30.0)
    jtracking.save_motion(str(tmp_path / f"j{ext}"), jchar, jnp.asarray(identity),
                          jnp.asarray(motion), jio.load_trc(str(d / "clip.trc"))
                          .to_marker_sequence(), fps=30.0)
    mine, theirs = (tmp_path / f"t{ext}").read_bytes(), (tmp_path / f"j{ext}").read_bytes()
    if ext == ".mmo":
        assert mine == theirs
        return
    got, want = tio.load_motion(str(tmp_path / f"t{ext}")), jio.load_motion(str(tmp_path /
                                                                             f"j{ext}"))
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=0, atol=FK_TOL)
        else:
            assert a == b
    gm = tio.load_character_glb(str(tmp_path / f"t{ext}"), return_markers=True, device="cpu")[3]
    np.testing.assert_array_equal(gm.positions.numpy(), raw.to_marker_sequence(
        device="cpu").positions.numpy())
    with pytest.raises(ValueError, match="parameters"):
        ttracking.save_motion(str(tmp_path / "bad.glb"), tchar, None, torch.zeros(2, 3))


# ---- app_utils ----

@pytest.mark.parametrize("ext", [".glb", ".fbx", ".urdf", ".usda"])
def test_load_character_by_extension(take, ext, tmp_path):
    """app_utils.load_character: JAX's character for each extension it
    reads; others raise JAX's ValueError."""
    d, jchar, tchar, _ = take
    path = str(tmp_path / f"c{ext}")
    if ext == ".urdf":
        pathlib.Path(path).write_text(urdf_tests.ARM)
    elif ext == ".glb":
        path = str(d / "char.glb")
    else:
        jio.save_character(path, jchar)
    got = app_utils.load_character(path, device="cpu")
    assert_io_tables_equal(w.character_tables(got, "c"),
                           fbx_tests._jax_tables(jload_character(path), "c"), FK_TOL)
    with pytest.raises(ValueError, match="unsupported character format"):
        app_utils.load_character(str(tmp_path / "c.obj"), device="cpu")


@pytest.mark.parametrize("kind", ["none", "mmo", "json_list", "json_dict"])
def test_load_character_with_identity(take, kind, tmp_path):
    """The identity of an .mmo's first frame, a JSON list or a JSON
    name → value object, with a .model override: JAX's values, float32 on
    the character's device."""
    d, jchar, _, _ = take
    names = list(jchar.parameter_transform.names)
    values = np.linspace(-0.2, 0.3, len(names)).astype(np.float32)
    with open(tmp_path / "c.model", "w") as f:
        f.write(jio.write_model_definition(jchar.parameter_transform, jchar.skeleton,
                                           jchar.limits))
    identity_path = None
    if kind == "mmo":
        identity_path = tmp_path / "id.mmo"
        jio.save_mmo(str(identity_path), np.stack([values, -values]),
                     np.zeros(jchar.num_joints, np.float32), names,
                     list(jchar.skeleton.joint_names))
    elif kind == "json_list":
        identity_path = tmp_path / "id.json"
        identity_path.write_text(json.dumps(values.tolist()))
    elif kind == "json_dict":
        identity_path = tmp_path / "id.json"
        identity_path.write_text(json.dumps({n: float(v) for n, v in zip(names[::2],
                                                                          values[::2])}))
    args = (str(d / "char.glb"), str(tmp_path / "c.model"),
            None if identity_path is None else str(identity_path))
    char, identity = app_utils.load_character_with_identity(*args, device="cpu")
    want_char, want = jload_character_with_identity(*args)
    np.testing.assert_array_equal(identity.numpy(), np.asarray(want))
    assert identity.dtype == torch.float32 and identity.device.type == "cpu"
    assert_io_tables_equal(w.character_tables(char, "c"),
                           fbx_tests._jax_tables(want_char, "c"), FK_TOL)
    if kind == "none":
        with pytest.raises(ValueError, match="unsupported identity format"):
            app_utils.load_character_with_identity(str(d / "char.glb"),
                                                   identity_path=str(tmp_path / "id.txt"),
                                                   device="cpu")


def test_tracking_exports_jax_tracking_names():
    """momentum_tpu_torch.tracking exports every public name of
    momentum_tpu.tracking (functions, classes and submodules), and
    app_utils and process_markers theirs."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(jtracking) <= public(ttracking), sorted(public(jtracking) - public(ttracking))
    for name in ("app_utils", "process_markers", "tracker", "config"):
        jmod = __import__(f"momentum_tpu.tracking.{name}", fromlist=["x"])
        tmod = __import__(f"momentum_tpu_torch.tracking.{name}", fromlist=["x"])
        if hasattr(jmod, "__all__"):
            assert set(jmod.__all__) <= set(tmod.__all__), name
        assert isinstance(tmod, types.ModuleType)


# ---- the CLI ----

def _cli(args, tmp_path, device="cpu"):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    extra = ["--device", device] if device else []
    return subprocess.run(CLI + args + extra, cwd=tmp_path, capture_output=True, text=True,
                          timeout=240, env=env)


def test_cli_matches_the_pipeline(take, tmp_path):
    """The CLI with --device cpu, calibration on (6 frames, 1 round of GN
    5, the CLI's regularization 0.05), to .mmo: exit 0, JAX's CLI's lines,
    and its motion the in-process process_marker_file's with the same
    settings."""
    d, _, _, _ = take
    out = _cli(["--markers", str(d / "clip.trc"), "--character", str(d / "char.glb"),
                "--out", str(tmp_path / "cli.mmo"), "--calib-frames", "6", "--major-iter", "1",
                "--max-iter", "5"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == f"character: 4 joints, {take[1].num_model_parameters} parameters"
    assert lines[1].startswith("markers: 6 frames × ") and lines[1].endswith("@ 30 fps")
    assert lines[2].startswith("calibrated identity: |θ_id| = ")
    assert lines[3].startswith("tracked 6 frames, median residual ")
    assert lines[-1] == f"wrote {tmp_path / 'cli.mmo'}"
    torch.set_num_threads(1)
    want = ttracking.process_marker_file(
        str(d / "clip.trc"), str(tmp_path / "call.mmo"),
        ttracking.TrackingConfig(max_iter=5, regularization=0.05),
        ttracking.CalibrationConfig(calib_frames=6, major_iter=1, max_iter=5,
                                    regularization=0.05),
        character_path=str(d / "char.glb"), device="cpu")
    np.testing.assert_array_equal(tio.load_mmo(str(tmp_path / "cli.mmo"))[0],
                                  want.motion.numpy())


def test_cli_config_file_and_outputs(take, tmp_path):
    """-c INI defaults (explicit flags win), --no-calibrate, a .bvh output
    that loads; an unknown output extension exits non-zero."""
    d, _, tchar, _ = take
    (tmp_path / "opts.ini").write_text("[defaults]\nmax-iter = 2\nsmoothing = 0\n")
    base = ["-c", str(tmp_path / "opts.ini"), "--markers", str(d / "clip.trc"),
            "--character", str(d / "char.glb"), "--no-calibrate"]
    out = _cli(base + ["--out", str(tmp_path / "o.bvh"), "--max-iter", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert _read_motion(tmp_path / "o.bvh").shape[0] == 6
    out = _cli(base + ["--out", str(tmp_path / "o.xyz")], tmp_path)
    assert out.returncode != 0 and "unknown output format" in out.stderr
    from momentum_tpu_torch.tracking.process_markers_app import parse_args

    args = parse_args(["-c", str(tmp_path / "opts.ini"), "--markers", "m", "--character", "c",
                       "--out", "o", "--max-iter", "7"])
    assert int(args.max_iter) == 7 and float(args.smoothing) == 0.0 and args.device == "cuda"


def test_cli_without_a_card_fails(take, tmp_path):
    """No --device and no card: the CLI exits non-zero with the CUDA error
    and writes nothing, rather than falling back to the CPU."""
    d, _, _, _ = take
    out = _cli(["--markers", str(d / "clip.trc"), "--character", str(d / "char.glb"),
                "--out", str(tmp_path / "x.mmo"), "--no-calibrate"], tmp_path, device=None)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert not (tmp_path / "x.mmo").exists()
