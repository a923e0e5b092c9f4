"""Package-level properties of the port: it imports no jax, and on CPU
tensors its kernel wrappers take their plain PyTorch versions without
counting a launch."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from momentum_tpu_torch import bridge, compat
from momentum_tpu_torch import errors as E
from momentum_tpu_torch.camera import (
    Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)
from momentum_tpu_torch.character import (
    limits as L, make_empty_limits, make_identity_transform, make_limits, make_skeleton)
from momentum_tpu_torch.math.covariance import LowRankCovarianceMatrix
from momentum_tpu_torch.utils.random import GlobalRandom
from momentum_tpu_torch.errors import (
    CenterOfMassErrorFunction, FloorErrorFunction, HeightErrorFunction, LimitErrorFunction,
    ModelParametersErrorFunction, Mppca, OrientationErrorFunction, PlaneErrorFunction,
    PositionErrorFunction, VertexNormalErrorFunction, VertexPlaneErrorFunction,
    VertexPositionErrorFunction, VertexProjectionErrorFunction)
from momentum_tpu_torch.ops import fk as fk_ops, psd, raster
from momentum_tpu_torch.testing import fixtures, workloads
from momentum_tpu_torch import rasterizer as R, tracking
from momentum_tpu_torch.gui import auto_camera
from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or momentum_tpu (the test process itself has jax loaded,
    hence the subprocess)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import momentum_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'momentum_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'momentum_tpu'))\n"
        "assert not bad, bad\n"
        "new = {'momentum_tpu_torch.errors.limit', 'momentum_tpu_torch.errors.pose_prior',\n"
        "       'momentum_tpu_torch.solver.ik', 'momentum_tpu_torch.ops.chol',\n"
        "       'momentum_tpu_torch.errors.vertex', 'momentum_tpu_torch.character.blend_shape',\n"
        "       'momentum_tpu_torch.character.pose_shape', 'momentum_tpu_torch.character.utility',\n"
        "       'momentum_tpu_torch.sequence.block_tridiag', 'momentum_tpu_torch.sequence.errors',\n"
        "       'momentum_tpu_torch.sequence.solver_function', 'momentum_tpu_torch.sequence.solver'}\n"
        "new |= {'momentum_tpu_torch.errors.geometric', 'momentum_tpu_torch.errors.body',\n"
        "       'momentum_tpu_torch.tracking', 'momentum_tpu_torch.tracking.tracker',\n"
        "       'momentum_tpu_torch.tracking.cmu', 'momentum_tpu_torch.tracking.config',\n"
        "       'momentum_tpu_torch.tracking.gap_fill',\n"
        "       'momentum_tpu_torch.tracking.tracker_utils',\n"
        "       'momentum_tpu_torch.tracking.process_markers'}\n"
        "new |= {'momentum_tpu_torch.errors.joint_pair', 'momentum_tpu_torch.errors.state',\n"
        "       'momentum_tpu_torch.errors.collision',\n"
        "       'momentum_tpu_torch.errors.camera_projection',\n"
        "       'momentum_tpu_torch.math.geometry'}\n"
        "new |= {'momentum_tpu_torch.solver.diff_ik', 'momentum_tpu_torch.solver.solvers',\n"
        "        'momentum_tpu_torch.torch_interop'}\n"
        "new |= {'momentum_tpu_torch.errors.skinned_locator', 'momentum_tpu_torch.math.euler',\n"
        "        'momentum_tpu_torch.tracking.glove_utils'}\n"
        "new |= {'momentum_tpu_torch.rasterizer.materials', 'momentum_tpu_torch.rasterizer.overlays',\n"
        "        'momentum_tpu_torch.rasterizer.primitives', 'momentum_tpu_torch.rasterizer.text',\n"
        "        'momentum_tpu_torch.character.character_state', 'momentum_tpu_torch.gui',\n"
        "        'momentum_tpu_torch.gui.viewer', 'momentum_tpu_torch.gui.gif',\n"
        "        'momentum_tpu_torch.gui.rerun_vis', 'momentum_tpu_torch.gui.viser_vis'}\n"
        "new |= {'momentum_tpu_torch.axel', 'momentum_tpu_torch.axel.sdf',\n"
        "        'momentum_tpu_torch.axel.queries', 'momentum_tpu_torch.axel.grid',\n"
        "        'momentum_tpu_torch.axel.ccd', 'momentum_tpu_torch.axel.hole_filling',\n"
        "        'momentum_tpu_torch.axel.sdf_io', 'momentum_tpu_torch.errors.sdf',\n"
        "        'momentum_tpu_torch.math.mesh_ops', 'momentum_tpu_torch.math.support_polygon',\n"
        "        'momentum_tpu_torch.character.support_contacts'}\n"
        "new |= {'momentum_tpu_torch.compat', 'momentum_tpu_torch.utils',\n"
        "        'momentum_tpu_torch.utils.logging', 'momentum_tpu_torch.utils.progress',\n"
        "        'momentum_tpu_torch.utils.profiling', 'momentum_tpu_torch.utils.random',\n"
        "        'momentum_tpu_torch.math.trs', 'momentum_tpu_torch.math.covariance',\n"
        "        'momentum_tpu_torch.math.coordinate_system',\n"
        "        'momentum_tpu_torch.character.inverse_fk',\n"
        "        'momentum_tpu_torch.character.transform_pose',\n"
        "        'momentum_tpu_torch.character.texture_classification'}\n"
        "new |= {'momentum_tpu_torch.parallel', 'momentum_tpu_torch.parallel.batch',\n"
        "        'momentum_tpu_torch.parallel.collectives', 'momentum_tpu_torch.sequence.sharded',\n"
        "        'momentum_tpu_torch.testing.distributed'}\n"
        "new |= {f'momentum_tpu_torch.io.{m}' for m in ('_physical', 'limits_json', 'locators',\n"
        "        'model_definition', 'legacy_json', 'gltf', 'gltf_builder', 'pose_prior',\n"
        "        'shape', 'markers', 'motion', 'obj', 'character_io')} | {'momentum_tpu_torch.io'}\n"
        "new |= {f'momentum_tpu_torch.io.{m}' for m in ('bvh', 'urdf', 'fbx', 'fbx_writer',\n"
        "        'fbx_builder', 'usdc_crate', 'usd')}\n"
        "new |= {'momentum_tpu_torch.tracking.app_utils',\n"
        "        'momentum_tpu_torch.tracking.process_markers_app'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "assert len(names) >= 30, names\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_import_sets_full_f32_matmul_precision():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions and leave their
    launch counters at 0, through a whole small solve too."""
    char, ef0, targets, x0 = workloads.build_fullbody_ik_problem(8, seed=1, device="cpu")
    local = torch.randn(8, char.num_joints, 8)
    np.testing.assert_array_equal(fk_ops.fk_global(char.skeleton, local).numpy(),
                                  fk_ops.fk_global_plain(char.skeleton, local).numpy())
    res = workloads.make_solve_batch(char, ef0, 8)(targets, x0)
    assert torch.isfinite(res.error).all()
    assert fk_ops.launches == 0
    assert psd.launches == 0


def test_cpu_render_launches_no_kernel():
    """A frame of the render clip on CPU tensors takes the plain rasterizer
    and counts no K1, K4a or K4b launch."""
    char, motion, cam = workloads.build_render_clip(frames=1, image_height=48,
                                                    image_width=64, device="cpu")
    before = dict(raster.launches)
    imgs = workloads.make_render_clip(char, cam, width=32, height=24,
                                      shadow_resolution=32)(motion)
    assert imgs.shape == (1, 24, 32, 3) and bool((imgs > 0).any())
    assert raster.launches == before and fk_ops.launches == 0


def test_cpu_scene_launches_no_kernel():
    """A frame of config 7p's Phong scene and of its viewer on CPU tensors
    takes the plain rasterizers: no K1, K4a or K4b launch."""
    from momentum_tpu_torch.gui import render_motion

    char, motion, cam = workloads.build_scene_clip(1, device="cpu")
    before = dict(raster.launches)
    imgs = workloads.make_scene_render(char, cam)(motion)
    views = render_motion(char, motion, 640, 480, camera=cam, ground=True,
                          skeleton_overlay=True)
    assert imgs.shape == views.shape == (1, 480, 640, 3)
    assert raster.launches == before and fk_ops.launches == 0


def test_cpu_fullstack_launches_no_kernel():
    """The full-stack GN solve on CPU tensors takes the plain versions: no
    K1 or K2+K3 launch (K5a and K5b reach K2+K3's kernel)."""
    char, efs, targets, q, x0 = workloads.build_fullstack_problem(8, seed=1, device="cpu")
    before = (fk_ops.launches, psd.launches)
    params, energy, _ = workloads.make_fullstack_solve(char, efs, 8)(targets, q, x0)
    assert params.shape == x0.shape and bool(torch.isfinite(energy).all())
    assert float(energy.max()) < 1e-3
    assert (fk_ops.launches, psd.launches) == before


@pytest.mark.parametrize("entry,args", [
    ("build_fullbody_ik_problem", (8,)),
    ("build_fullstack_problem", (8,)),
    ("build_render_clip", (1,)),
    ("build_fullstack_frame", ()),
    ("build_vertex_fit_problem", (4,)),
    ("build_sequence_problem", (4,)),
    ("build_tracking_clip", (4,)),
    ("build_catalog_ik_problem", (4,)),
    ("catalog_character", ()),
    ("build_diff_ik_problem", (4,)),
    ("build_vertex_extra_problem", (4,)),
    ("build_skinned_ik_problem", (4,)),
    ("build_glove_clip", (4,)),
    ("glove_character", ()),
    ("build_scene_clip", (1,)),
    ("build_sdf_collision_problem", (4,)),
    ("build_sdf_sequence_problem", (4,)),
])
def test_workloads_default_to_the_card(monkeypatch, entry, args):
    """The workload entry points build on the card unless the caller asks for
    the CPU; with no card, the default raises and names the way out instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(workloads, entry)(*args)


def _tensors(obj) -> list:
    """The tensors held by a port object, the dataclasses and the tuples in
    it."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.Generator):
        return [torch.empty(0, device=obj.device)]
    if isinstance(obj, tuple):
        return [t for o in obj for t in _tensors(o)]
    if not dataclasses.is_dataclass(obj):
        return []
    return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]


def _bridge_inputs():
    """A small numpy dict for each bridge entry point: the fixture rig's
    arrays (taken from a CPU build) and one constraint of each module."""
    char = fixtures.create_fullbody_character(device="cpu")
    rig = {"joint_parent": char.skeleton.joint_parent, "pre_rotation": char.skeleton.pre_rotation,
           "translation_offset": char.skeleton.translation_offset,
           "transform": char.parameter_transform.transform,
           "offsets": char.parameter_transform.offsets}
    rig.update({k: getattr(char.limits, k) for k in bridge._LIMIT_KEYS})
    rig = {k: v.numpy() for k, v in rig.items()}
    one = dict(cweight=np.ones(1, np.float32), weight=np.float32(1.0))
    return {
        "character_from_numpy": rig,
        "covariance_from_numpy": dict(a=np.ones((1, 3), np.float32), sigma=np.float32(0.5)),
        "camera_from_numpy": dict(fx=50.0, fy=50.0, cx=16.0, cy=16.0, image_width=32,
                                  image_height=32,
                                  eye_from_world=np.asarray([0, 0, 5, 0, 0, 0, 1, 1], np.float32)),
        "position_error_from_numpy": dict(parent=np.zeros(1, np.int32),
                                          offset=np.zeros((1, 3), np.float32),
                                          target=np.zeros((1, 3), np.float32), **one),
        "orientation_error_from_numpy": dict(parent=np.zeros(1, np.int32),
                                             offset=np.asarray([[0, 0, 0, 1]], np.float32),
                                             target=np.asarray([[0, 0, 0, 1]], np.float32), **one),
        "limit_error_from_numpy": dict(weight=np.float32(1.0)),
        "pose_prior_from_numpy": dict(mu=np.zeros((1, 2), np.float32),
                                      cinv=np.eye(2, dtype=np.float32)[None],
                                      l=np.eye(2, dtype=np.float32)[None],
                                      rpre=np.zeros(1, np.float32),
                                      param_index=np.arange(2), weight=np.float32(1.0)),
        "vertex_position_error_from_numpy": dict(vertex_index=np.zeros(1, np.int32),
                                                 target=np.zeros((1, 3), np.float32), **one),
        "vertex_plane_error_from_numpy": dict(vertex_index=np.zeros(1, np.int32),
                                              point=np.zeros((1, 3), np.float32),
                                              normal=np.asarray([[0, 0, 1]], np.float32),
                                              above=np.asarray(True), **one),
        "vertex_normal_error_from_numpy": dict(vertex_index=np.zeros(1, np.int32),
                                               target_position=np.zeros((1, 3), np.float32),
                                               target_normal=np.asarray([[0, 0, 1]], np.float32),
                                               source_normal_weight=np.asarray(0.25), **one),
        "vertex_projection_error_from_numpy": dict(vertex_index=np.zeros(1, np.int32),
                                                   projection=np.zeros((1, 3, 4), np.float32),
                                                   target=np.zeros((1, 2), np.float32),
                                                   near_clip=np.asarray(0.5), **one),
        "phong_material_from_numpy": dict(diffuse_color=np.ones(3), specular_color=np.zeros(3),
                                          specular_exponent=np.asarray(10.0),
                                          emissive_color=np.zeros(3)),
        "lights_from_numpy": [dict(position=np.zeros(3), color=np.ones(3), type=0)],
        "sdf_from_numpy": _SDF,
        "triangle_grid_from_numpy": dict(cells=np.full((2, 2, 2, 1), -1, np.int32),
                                         origin=np.zeros(3, np.float32),
                                         cell_size=np.float32(0.5), resolution=2),
        **{f"{name}_from_numpy": dict(
            {f"sdf_{k}": v for k, v in _SDF.items()}, vertex_index=np.zeros(1, np.int32),
            target_distance=np.zeros(1, np.float32), sdf_parent=-1, **one)
           for name in ("vertex_sdf_error", "sdf_collision_error",
                        "sdf_collision_sequence_error")},
    }


_SDF = dict(origin=np.zeros(3, np.float32), spacing=np.ones(3, np.float32),
            values=np.zeros((2, 2, 2), np.float32))
_TETRA = (np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
          np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32))


def _load_sdfs(load, **kw):
    """A field written to a file and loaded again by `load`, as a tuple of
    fields."""
    import tempfile

    from momentum_tpu_torch.axel import SignedDistanceField, sdf_io

    sdf = SignedDistanceField.create(**_SDF, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "f.msgpack"
        if load is sdf_io.load_sdf_from_msgpack:
            sdf_io.save_sdf_to_msgpack(sdf, path)
            return (load(path, **kw),)
        sdf_io.save_sdfs_to_msgpack({"a": sdf, "b": (sdf, "root")}, path)
        return tuple(f for f, _ in load(path, **kw).values())


def _permutation_matrix(**kw):
    from momentum_tpu_torch.math.coordinate_system import (
        CoordinateSystem, permutation_matrix)

    return permutation_matrix(CoordinateSystem(), CoordinateSystem(up="z"), **kw)


def _in_file(suffix: str, data: bytes, load):
    """`load` of a file holding `data`."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / f"f{suffix}"
        path.write_bytes(data)
        return load(str(path))


def _io_loaders() -> dict:
    """The file layer's loaders, each on a small file the port writes from
    a CPU build of the test rig."""
    from momentum_tpu_torch import io as tio
    from momentum_tpu_torch.character import BlendShape, Character
    from momentum_tpu_torch.errors import Mppca
    from momentum_tpu_torch.io import gltf, legacy_json, pose_prior, shape

    rig = fixtures.create_test_character(4, device="cpu")
    motion = torch.zeros(2, rig.num_model_parameters)
    glb = gltf._character_glb_bytes(rig, motion=motion)
    text = legacy_json.legacy_json_text(rig)
    prior = pose_prior.mppca_to_bytes(Mppca.from_components(
        pi=[1.0], mu=np.zeros((1, 2)), w_list=[np.ones((2, 1))], sigma2=[1.0], device="cpu"))
    basis = BlendShape(base_shape=torch.zeros(3, 3), shape_vectors=torch.ones(2, 3, 3))

    def blend_bytes():
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            shape.save_blend_shape(pathlib.Path(tmp) / "b.bin", basis)
            return (pathlib.Path(tmp) / "b.bin").read_bytes()

    raw = tio.RawMarkerData(np.zeros((2, 3, 3), np.float32), np.zeros((2, 3), bool),
                            ["a", "b", "c"], 120.0)
    from momentum_tpu_torch.io import fbx_writer, usd

    def written(suffix, save):
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            save(str(pathlib.Path(tmp) / f"f{suffix}"))
            return (pathlib.Path(tmp) / f"f{suffix}").read_bytes()

    fbx_bytes = written(".fbx", lambda p: fbx_writer.save_fbx(p, rig, motion=motion))
    usda_bytes = written(".usda", lambda p: usd.save_usd(p, rig, motion=motion))
    bvh_bytes = written(".bvh", lambda p: tio.save_bvh(
        p, rig, torch.zeros(2, rig.skeleton.num_joint_parameters)))
    urdf = ('<robot name="r"><link name="a"/><link name="b"/><joint name="j" type="revolute">'
            '<parent link="a"/><child link="b"/><axis xyz="0 0 1"/>'
            '<limit lower="-1" upper="1"/></joint></robot>')

    def identity_load(**kw):
        from momentum_tpu_torch.tracking import app_utils

        return _in_file(".fbx", fbx_bytes, lambda p: app_utils.load_character_with_identity(
            p, **kw))

    def cli(**kw):
        import tempfile

        from momentum_tpu_torch.tracking import process_markers_app

        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            (tmp / "c.glb").write_bytes(glb)
            names = list(rig.locators.names)
            tio.save_trc(str(tmp / "m.trc"), tio.RawMarkerData(
                np.ones((2, len(names), 3), np.float32), np.zeros((2, len(names)), bool),
                names, 30.0))
            args = ["--markers", str(tmp / "m.trc"), "--character", str(tmp / "c.glb"),
                    "--out", str(tmp / "o.mmo"), "--no-calibrate", "--max-iter", "1"]
            if "device" in kw:
                args += ["--device", str(kw["device"])]
            process_markers_app.main(args)
            return torch.as_tensor(tio.load_mmo(str(tmp / "o.mmo"))[0])

    return {
        "load_fbx": lambda **kw: tio.load_fbx(fbx_bytes, **kw),
        "load_fbx_with_motion": lambda **kw: tio.load_fbx_with_motion(fbx_bytes, **kw),
        "Character.load_fbx_from_bytes": lambda **kw: Character.load_fbx_from_bytes(
            fbx_bytes, **kw),
        "Character.load_fbx_with_motion_from_bytes":
            lambda **kw: Character.load_fbx_with_motion_from_bytes(fbx_bytes, **kw),
        "load_usd": lambda **kw: _in_file(".usda", usda_bytes, lambda p: tio.load_usd(p, **kw)),
        "load_usda": lambda **kw: _in_file(".usda", usda_bytes,
                                           lambda p: tio.load_usda(p, **kw)),
        "usd.load_character_from_bytes": lambda **kw: usd.load_character_from_bytes(
            usda_bytes, **kw),
        "usd.load_character_with_motion_from_bytes":
            lambda **kw: usd.load_character_with_motion_from_bytes(usda_bytes, **kw),
        "usd.load_character_with_skel_states_from_bytes":
            lambda **kw: usd.load_character_with_skel_states_from_bytes(usda_bytes, **kw),
        "load_urdf": lambda **kw: tio.load_urdf(urdf, **kw),
        "Character.load_urdf": lambda **kw: _in_file(".urdf", urdf.encode(),
                                                     lambda p: Character.load_urdf(p, **kw)),
        "load_bvh": lambda **kw: _in_file(".bvh", bvh_bytes, lambda p: tio.load_bvh(p, **kw)),
        "FbxBuilder.add_animated_mesh": lambda **kw: tio.FbxBuilder().add_animated_mesh(
            rig.mesh, **kw)._entries[0]["character"],
        "app_utils.load_character_with_identity": identity_load,
        "process_markers_app.main": cli,
        "load_character_glb": lambda **kw: tio.load_character_glb(glb, **kw),
        "load_character_glb_with_skel_states":
            lambda **kw: gltf.load_character_glb_with_skel_states(glb, **kw),
        "load_all_characters_glb": lambda **kw: tuple(tio.load_all_characters_glb(glb, **kw)),
        "Character.load_gltf_from_bytes": lambda **kw: Character.load_gltf_from_bytes(glb, **kw),
        "Character.load_gltf_with_skel_states_from_bytes":
            lambda **kw: Character.load_gltf_with_skel_states_from_bytes(glb, **kw),
        "load_legacy_json": lambda **kw: tio.load_legacy_json(text, **kw),
        "Character.load_legacy_json_from_string":
            lambda **kw: Character.load_legacy_json_from_string(text, **kw),
        "load_full_character": lambda **kw: _in_file(
            ".json", text.encode(), lambda p: tio.load_full_character(p, **kw)),
        "load_mppca": lambda **kw: _in_file(".mppca", prior,
                                            lambda p: tio.load_mppca(p, **kw)),
        "Mppca.from_bytes": lambda **kw: Mppca.from_bytes(prior, **kw),
        "load_blend_shape": lambda **kw: _in_file(
            ".bin", blend_bytes(), lambda p: shape.load_blend_shape(p, **kw)),
        "load_blend_shape_base": lambda **kw: _in_file(
            ".bin", blend_bytes(), lambda p: shape.load_blend_shape_base(p, **kw)),
        "RawMarkerData.to_marker_sequence": lambda **kw: raw.to_marker_sequence(**kw),
        "GltfBuilder.add_mesh": lambda **kw: tio.GltfBuilder().add_mesh(
            np.eye(3), [[0, 1, 2]], **kw)._entries[0]["character"],
    }


def _sdf_constructors() -> dict:
    from momentum_tpu_torch import axel
    from momentum_tpu_torch.math.support_polygon import SupportPlane
    from momentum_tpu_torch.sequence import SdfCollisionSequenceErrorFunction

    field = axel.SignedDistanceField.create(**_SDF, device="cpu")
    return {
        "SignedDistanceField.create": lambda **kw: axel.SignedDistanceField.create(**_SDF, **kw),
        "mesh_to_sdf": lambda **kw: axel.mesh_to_sdf(*_TETRA, (4, 4, 4), **kw),
        "build_triangle_grid": lambda **kw: axel.build_triangle_grid(*_TETRA, 2, **kw),
        "load_sdf_from_msgpack": lambda **kw: _load_sdfs(axel.load_sdf_from_msgpack, **kw),
        "load_sdfs_from_msgpack": lambda **kw: _load_sdfs(axel.load_sdfs_from_msgpack, **kw),
        "SupportPlane.create": lambda **kw: SupportPlane.create(**kw),
        "VertexSdfErrorFunction.create": lambda **kw: E.VertexSdfErrorFunction.create(
            field, [0], **kw),
        "SdfCollisionErrorFunction.create": lambda **kw: E.SdfCollisionErrorFunction.create(
            field, [0], **kw),
        "SdfCollisionSequenceErrorFunction.create":
            lambda **kw: SdfCollisionSequenceErrorFunction.create(field, [0], **kw),
    }


# F12: the public constructors a problem is built from, each with small
# arguments; called with no device they build on the card
_CONSTRUCTORS = {
    **_sdf_constructors(),
    **_io_loaders(),
    "make_skeleton": lambda **kw: make_skeleton([-1, 0], **kw),
    "make_limits": lambda **kw: make_limits(minmax=[(0, -0.1, 0.1, 1.0)], **kw),
    "PositionErrorFunction.create": lambda **kw: PositionErrorFunction.create(
        [0], np.zeros((1, 3)), np.zeros((1, 3)), **kw),
    "OrientationErrorFunction.create": lambda **kw: OrientationErrorFunction.create(
        [0], np.asarray([[0, 0, 0, 1]], np.float32), **kw),
    "LimitErrorFunction.create": lambda **kw: LimitErrorFunction.create(**kw),
    "Mppca.from_components": lambda **kw: Mppca.from_components(
        pi=[1.0], mu=np.zeros((1, 2)), w_list=[np.ones((2, 1))], sigma2=[1.0], **kw),
    "VertexPositionErrorFunction.create": lambda **kw: VertexPositionErrorFunction.create(
        [0], np.zeros((1, 3)), **kw),
    "VertexPlaneErrorFunction.create": lambda **kw: VertexPlaneErrorFunction.create(
        [0], np.zeros((1, 3)), np.asarray([[0, 0, 1]]), **kw),
    "VertexNormalErrorFunction.create": lambda **kw: VertexNormalErrorFunction.create(
        [0], np.zeros((1, 3)), np.asarray([[0, 0, 1]]), **kw),
    "VertexProjectionErrorFunction.create": lambda **kw: VertexProjectionErrorFunction.create(
        [0], np.zeros((1, 3, 4)), np.zeros((1, 2)), **kw),
    "PinholeIntrinsics.create": lambda **kw: PinholeIntrinsics.create(
        50.0, 50.0, 16.0, 16.0, image_size=(32, 32), **kw),
    "ModelParametersErrorFunction.create": lambda **kw: ModelParametersErrorFunction.create(
        np.zeros(2), **kw),
    "PlaneErrorFunction.create": lambda **kw: PlaneErrorFunction.create(
        [0], np.zeros((1, 3)), np.asarray([[0, 1, 0]]), [0.0], **kw),
    "FloorErrorFunction.create": lambda **kw: FloorErrorFunction.create([0, 1], **kw),
    "CenterOfMassErrorFunction.create": lambda **kw: CenterOfMassErrorFunction.create(
        [0], [1.0], np.zeros(3), **kw),
    "HeightErrorFunction.create": lambda **kw: HeightErrorFunction.create(1.7, **kw),
    "CenterOfMassErrorFunction.from_physical_properties":
        lambda **kw: CenterOfMassErrorFunction.from_physical_properties(
            workloads.utility_character(device="cpu"), np.zeros(3), **kw),
    "build_utility_problem": lambda **kw: workloads.build_utility_problem(2, **kw),
    "utility_character": lambda **kw: workloads.utility_character(**kw),
    "LowRankCovarianceMatrix.create": lambda **kw: LowRankCovarianceMatrix.create(
        0.5, np.ones((1, 3)), **kw),
    "make_identity_transform": lambda **kw: make_identity_transform(2, **kw),
    "permutation_matrix": lambda **kw: _permutation_matrix(**kw),
    "make_empty_limits": lambda **kw: make_empty_limits(**kw),
    "GlobalRandom.key": lambda **kw: GlobalRandom(3).key(**kw),
    "compat.find_closest_points": lambda **kw: compat.find_closest_points(
        np.zeros((2, 3)), np.ones((3, 3)), **kw),
    "compat.find_closest_points_on_mesh": lambda **kw: compat.find_closest_points_on_mesh(
        np.zeros((2, 3)), np.eye(3), np.asarray([[0, 1, 2]]), **kw),
    "compat.compute_vertex_normals": lambda **kw: compat.compute_vertex_normals(
        np.eye(3), np.asarray([[0, 1, 2]]), **kw),
    **{f"{name}.create": (lambda name: lambda **kw: getattr(E, name).create(
        [0], np.zeros((1, 3)), np.asarray([[0, 0, 1]]), np.ones((1, 3)), **kw))(name)
       for name in ("AimDistErrorFunction", "AimDirErrorFunction")},
    **{f"{name}.create": (lambda name: lambda **kw: getattr(E, name).create(
        [0], np.asarray([[0, 1, 0]]), np.asarray([[0, 1, 0]]), **kw))(name)
       for name in ("FixedAxisDiffErrorFunction", "FixedAxisCosErrorFunction",
                    "FixedAxisAngleErrorFunction")},
    "NormalErrorFunction.create": lambda **kw: E.NormalErrorFunction.create(
        [0], np.zeros((1, 3)), np.asarray([[0, 1, 0]]), np.zeros((1, 3)), **kw),
    "DistanceErrorFunction.create": lambda **kw: E.DistanceErrorFunction.create(
        [0], np.zeros((1, 3)), np.ones((1, 3)), [1.0], **kw),
    "ProjectionErrorFunction.create": lambda **kw: E.ProjectionErrorFunction.create(
        [0], np.zeros((1, 3)), np.zeros((1, 3, 4)), np.zeros((1, 2)), **kw),
    **{f"{name}.create": (lambda name: lambda **kw: getattr(E, name).create(
        [1], [0], np.zeros((1, 3)), np.zeros((1, 3)),
        np.zeros((1, 3) if "Position" in name else 1), **kw))(name)
       for name in ("JointToJointPositionErrorFunction", "JointToJointDistanceErrorFunction")},
    "JointToJointOrientationErrorFunction.create":
        lambda **kw: E.JointToJointOrientationErrorFunction.create(
            [1], [0], np.asarray([[0, 0, 0, 1]]), **kw),
    "StateErrorFunction.create": lambda **kw: E.StateErrorFunction.create(
        np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (2, 1)), **kw),
    "CollisionErrorFunction.create": lambda **kw: E.CollisionErrorFunction.create(
        fixtures.create_test_character(4, device="cpu"), **kw),
    "PlaneCollisionErrorFunction.create": lambda **kw: E.PlaneCollisionErrorFunction.create(
        fixtures.create_test_character(4, device="cpu"), **kw),
    "CameraProjectionErrorFunction.create":
        lambda **kw: E.CameraProjectionErrorFunction.create(
            Camera.create(PinholeIntrinsics.create(50.0, 50.0, 16.0, 16.0, device="cpu")),
            [0], np.zeros((1, 3)), np.zeros((1, 2)), **kw),
    "OpenCVIntrinsics.create": lambda **kw: OpenCVIntrinsics.create(
        50.0, 50.0, 16.0, 16.0, k=(0.1, 0, 0, 0, 0, 0), **kw),
    "OpenCVFisheyeIntrinsics.create": lambda **kw: OpenCVFisheyeIntrinsics.create(
        50.0, 50.0, 16.0, 16.0, k=(0.1, 0, 0, 0), **kw),
    "PointTriangleVertexErrorFunction.create":
        lambda **kw: E.PointTriangleVertexErrorFunction.create(
            [0], [[1, 2, 3]], [[0.2, 0.3, 0.5]], **kw),
    "VertexVertexDistanceErrorFunction.create":
        lambda **kw: E.VertexVertexDistanceErrorFunction.create([0], [1], [0.5], **kw),
    "CameraVertexProjectionErrorFunction.create":
        lambda **kw: E.CameraVertexProjectionErrorFunction.create(
            Camera.create(PinholeIntrinsics.create(50.0, 50.0, 16.0, 16.0, device="cpu")),
            [0], np.zeros((1, 2)), **kw),
    "SkinnedLocatorErrorFunction.create": lambda **kw: E.SkinnedLocatorErrorFunction.create(
        [[0, 1]], [[0.5, 0.5]], np.zeros((1, 3)), np.zeros((1, 3)), **kw),
    "SkinnedLocatorTriangleErrorFunction.create":
        lambda **kw: E.SkinnedLocatorTriangleErrorFunction.create(
            [[0, 1]], [[0.5, 0.5]], np.zeros((1, 3)), [[0, 1, 2]], [[0.2, 0.3, 0.5]],
            candidates=[[0, 1]], faces=np.asarray([[0, 1, 2], [1, 2, 3]]), **kw),
    "create_minmax": lambda **kw: L.create_minmax(0, -0.1, 0.1, **kw),
    "create_minmax_joint": lambda **kw: L.create_minmax_joint(0, 3, -0.1, 0.1, **kw),
    "create_linear": lambda **kw: L.create_linear(1, 2, 0.5, 0.0, **kw),
    "create_linear_joint": lambda **kw: L.create_linear_joint(1, 3, 2, 3, 0.5, 0.0, **kw),
    "create_halfplane": lambda **kw: L.create_halfplane(1, 2, (0.6, 0.8), **kw),
    "create_ellipsoid": lambda **kw: L.create_ellipsoid(0, 1, np.zeros(3), np.eye(4), **kw),
    # the renderer's builders from sizes and values
    **{name: (lambda name: lambda **kw: getattr(R, name)(4, 3, **kw))(name)
       for name in ("create_z_buffer", "create_rgb_buffer", "create_index_buffer")},
    "PhongMaterial.create": lambda **kw: R.PhongMaterial.create(**kw),
    "point_light": lambda **kw: R.point_light((0, 0, 1), **kw),
    "directional_light": lambda **kw: R.directional_light((0, -1, 0), **kw),
    "ambient_light": lambda **kw: R.ambient_light(**kw),
    "default_lights": lambda **kw: R.default_lights((0.0, 0.0, 1.0), **kw),
    "create_shadow_projection_matrix": lambda **kw: R.create_shadow_projection_matrix(
        (0.3, -1.0, 0.2), **kw),
    "create_camera_for_hand": lambda **kw: R.create_camera_for_hand(np.eye(4), 48, 64, **kw),
    "auto_camera": lambda **kw: auto_camera(np.eye(3), 64, 48, **kw),
}


@pytest.mark.parametrize("entry", sorted(_bridge_inputs()) + [
    "create_fullbody_character", "create_test_character", "create_cmu_character"]
    + sorted(_CONSTRUCTORS))
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """F10, F12: the bridge, the fixtures and the public constructors build
    on the card unless the caller asks for the CPU; with no card the default
    raises and names the way out, and device='cpu' builds there."""
    if entry in ("create_fullbody_character", "create_test_character"):
        make = getattr(fixtures, entry)
    elif entry == "create_cmu_character":
        make = tracking.create_cmu_character
    elif entry in _CONSTRUCTORS:
        make = _CONSTRUCTORS[entry]
    else:
        inputs = _bridge_inputs()[entry]
        make = lambda **kw: getattr(bridge, entry)(inputs, **kw)  # noqa: E731
    leaves = _tensors(make(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_bridge_carries_parameter_sets():
    """character_from_numpy carries the parameter transform's names and
    named parameter sets across (config 5 reads parameter_sets["scaling"])."""
    char = fixtures.create_fullbody_character(device="cpu")
    assert char.parameter_transform.parameter_sets == {"scaling": (6,)}
    d = {k: v for k, v in _bridge_inputs()["character_from_numpy"].items()}
    d.update(parameter_names=char.parameter_transform.names,
             parameter_sets={"scaling": np.asarray([6])})
    out = bridge.character_from_numpy(d, device="cpu").parameter_transform
    assert out.parameter_sets == {"scaling": (6,)}
    assert out.names == char.parameter_transform.names
