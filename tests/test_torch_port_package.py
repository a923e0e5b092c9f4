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

from momentum_tpu_torch import bridge
from momentum_tpu_torch import errors as E
from momentum_tpu_torch.camera import (
    Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)
from momentum_tpu_torch.character import limits as L, make_limits, make_skeleton
from momentum_tpu_torch.errors import (
    CenterOfMassErrorFunction, FloorErrorFunction, HeightErrorFunction, LimitErrorFunction,
    ModelParametersErrorFunction, Mppca, OrientationErrorFunction, PlaneErrorFunction,
    PositionErrorFunction, VertexNormalErrorFunction, VertexPlaneErrorFunction,
    VertexPositionErrorFunction, VertexProjectionErrorFunction)
from momentum_tpu_torch.ops import fk as fk_ops, psd, raster
from momentum_tpu_torch.testing import fixtures, workloads
from momentum_tpu_torch import tracking

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
])
def test_workloads_default_to_the_card(monkeypatch, entry, args):
    """The workload entry points build on the card unless the caller asks for
    the CPU; with no card, the default raises and names the way out instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(workloads, entry)(*args)


def _tensors(obj) -> list:
    """The tensors held by a port object and the dataclasses in it."""
    if isinstance(obj, torch.Tensor):
        return [obj]
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
    }


# F12: the public constructors a problem is built from, each with small
# arguments; called with no device they build on the card
_CONSTRUCTORS = {
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
    "create_minmax": lambda **kw: L.create_minmax(0, -0.1, 0.1, **kw),
    "create_minmax_joint": lambda **kw: L.create_minmax_joint(0, 3, -0.1, 0.1, **kw),
    "create_linear": lambda **kw: L.create_linear(1, 2, 0.5, 0.0, **kw),
    "create_linear_joint": lambda **kw: L.create_linear_joint(1, 3, 2, 3, 0.5, 0.0, **kw),
    "create_halfplane": lambda **kw: L.create_halfplane(1, 2, (0.6, 0.8), **kw),
    "create_ellipsoid": lambda **kw: L.create_ellipsoid(0, 1, np.zeros(3), np.eye(4), **kw),
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
