"""Parity of the port's camera models (momentum_tpu_torch/camera/models.py:
pinhole, OpenCV and OpenCV fisheye intrinsics, Camera) with momentum_tpu's
on the CPU: projection, the 10-step Newton unprojection, the intrinsic
parameter vectors and their projection Jacobian, look_at, resize / crop /
down- and upsample, projection_matrix, and the bridge's distortion keys.

Tolerances: pixels rtol 1e-5 / atol 1e-3 (float32 at ~1 000 px),
unprojected points atol 1e-5 (float32 at unit depth), extrinsics and
matrices 1e-6, the intrinsics Jacobian 1e-5 of max|J|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu import camera as jcam
from momentum_tpu_torch import bridge, camera as tcam

from test_torch_port_helpers import camera_to_numpy

PX = dict(rtol=1e-5, atol=1e-3)

MODELS = {
    "pinhole": dict(fx=500.0, fy=520.0, cx=320.0, cy=240.0),
    "opencv": dict(fx=900.0, fy=880.0, cx=640.0, cy=360.0,
                   k=(-0.05, 0.01, 0.002, 0.01, -0.001, 0.0005), p=(0.001, -0.0005, 0.0, 0.0)),
    "fisheye": dict(fx=500.0, fy=500.0, cx=640.0, cy=360.0, k=(0.02, -0.005, 0.001, 0.0002)),
}
CLASSES = {"pinhole": "PinholeIntrinsics", "opencv": "OpenCVIntrinsics",
           "fisheye": "OpenCVFisheyeIntrinsics"}


def _pair(model, image_size=(1280, 720)):
    kw = dict(MODELS[model])
    args = [kw.pop(k) for k in ("fx", "fy", "cx", "cy")]
    j = getattr(jcam, CLASSES[model]).create(*args, image_size=image_size, **kw)
    t = getattr(tcam, CLASSES[model]).create(*args, image_size=image_size, device="cpu", **kw)
    return j, t


def _eye_points(n=64, seed=3):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(1.0, 4.0, n)
    p[:4, 2] = [-1.0, 0.0, 1e-13, 0.5]  # behind, on and just off the eye plane
    return p


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_project_and_unproject_match_jax(model):
    j, t = _pair(model)
    p = _eye_points()
    uvz_j, valid_j = j.project(jnp.asarray(p))
    uvz_t, valid_t = t.project(torch.as_tensor(p))
    np.testing.assert_array_equal(_np(valid_t), _np(valid_j))
    np.testing.assert_allclose(_np(uvz_t), _np(uvz_j), **PX)
    front = p[:, 2] > 0.1
    uvz = np.asarray(uvz_j)[front]
    back_j = j.unproject(jnp.asarray(uvz))
    back_t = t.unproject(torch.as_tensor(uvz))
    np.testing.assert_allclose(_np(back_t), _np(back_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(back_t), p[front], rtol=0, atol=1e-4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_intrinsic_parameters_and_their_jacobian_match_jax(model):
    j, t = _pair(model)
    assert t.parameter_names() == j.parameter_names()
    assert t.num_intrinsic_parameters == j.num_intrinsic_parameters
    vec = _np(j.get_intrinsic_parameters())
    np.testing.assert_array_equal(_np(t.get_intrinsic_parameters()), vec)
    moved = vec * 1.01
    np.testing.assert_array_equal(
        _np(t.set_intrinsic_parameters(torch.as_tensor(moved)).get_intrinsic_parameters()),
        _np(j.set_intrinsic_parameters(moved).get_intrinsic_parameters()))
    with pytest.raises(ValueError):
        t.set_intrinsic_parameters(torch.zeros(len(vec) + 1))
    p = _eye_points()[4:]
    uvz_j, jac_j, _ = j.project_intrinsics_jacobian(jnp.asarray(p))
    uvz_t, jac_t, _ = t.project_intrinsics_jacobian(torch.as_tensor(p))
    np.testing.assert_allclose(_np(uvz_t), _np(uvz_j), **PX)
    jac_j = _np(jac_j)
    assert _np(jac_t).shape == jac_j.shape
    np.testing.assert_allclose(_np(jac_t), jac_j, rtol=0, atol=1e-5 * np.abs(jac_j).max())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_image_geometry_matches_jax(model):
    j, t = _pair(model)
    for name, args in (("resize", (640, 360)), ("crop", (10, 20, 600, 300)),
                       ("downsample", (2.0,)), ("upsample", (1.5,))):
        jo, to = getattr(j, name)(*args), getattr(t, name)(*args)
        assert (to.image_width, to.image_height) == (jo.image_width, jo.image_height)
        np.testing.assert_allclose(_np(to.get_intrinsic_parameters()),
                                   _np(jo.get_intrinsic_parameters()), rtol=1e-6)
    with pytest.raises(ValueError):
        _pair(model, image_size=(0, 0))[1].resize(10, 10)


@pytest.mark.parametrize("case", ["general", "up_along_view", "degenerate"])
def test_look_at_matches_jax(case):
    """look_at's eye_from_world: a general placement, a view along the up
    vector (the shortest-arc branch), and position == target (unchanged)."""
    j, t = _pair("opencv")
    jc, tc = jcam.Camera.create(j), tcam.Camera.create(t)
    pos, target, up = {"general": ((0.3, 0.4, 4.5), (0.0, 0.2, 0.0), (0.0, 1.0, 0.0)),
                       "up_along_view": ((0.0, 3.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
                       "degenerate": ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (0.0, 1.0, 0.0))}[case]
    jl, tl = jc.look_at(pos, target, up), tc.look_at(pos, target, up)
    np.testing.assert_allclose(_np(tl.eye_from_world), _np(jl.eye_from_world), rtol=0,
                               atol=1e-6)
    if case == "general":  # the target projects to the principal point's neighbourhood
        uv = _np(tl.project(torch.as_tensor(target, dtype=torch.float32))[0])
        np.testing.assert_allclose(uv[:2], [640.0, 360.0], atol=1.0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_camera_unproject_projection_matrix_and_bridge(model):
    """Camera.unproject in world space, projection_matrix, and the bridge
    carrying the model's distortion across, against JAX's."""
    j, _ = _pair(model)
    jc = jcam.Camera.create(j).look_at((2.0, 1.0, 5.0), (0.0, 0.5, 0.0))
    tc = bridge.camera_from_numpy(camera_to_numpy(jc), device="cpu")
    assert type(tc.intrinsics).__name__ == CLASSES[model]
    world = np.random.default_rng(5).uniform(-1, 1, (32, 3)).astype(np.float32)
    uvz_j = jc.project(jnp.asarray(world))[0]
    np.testing.assert_allclose(_np(tc.project(torch.as_tensor(world))[0]), _np(uvz_j), **PX)
    np.testing.assert_allclose(_np(tc.unproject(torch.as_tensor(_np(uvz_j)))),
                               _np(jc.unproject(uvz_j)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tc.projection_matrix()), _np(jc.projection_matrix()),
                               rtol=1e-6, atol=1e-4)
    clone = tc.clone()
    assert clone is not tc and torch.equal(clone.eye_from_world, tc.eye_from_world)
    jac = tc.project_intrinsics_jacobian(torch.as_tensor(world))[1]
    want = jc.project_intrinsics_jacobian(jnp.asarray(world))[1]
    np.testing.assert_allclose(_np(jac), _np(want), rtol=0, atol=1e-5 * np.abs(_np(want)).max())
