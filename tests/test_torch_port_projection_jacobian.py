"""The analytic Jacobian of the port's CameraProjectionErrorFunction
against forward mode, on the CMU rig (portbench/rigs/cmu41.json: 23 joints,
73 parameters, 41 locators, metres).

`jacobian_model` (K6's projection form; its plain version on the CPU) and
`jacobian` (joint-space, chained through the parameter transform) are held
to the port's forward mode (solver/gauss_newton.py::ad_jacobian) of the same
rows, for pinhole and OpenCV intrinsics (all six k and p1, p2), points
behind the near clip, zero confidences, a robust loss, batched and
unbatched poses, in float64 and float32. Tolerances, of max|J|:
  float64  1e-10: the same sums in another order, ~1e-16 each;
  float32  2e-6: FK, the merged factors and the chain through R in float32
           against forward mode's own float32 chain (seen ~5e-7), ~20 ulps.
The grouped evaluation of K cameras is held to the modules one by one, and
one case holds the port's J to jax.jacfwd of momentum_tpu's module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from momentum_tpu_torch.camera.models import (
    Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)
from momentum_tpu_torch.errors import CameraProjectionErrorFunction
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.solver import SkeletonSolverFunction
from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context
from momentum_tpu_torch.solver.gauss_newton import ad_jacobian
from momentum_tpu_torch.solver.skeleton_solver_function import _module_groups

from test_torch_port_helpers import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 2e-6}
B = 3


def _as(obj, dtype):
    """obj with every float32 tensor of it (dataclasses and tuples walked) in dtype."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.dtype == torch.float32 else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _as(getattr(obj, f.name), dtype)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_as(v, dtype) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as(v, dtype) for v in obj)
    return obj


@pytest.fixture(scope="module")
def cmu():
    from portbench.rig import load_rig, port_character

    return port_character(load_rig("portbench/rigs/cmu41.json"), "cpu")


def _intrinsics(kind):
    size = (1920, 1080)
    if kind == "pinhole":
        return PinholeIntrinsics.create(1400.0, 1380.0, 955.0, 545.0, image_size=size,
                                        device="cpu")
    if kind == "opencv":
        return OpenCVIntrinsics.create(1400.0, 1380.0, 955.0, 545.0,
                                       k=(-0.21, 0.11, -0.015, 0.04, -0.02, 0.01),
                                       p=(8e-4, -6e-4), image_size=size, device="cpu")
    return OpenCVFisheyeIntrinsics.create(600.0, 600.0, 960.0, 540.0,
                                          k=(0.03, -0.004, 5e-4, 0.0), image_size=size,
                                          device="cpu")


def _camera(kind, position, target=(0.0, 0.0, 1.0)):
    return Camera.create(_intrinsics(kind)).look_at(position, target, (0.0, 0.0, 1.0))


def _module(char, camera, seed, near_clip=0.01, loss=None, batch=(B,)):
    """A module over the rig's locators, its targets the pixels of another
    pose plus noise, a fifth of its confidences zero."""
    loc = char.locators
    n = loc.num_locators
    rng = np.random.default_rng(seed)
    truth = torch.as_tensor(rng.uniform(-0.3, 0.3, batch + (char.num_model_parameters,)),
                            dtype=torch.float32)
    uvz, _ = camera.project(loc.world_positions(char.skeleton_states(truth)))
    target = uvz[..., :2] + torch.as_tensor(rng.normal(0, 3, uvz.shape[:-1] + (2,)),
                                            dtype=torch.float32)
    conf = torch.as_tensor(rng.uniform(0.5, 1.5, batch + (n,)) * (rng.random(batch + (n,)) > 0.2),
                           dtype=torch.float32)
    ef = CameraProjectionErrorFunction.create(camera, loc.parent.numpy(), loc.offset.numpy(),
                                              np.zeros((n, 2)), near_clip=near_clip, loss=loss,
                                              device="cpu")
    return dataclasses.replace(ef, target=target, cweight=conf)


def _poses(char, seed, batch=(B,)):
    rng = np.random.default_rng(seed + 100)
    return torch.as_tensor(rng.uniform(-0.3, 0.3, batch + (char.num_model_parameters,)),
                           dtype=torch.float32)


def _ad(fn, x):
    rows, jt = ad_jacobian(fn.residual, x)
    return rows, jt.transpose(-1, -2)


def _close(got, want, dtype):
    torch.testing.assert_close(got, want, rtol=0, atol=TOL[dtype] * float(want.abs().max()))


CASES = [  # (intrinsics, camera position, near clip, loss, batched, seed)
    ("pinhole", (2.6, 0.8, 1.6), 0.01, None, True, 1),
    ("opencv", (-2.2, 1.4, 2.3), 0.01, None, True, 2),
    ("opencv", (1.9, -1.7, 0.6), 0.01, (0.5, 30.0), True, 3),
    ("pinhole", (0.0, -2.4, 1.2), 0.01, (1.0, 20.0), False, 4),
    ("opencv", (0.1, 0.3, 1.1), 0.15, None, True, 5),  # inside the body: points behind, near
    ("opencv", (2.8, 0.0, 0.9), 0.01, None, False, 6),
]
IDS = ["pinhole", "opencv", "opencv_robust", "pinhole_l1_single", "opencv_behind",
       "opencv_single"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind,position,near,loss,batched,seed", CASES, ids=IDS)
def test_analytic_jacobian_matches_forward_mode(cmu, kind, position, near, loss, batched, seed,
                                                dtype):
    batch = (B,) if batched else ()
    ef = _module(cmu, _camera(kind, position), seed=seed, near_clip=near,
                 loss=None if loss is None else GeneralizedLoss(*loss), batch=batch)
    char, ef = _as(cmu, dtype), _as(ef, dtype)
    x = _poses(cmu, 1, batch).to(dtype)
    assert ef.has_analytic_jacobian
    fn = SkeletonSolverFunction(char, (ef,))
    rows_ad, j_ad = _ad(fn, x)
    rows, j = fn.residual_and_jacobian(x)
    assert j.dtype == dtype and j.shape == batch + (2 * cmu.locators.num_locators,
                                                    cmu.num_model_parameters)
    torch.testing.assert_close(rows, rows_ad, rtol=0, atol=0)
    _close(j, j_ad, dtype)
    # the joint-space form through the parameter transform
    ctx = fn.context(x)
    rows_j, j_joint, j_model = ef.jacobian(char, ctx, make_jacobian_context(char, ctx))
    assert j_model is None
    torch.testing.assert_close(rows_j, rows_ad, rtol=0, atol=0)
    _close(j_joint @ char.parameter_transform.transform, j_ad, dtype)
    if kind == "opencv" and near > 0.1:
        # some points behind the camera or inside its near clip: zero rows and J
        zero = rows.reshape(rows.shape[:-1] + (-1, 2)).abs().sum(-1) == 0
        assert zero.any() and bool((j.reshape(j.shape[:-2] + (-1, 2, j.shape[-1]))[zero] == 0)
                                   .all())


def test_zero_confidence_rows_are_zero(cmu):
    ef = _module(cmu, _camera("opencv", (2.0, 1.0, 1.5)), seed=3)
    zero = ef.cweight == 0
    assert zero.any()
    rows, j = SkeletonSolverFunction(cmu, (ef,)).residual_and_jacobian(_poses(cmu, 2))
    j = j.reshape(B, -1, 2, cmu.num_model_parameters)
    assert bool((j[zero] == 0).all()) and bool((rows.reshape(B, -1, 2)[zero] == 0).all())


def test_a_nan_pose_gives_nan_rows(cmu):
    """A NaN depth is not behind the near clip: a failed step's rows are
    NaN, so LM rejects it (rows of zeros would read as energy 0)."""
    ef = _module(cmu, _camera("pinhole", (2.0, 1.0, 1.5)), seed=4)
    x = _poses(cmu, 3)
    x[1] = float("nan")
    rows = SkeletonSolverFunction(cmu, (ef,)).residual(x)
    assert bool(torch.isfinite(rows[0]).all()) and bool(torch.isnan(rows[1]).any())


def test_opencv_parameters_follow_in_place_edits():
    """The row of 12 numbers is formed from the model's tensors at each
    call: it follows an in-place edit, and carries the gradient of a
    parameter that requires one."""
    intr = _intrinsics("opencv")
    first = intr.opencv_parameters()
    intr.k[0] = -0.3
    again = intr.opencv_parameters()
    assert float(again[4]) == pytest.approx(-0.3) and float(first[4]) != float(again[4])
    pin = _intrinsics("pinhole")
    fx = pin.fx.clone().requires_grad_()
    pin = dataclasses.replace(pin, fx=fx)
    row = pin.opencv_parameters()
    assert row.requires_grad and bool((row[4:] == 0).all())
    row[0].backward()
    assert float(fx.grad) == 1.0


def test_fisheye_keeps_forward_mode(cmu):
    ef = _module(cmu, _camera("fisheye", (2.0, -1.0, 1.4)), seed=5)
    assert not ef.has_analytic_jacobian and ef.jacobian_group() is None
    fn = SkeletonSolverFunction(cmu, (ef,))
    assert not fn.fully_analytic
    rows, j = fn.residual_and_jacobian(_poses(cmu, 4))
    rows_ad, j_ad = _ad(fn, _poses(cmu, 4))
    torch.testing.assert_close(j, j_ad, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_grouped_cameras_match_one_by_one(cmu, dtype):
    """Four cameras over the same locator tables (one launch of the
    projection form), a fisheye among them (forward mode) and a position
    module between them: the rows and J are the modules' one by one, each
    group's rows in the modules' order at the place of its first."""
    from momentum_tpu_torch.errors import PositionErrorFunction

    kinds = [("opencv", (2.6, 0.8, 1.6)), ("pinhole", (-2.2, 1.4, 2.3)),
             ("fisheye", (0.2, -2.5, 1.5)), ("opencv", (1.0, 2.6, 0.7))]
    mods = [_as(_module(cmu, _camera(*k), seed=11 + i), dtype) for i, k in enumerate(kinds)]
    mods = [mods[0]] + [dataclasses.replace(m, parent=mods[0].parent, offset=mods[0].offset)
                        for m in mods[1:]]
    loc = cmu.locators
    pos = _as(PositionErrorFunction.create(loc.parent.numpy(), loc.offset.numpy(),
                                           np.zeros((loc.num_locators, 3)), device="cpu"), dtype)
    efs = (mods[0], pos) + tuple(mods[1:])
    char = _as(cmu, dtype)
    groups = _module_groups([e for e in efs if e.has_analytic_jacobian])
    assert [len(g) for g in groups] == [3, 1]
    x = _poses(cmu, 5).to(dtype)
    fn = SkeletonSolverFunction(char, efs)
    rows, j = fn.residual_and_jacobian(x)
    ctx = fn.context(x)
    jc = make_jacobian_context(char, ctx)
    pt = char.parameter_transform.transform
    one = [e.jacobian_model(char, ctx, jc, pt) for e in (efs[0], efs[2], efs[4], efs[1])]
    rows_ad, j_ad = _ad(SkeletonSolverFunction(char, (efs[3],)), x)
    torch.testing.assert_close(rows, torch.cat([r for r, _ in one] + [rows_ad], -1),
                               rtol=0, atol=0)
    torch.testing.assert_close(j, torch.cat([jj for _, jj in one] + [j_ad], -2), rtol=0,
                               atol=TOL[dtype] * float(j.abs().max()))
    # tables that are equal but not shared take one launch each
    apart = dataclasses.replace(efs[2], parent=efs[0].parent.clone())
    assert len(_module_groups([efs[0], apart, efs[4]])) == 2


def test_projection_jacobian_matches_jax_jacfwd():
    """The port's J of an OpenCV camera's rows on the full-body rig against
    jax.jacfwd of momentum_tpu's module (forward mode through JAX's FK), on
    the same rows; float32 on both sides, 2e-5 of max|J| (two frameworks'
    FK, each ~1e-7 relative, through 1e3-pixel derivatives)."""
    import jax
    import jax.numpy as jnp

    from momentum_tpu.camera import Camera as JCamera, OpenCVIntrinsics as JOpenCV
    from momentum_tpu.errors import CameraProjectionErrorFunction as JProj
    from momentum_tpu.solver import SkeletonSolverFunction as JFn
    from momentum_tpu_torch import bridge

    from test_torch_port_helpers import (
        camera_to_numpy, jax_fullbody_character, port_fullbody_character)

    jchar, tchar = jax_fullbody_character(), port_fullbody_character()
    tcam = _camera("opencv", (5.0, 2.0, 3.0), (0.0, 0.0, 0.0))
    jcam = JCamera.create(JOpenCV.create(1400.0, 1380.0, 955.0, 545.0,
                                         k=(-0.21, 0.11, -0.015, 0.04, -0.02, 0.01),
                                         p=(8e-4, -6e-4)),
                          jnp.asarray(tcam.eye_from_world.numpy()))
    tcam = bridge.camera_from_numpy(camera_to_numpy(jcam), device="cpu")
    loc = jchar.locators
    n = loc.num_locators
    rng = np.random.default_rng(21)
    p = jchar.num_model_parameters
    x = rng.uniform(-0.2, 0.2, (2, p)).astype(np.float32)
    target = rng.normal((955, 545), 300, (2, n, 2)).astype(np.float32)
    conf = (rng.random((2, n)) > 0.2).astype(np.float32)
    jef = JProj.create(jcam, np.asarray(loc.parent), np.asarray(loc.offset), np.zeros((n, 2)))
    tef = dataclasses.replace(
        CameraProjectionErrorFunction.create(tcam, np.asarray(loc.parent),
                                             np.asarray(loc.offset), np.zeros((n, 2)),
                                             device="cpu"),
        target=torch.as_tensor(target), cweight=torch.as_tensor(conf))
    want_rows, want = [], []
    for b in range(2):  # one element at a time: JAX's module takes (C, 2) targets
        jfn = JFn(jchar, (dataclasses.replace(jef, target=jnp.asarray(target[b]),
                                              cweight=jnp.asarray(conf[b])),))
        want_rows.append(np.asarray(jfn.residual(jnp.asarray(x[b]))))
        want.append(np.asarray(jax.jacfwd(jfn.residual)(jnp.asarray(x[b]))))
    want_rows, want = np.stack(want_rows), np.stack(want)
    rows, got = SkeletonSolverFunction(tchar, (tef,)).residual_and_jacobian(torch.as_tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(rows.numpy(), want_rows, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
