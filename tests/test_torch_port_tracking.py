"""Parity of the port's marker tracking (momentum_tpu_torch/tracking/) and
of what it needs (the forward-mode Jacobian of the GN/LM solvers and of
SkeletonSolverFunction, ModelParametersErrorFunction, PlaneErrorFunction
and the body modules) with momentum_tpu on the CPU, at the size of
tests/test_tracking.py: the 4-joint test rig, F ≤ 13 frames, the same
numpy-seeded inputs through both packages.

Tolerances, each with where it comes from:
  * Jacobians: 1e-5 of max|J| (float32 forward mode on both sides; the
    analytic Jacobian agrees with forward mode to the same);
  * module rows and energies: rtol 1e-5, atol 1e-6 (float32); the
    finite-difference check runs in float64 at step 1e-6, to 1e-6;
  * tracking: the final per-frame energies to rtol 1e-3 or atol 1e-7, the
    marker errors to rtol 1e-3, a recovered scale_global to 1e-4, recovered
    locator offsets to 1e-4 (the rig's unit).
"""

import dataclasses
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu import errors as jerr, tracking as jt
from momentum_tpu.solver import SkeletonSolverFunction as JSSF
from momentum_tpu.solver.gauss_newton import _jacobian as jax_jacobian
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu.tracking import tracker as jtracker
from momentum_tpu.tracking.cmu import create_cmu_character as jax_cmu
from momentum_tpu_torch import errors as terr, tracking as tt
from momentum_tpu_torch.solver import SkeletonSolverFunction as TSSF, SolverOptions
from momentum_tpu_torch.solver.gauss_newton import (
    ad_jacobian, solve_gauss_newton, solve_levenberg_marquardt)
from momentum_tpu_torch.testing import fixtures as tfix
from momentum_tpu_torch.tracking import tracker as ttracker

MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
ENERGY_TOL = dict(rtol=1e-3, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small CPU solves run fastest on one thread beside XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rigs():
    return jax_test_character(4), tfix.create_test_character(4, device="cpu")


def _thetas(p, f, rng, scale=None):
    """tests/test_tracking.py's motion: a sine per parameter, parameter 0
    inside the rig's MinMax limit, scale_global constant."""
    t = np.linspace(0, 1, f)[:, None]
    phase = rng.uniform(0, 2 * np.pi, p)
    amp = rng.uniform(0.05, 0.3, p)
    thetas = amp * np.sin(2 * np.pi * t + phase)
    thetas[:, 0] = np.clip(thetas[:, 0], -0.09, 0.09)
    thetas[:, 6] = 0.0 if scale is None else scale
    return thetas.astype(np.float32)


def _markers(jchar, f, seed=12345, occlusion=0.0, scale=None, noise=0.01):
    """(thetas, JAX MarkerSequence, port MarkerSequence) of the same
    numbers: JAX's FK of the locators plus N(0, noise), the occlusion mask
    i.i.d."""
    rng = np.random.default_rng(seed)
    thetas = _thetas(jchar.num_model_parameters, f, rng, scale)
    states = jax.vmap(jchar.skeleton_states)(jnp.asarray(thetas))
    pos = np.asarray(jax.vmap(jchar.locators.world_positions)(states))
    pos = (pos + rng.normal(0, noise, pos.shape)).astype(np.float32)
    occ = rng.random((f, jchar.locators.num_locators)) < occlusion
    names = tuple(jchar.locators.names)
    return (thetas,
            jt.MarkerSequence(positions=jnp.asarray(pos), occluded=jnp.asarray(occ), names=names),
            tt.MarkerSequence(positions=torch.as_tensor(pos), occluded=torch.as_tensor(occ),
                              names=names))


def _close_jac(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _energies(jres, tres):
    np.testing.assert_allclose(tres.errors.numpy(), np.asarray(jres.errors), **ENERGY_TOL)


# ---- the forward-mode Jacobian ----

def _position_modules(jchar, tchar, targets):
    loc = jchar.locators
    jpos = jerr.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                             np.zeros((loc.num_locators, 3)))
    tpos = terr.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                             np.zeros((loc.num_locators, 3)), device="cpu")
    return (dataclasses.replace(jpos, target=jnp.asarray(targets)),
            dataclasses.replace(tpos, target=torch.as_tensor(targets)))


@pytest.mark.parametrize("batch", [None, 8])
def test_ad_jacobian_matches_jax_and_analytic(rigs, batch):
    """`ad_jacobian` of position + limit rows against JAX's linearize +
    vmapped JVP (unbatched, and at B = 8 with the broadcast basis
    tangents), and against the port's analytic Jacobian of the position
    rows."""
    jchar, tchar = rigs
    p = jchar.num_model_parameters
    rng = np.random.default_rng(3)
    shape = (p,) if batch is None else (batch, p)
    x = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    targets = rng.normal(0, 1, shape[:-1] + (jchar.locators.num_locators, 3)).astype(np.float32)
    jpos, tpos = _position_modules(jchar, tchar, targets)
    jfn = JSSF(jchar, (jpos, jerr.LimitErrorFunction.create()))
    tfn = TSSF(tchar, (tpos, terr.LimitErrorFunction.create(device="cpu")))
    j_rows, j_jt = jax.jit(lambda y: jax_jacobian(jfn.residual, y))(jnp.asarray(x))
    t_rows, t_jt = ad_jacobian(tfn.residual, torch.as_tensor(x))
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), **MODULE_TOL)
    _close_jac(t_jt.numpy(), j_jt)
    pos_only = TSSF(tchar, (tpos,))
    rows_a, jac_a = pos_only.residual_and_jacobian(torch.as_tensor(x))
    rows_ad, jt_ad = ad_jacobian(pos_only.residual, torch.as_tensor(x))
    np.testing.assert_allclose(rows_ad.numpy(), rows_a.numpy(), **MODULE_TOL)
    _close_jac(jt_ad.transpose(-1, -2).numpy(), jac_a.numpy())


def _plane_modules(jchar, half_plane=False, cweight=None):
    n = jchar.locators.num_locators
    rng = np.random.default_rng(7)
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            rng.normal(0, 1, (n, 3)).astype(np.float32), rng.normal(0, 0.5, n).astype(np.float32))
    kw = dict(cweight=cweight, weight=0.7, half_plane=half_plane)
    return (jerr.PlaneErrorFunction.create(*args, **kw),
            terr.PlaneErrorFunction.create(*args, device="cpu", **kw))


def test_mixed_analytic_and_ad_rows_match_jax(rigs):
    """SkeletonSolverFunction with Position (analytic) and CenterOfMass
    (forward mode; Plane, which this test took before, has its analytic
    Jacobian now): residual_and_jacobian's rows and Jacobian against JAX's,
    row for row, and the solver's normal equations through the same
    branch."""
    jchar, tchar = rigs
    p = jchar.num_model_parameters
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.3, 0.3, p).astype(np.float32)
    targets = rng.normal(0, 1, (jchar.locators.num_locators, 3)).astype(np.float32)
    jpos, tpos = _position_modules(jchar, tchar, targets)
    jpl, tpl = _module_pairs(jchar)["center_of_mass"]
    jfn, tfn = JSSF(jchar, (jpos, jpl)), TSSF(tchar, (tpos, tpl))
    assert not tfn.fully_analytic
    j_rows, j_jac = jax.jit(jfn.residual_and_jacobian)(jnp.asarray(x))
    t_rows, t_jac = tfn.residual_and_jacobian(torch.as_tensor(x))
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), **MODULE_TOL)
    _close_jac(t_jac.numpy(), j_jac)
    jtj, jtr, sq = tfn.normal_equations(torch.as_tensor(x))
    j64 = np.asarray(j_jac, np.float64)
    np.testing.assert_allclose(jtj.numpy(), j64.T @ j64, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sq.numpy(), float(np.sum(np.asarray(j_rows) ** 2)), rtol=1e-5)


def test_force_ad_and_gradient(rigs):
    """force_ad turns fully_analytic off, and the forward-mode Jacobian then
    matches the analytic one; gradient() (reverse mode through FK) matches
    jax.grad of the same energy."""
    jchar, tchar = rigs
    p = jchar.num_model_parameters
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.3, 0.3, p).astype(np.float32)
    targets = rng.normal(0, 1, (jchar.locators.num_locators, 3)).astype(np.float32)
    jpos, tpos = _position_modules(jchar, tchar, targets)
    fn = TSSF(tchar, (tpos,))
    forced = dataclasses.replace(fn, force_ad=True)
    assert fn.fully_analytic and not forced.fully_analytic
    _, jac = fn.residual_and_jacobian(torch.as_tensor(x))
    _, jt_ad = ad_jacobian(forced.residual, torch.as_tensor(x))
    _close_jac(jt_ad.transpose(-1, -2).numpy(), jac.numpy())
    jpl, tpl = _plane_modules(jchar)
    jfn = JSSF(jchar, (jpos, jpl, jerr.LimitErrorFunction.create()))
    tfn = TSSF(tchar, (tpos, tpl, terr.LimitErrorFunction.create(device="cpu")))
    np.testing.assert_allclose(tfn.gradient(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jfn.gradient)(jnp.asarray(x))), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("batch", [None, 8])
def test_residual_only_solvers(rigs, batch):
    """GN and LM take (residual_fn, error_fn, x0, mask, opts) with no
    Jacobian provider: the same steps as with the analytic Jacobian, and
    the final energy of JAX's residual-only LM."""
    jchar, tchar = rigs
    p = jchar.num_model_parameters
    rng = np.random.default_rng(6)
    shape = (p,) if batch is None else (batch, p)
    x0 = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    targets = np.asarray(jax.vmap(jchar.locators.world_positions)(
        jax.vmap(jchar.skeleton_states)(jnp.asarray(x0.reshape(-1, p) + 0.1))))
    targets = targets.reshape(shape[:-1] + targets.shape[-2:])
    jpos, tpos = _position_modules(jchar, tchar, targets)
    fn = TSSF(tchar, (tpos,))
    mask = torch.ones(p)
    mask[6] = 0.0
    opts = SolverOptions(max_iterations=6, regularization=1e-5)
    xt = torch.as_tensor(x0)
    for solve in (solve_gauss_newton, solve_levenberg_marquardt):
        ad = solve(fn.residual, fn.error, xt, mask, opts)
        analytic = solve(fn.residual, fn.error, xt, mask, opts,
                         jacobian_fn=fn.residual_and_jacobian)
        # the two Jacobians agree to 1e-5 of max|J|; compare the final
        # energies, as every solver parity test of the port does (F5)
        np.testing.assert_allclose(ad.error.numpy(), analytic.error.numpy(), **ENERGY_TOL)
        np.testing.assert_array_equal(ad.params[..., 6].numpy(), x0[..., 6])
    from momentum_tpu.solver.gauss_newton import solve_levenberg_marquardt as jlm

    jfn = JSSF(jchar, (jpos,))
    jres = jax.jit(lambda y: jlm(jfn.residual, jfn.error, y, jnp.asarray(mask.numpy()),
                                 jax_opts(max_iterations=6, regularization=1e-5)))(
        jnp.asarray(x0))
    np.testing.assert_allclose(ad.error.numpy(), np.asarray(jres.error), **ENERGY_TOL)


def jax_opts(**kw):
    from momentum_tpu.solver import SolverOptions as JOpts

    return JOpts(**kw)


# ---- the modules ----

def _module_pairs(jchar):
    p = jchar.num_model_parameters
    rng = np.random.default_rng(8)
    target = rng.normal(0, 0.2, p).astype(np.float32)
    pweight = rng.uniform(0, 2, p).astype(np.float32)
    vid = np.arange(0, jchar.mesh.num_vertices, 3, dtype=np.int32)
    com = (np.asarray([0, 1, 3]), np.asarray([1.0, 2.0, 0.5]), np.asarray([0.1, 1.2, -0.3]))
    com_off = rng.normal(0, 0.1, (3, 3)).astype(np.float32)
    return {
        "model_parameters": (
            jerr.ModelParametersErrorFunction.create(target, pweight=pweight, weight=0.3),
            terr.ModelParametersErrorFunction.create(target, pweight=pweight, weight=0.3,
                                                     device="cpu")),
        "plane": _plane_modules(jchar),
        "plane_half": _plane_modules(jchar, half_plane=True,
                                     cweight=np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)),
        "floor": (jerr.FloorErrorFunction.create(vid, target_height=-0.2, weight=0.8, k=5),
                  terr.FloorErrorFunction.create(vid, target_height=-0.2, weight=0.8, k=5,
                                                 device="cpu")),
        "center_of_mass": (jerr.CenterOfMassErrorFunction.create(*com, offsets=com_off),
                           terr.CenterOfMassErrorFunction.create(*com, offsets=com_off,
                                                                 device="cpu")),
        "center_of_mass_plane": (
            jerr.CenterOfMassErrorFunction.create(*com, project_to_plane=True,
                                                  projection_d=0.4),
            terr.CenterOfMassErrorFunction.create(*com, project_to_plane=True,
                                                  projection_d=0.4, device="cpu")),
        "height": (jerr.HeightErrorFunction.create(3.5, weight=1.5),
                   terr.HeightErrorFunction.create(3.5, weight=1.5, device="cpu")),
    }


@pytest.mark.parametrize("name", ["model_parameters", "plane", "plane_half", "floor",
                                  "center_of_mass", "center_of_mass_plane", "height"])
def test_module_matches_jax_and_finite_differences(rigs, name):
    """Each module's rows, energy and Jacobian (analytic for
    ModelParameters and Plane, forward mode for the rest) against JAX's, at
    B = 3; and the Jacobian against central differences in float64."""
    jchar, tchar = rigs
    jef, tef = _module_pairs(jchar)[name]
    p = jchar.num_model_parameters
    x = np.random.default_rng(9).uniform(-0.4, 0.4, (3, p)).astype(np.float32)
    jfn, tfn = JSSF(jchar, (jef,)), TSSF(tchar, (tef,))
    assert tfn.fully_analytic == (name in ("model_parameters", "plane", "plane_half"))
    np.testing.assert_allclose(tfn.residual(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jfn.residual)(jnp.asarray(x))), **MODULE_TOL)
    np.testing.assert_allclose(tfn.error(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jfn.error)(jnp.asarray(x))), **MODULE_TOL)
    j_rows, j_jac = jax.jit(jfn.residual_and_jacobian)(jnp.asarray(x))
    t_rows, t_jac = tfn.residual_and_jacobian(torch.as_tensor(x))
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), **MODULE_TOL)
    _close_jac(t_jac.numpy(), j_jac)

    char64 = tfix.create_test_character(4, dtype=torch.float64, device="cpu")
    fn64 = TSSF(char64, (dataclasses.replace(tef, **{
        f.name: getattr(tef, f.name).double() for f in dataclasses.fields(tef)
        if isinstance(getattr(tef, f.name), torch.Tensor)
        and getattr(tef, f.name).is_floating_point()}),))
    x64 = torch.as_tensor(x[0], dtype=torch.float64)
    _, jac64 = fn64.residual_and_jacobian(x64)
    h = 1e-6
    eye = torch.eye(p, dtype=torch.float64)
    fd = torch.stack([(fn64.residual(x64 + h * e) - fn64.residual(x64 - h * e)) / (2 * h)
                      for e in eye], dim=-1)
    _close_jac(jac64.numpy(), fd.numpy(), tol=1e-6)


def test_cmu_character_matches_jax():
    """create_cmu_character is JAX's rig: names, locators, and the skeleton
    states at seeded parameters."""
    jchar, tchar = jax_cmu(), tt.create_cmu_character(device="cpu")
    assert tchar.num_model_parameters == jchar.num_model_parameters == 73
    assert tchar.parameter_transform.names == jchar.parameter_transform.names
    assert tchar.parameter_transform.parameter_sets == {"scaling": (6,)}
    assert tchar.locators.names == jchar.locators.names
    np.testing.assert_array_equal(tchar.locators.offset.numpy(),
                                  np.asarray(jchar.locators.offset))
    x = np.random.default_rng(11).uniform(-0.5, 0.5, (4, 73)).astype(np.float32)
    x[:, :3] *= 500.0
    np.testing.assert_allclose(tchar.skeleton_states(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jax.vmap(jchar.skeleton_states))(
                                   jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


# ---- tracking ----

LM = "levenberg_marquardt"


@pytest.mark.parametrize("method", ["gauss_newton", LM])
def test_track_poses_per_frame_matches_jax(rigs, method):
    """Warm-started per-frame tracking. LM with 20% of the markers occluded;
    GN on every marker: an occluded frame leaves the 4-locator rig under-
    determined, where GN's undamped steps at regularization 1e-5 take
    float32 roundoff to different minima in the two packages."""
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 8, occlusion=0.2 if method == LM else 0.0)
    cfg = dict(max_iter=15, regularization=1e-5, method=method)
    jres = jt.track_poses_per_frame(jchar, jm, jt.TrackingConfig(**cfg))
    tres = tt.track_poses_per_frame(tchar, tm, tt.TrackingConfig(**cfg))
    assert tres.motion.shape == (8, tchar.num_model_parameters)
    _energies(jres, tres)
    np.testing.assert_allclose(tt.get_locator_error(tchar, tm, tres.motion),
                               jt.get_locator_error(jchar, jm, jres.motion), rtol=1e-3)


@pytest.mark.parametrize("refine", [None, (4, 2, 4)])
def test_track_poses_batched_matches_jax(rigs, refine):
    """All frames at once, plain and with the compacted tail (LM's damping
    carried into the refined frames)."""
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 13)
    cfg = dict(max_iter=15, regularization=1e-5, method=LM, refine=refine)
    jres = jax.jit(lambda m: jt.track_poses_batched(jchar, m, jt.TrackingConfig(**cfg)))(jm)
    tres = tt.track_poses_batched(tchar, tm, tt.TrackingConfig(**cfg))
    _energies(jres, tres)


@pytest.mark.parametrize("continuous", [False, True])
def test_track_poses_for_frames_matches_jax(rigs, continuous):
    jchar, tchar = rigs
    thetas, jm, tm = _markers(jchar, 9)
    cfg = dict(max_iter=15, regularization=1e-5, method=LM)
    init = thetas + 0.05
    jres = jax.jit(lambda m, x: jt.track_poses_for_frames(
        jchar, m, x, jt.TrackingConfig(**cfg), frame_indices=[0, 4, 7],
        is_continuous=continuous))(jm, jnp.asarray(init))
    tres = tt.track_poses_for_frames(tchar, tm, torch.as_tensor(init), tt.TrackingConfig(**cfg),
                                     frame_indices=[0, 4, 7], is_continuous=continuous)
    _energies(jres, tres)
    np.testing.assert_array_equal(tres.motion[1].numpy(), tres.motion[4].numpy())
    np.testing.assert_array_equal(tres.motion[8].numpy(), tres.motion[7].numpy())


def test_track_poses_hierarchical_and_stride_match_jax(rigs):
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 13)
    cfg = dict(max_iter=15, regularization=1e-5, method=LM, refine=(4, 2, 4))
    jres = jax.jit(lambda m: jt.track_poses_hierarchical(jchar, m, jt.TrackingConfig(**cfg),
                                                          stride=4))(jm)
    tres = tt.track_poses_hierarchical(tchar, tm, tt.TrackingConfig(**cfg), stride=4)
    _energies(jres, tres)
    cfg = dict(max_iter=15, regularization=1e-5)
    jres = jax.jit(lambda m: jt.track_poses_per_frame(jchar, m, jt.TrackingConfig(**cfg),
                                                       frame_stride=3))(jm)
    tres = tt.track_poses_per_frame(tchar, tm, tt.TrackingConfig(**cfg), frame_stride=3)
    _energies(jres, tres)


def test_track_sequence_matches_jax(rigs):
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 6)
    cfg = dict(max_iter=25, regularization=1e-5, smoothing=1e-4)
    jres, _ = jt.track_sequence(jchar, jm, jt.TrackingConfig(**cfg))
    tres, _ = tt.track_sequence(tchar, tm, tt.TrackingConfig(**cfg))
    _energies(jres, tres)


def test_refine_motion_matches_jax_f64(rigs):
    """refine_motion in its default float64 mode against JAX's x64 scope,
    with the pull toward the input and smoothing."""
    jchar, tchar = rigs
    thetas, jm, tm = _markers(jchar, 6)
    noisy = thetas + np.random.default_rng(2).normal(0, 0.05, thetas.shape).astype(np.float32)
    cfg = dict(max_iter=15, regularization=1e-5, regularizer=1e-3, smoothing=1e-4)
    jres, _ = jtracker.refine_motion(jchar, jm, jnp.asarray(noisy),
                                     jt.config.RefineConfig(**cfg))
    tres, _ = tt.refine_motion(tchar, tm, torch.as_tensor(noisy), tt.RefineConfig(**cfg))
    _energies(jres, tres)
    np.testing.assert_allclose(tres.motion.numpy(), np.asarray(jres.motion), atol=1e-3)


def test_calibrate_model_matches_jax(rigs):
    """The scale calibration recovers the truth (0.25) as JAX's does, to 1e-4 of JAX's."""
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 8, scale=0.25, noise=0.0)
    cfg = dict(calib_frames=4, major_iter=2, max_iter=15, regularization=1e-6)
    j_id, _ = jt.calibrate_model(jchar, jm, jt.CalibrationConfig(**cfg))
    t_id, t_motion = tt.calibrate_model(tchar, tm, tt.CalibrationConfig(**cfg))
    assert t_motion.shape == (4, tchar.num_model_parameters)
    assert abs(float(t_id[6]) - float(j_id[6])) <= 1e-4
    assert abs(float(t_id[6]) - 0.25) <= 5e-3


def test_calibrate_locators_matches_jax(rigs):
    """calibrate_locators from perturbed offsets, and the locators-only
    calibration round, against JAX's offsets to 1e-4."""
    jchar, tchar = rigs
    thetas, jm, tm = _markers(jchar, 10, noise=0.0)
    rng = np.random.default_rng(12345)
    off = np.asarray(jchar.locators.offset)
    bad = (off + rng.normal(0, 0.1, off.shape)).astype(np.float32)
    jp = dataclasses.replace(jchar, locators=dataclasses.replace(jchar.locators,
                                                                 offset=jnp.asarray(bad)))
    tp = dataclasses.replace(tchar, locators=dataclasses.replace(tchar.locators,
                                                                 offset=torch.as_tensor(bad)))
    j_rec = jt.calibrate_locators(jp, jm, jnp.asarray(thetas))
    t_rec = tt.calibrate_locators(tp, tm, torch.as_tensor(thetas))
    np.testing.assert_allclose(t_rec.locators.offset.numpy(), np.asarray(j_rec.locators.offset),
                               atol=1e-4)
    cfg = dict(calib_frames=5, major_iter=1, max_iter=20, regularization=1e-5,
               locators_only=True, method=LM)
    j_out = jt.calibrate_model(jp, jm, jt.CalibrationConfig(**cfg))
    t_out = tt.calibrate_model(tp, tm, tt.CalibrationConfig(**cfg))
    np.testing.assert_allclose(t_out[2].locators.offset.numpy(),
                               np.asarray(j_out[2].locators.offset), atol=1e-4)


def test_process_markers_matches_jax(rigs):
    """The array API: calibration then per-frame tracking on a window."""
    jchar, tchar = rigs
    _, jm, tm = _markers(jchar, 10, scale=0.1, noise=0.0)
    tcfg = dict(max_iter=20, regularization=1e-5, method=LM)
    ccfg = dict(calib_frames=4, major_iter=1, max_iter=20, regularization=1e-5)
    j_res, _, j_id = jt.process_markers(jchar, jnp.zeros(jchar.num_model_parameters), jm,
                                        jt.TrackingConfig(**tcfg), jt.CalibrationConfig(**ccfg),
                                        first_frame=2, max_frames=6)
    t_res, _, t_id = tt.process_markers(tchar, torch.zeros(tchar.num_model_parameters), tm,
                                        tt.TrackingConfig(**tcfg), tt.CalibrationConfig(**ccfg),
                                        first_frame=2, max_frames=6)
    assert t_res.motion.shape == (6, tchar.num_model_parameters)
    assert abs(float(t_id[6]) - float(j_id[6])) <= 1e-4
    _energies(j_res, t_res)
    with pytest.raises(ValueError):
        tt.calibrate_markers(tchar, t_id, tm, tt.CalibrationConfig(locators_only=True,
                                                                   global_scale_only=True))


# ---- the helpers ----

def test_match_locators_namespaces_and_positional_fallback(rigs, caplog):
    jchar, tchar = rigs
    pos = torch.zeros(2, 4, 3)
    occ = torch.zeros(2, 4, dtype=torch.bool)
    names = ("Subj:l2", "l0", "other", "Subj:l3")
    li, mi = ttracker._match_locators(tchar, tt.MarkerSequence(pos, occ, names))
    jli, jmi = jtracker._match_locators(jchar, jt.MarkerSequence(
        positions=jnp.zeros((2, 4, 3)), occluded=jnp.zeros((2, 4), bool), names=names))
    np.testing.assert_array_equal(li, jli)
    np.testing.assert_array_equal(mi, jmi)
    assert not caplog.records
    with caplog.at_level(logging.WARNING, logger="momentum_tpu_torch.tracking"):
        li, mi = ttracker._match_locators(tchar, tt.MarkerSequence(pos, occ, ("a", "b", "c",
                                                                              "d")))
    np.testing.assert_array_equal(li, np.arange(4))
    np.testing.assert_array_equal(mi, np.arange(4))
    assert "POSITIONAL" in caplog.text


def test_mask_low_visibility_and_gap_fill_match_jax(rigs):
    jchar, _ = rigs
    _, jm, tm = _markers(jchar, 10, occlusion=0.4)
    for pct in (0.0, 60.0):
        np.testing.assert_array_equal(
            ttracker._mask_low_visibility(tm, pct).occluded.numpy(),
            np.asarray(jtracker._mask_low_visibility(jm, pct).occluded))
    for gap in (1, 3):
        jf, tf = jt.fill_marker_gaps(jm, max_gap=gap), tt.fill_marker_gaps(tm, max_gap=gap)
        np.testing.assert_array_equal(tf.occluded.numpy(), np.asarray(jf.occluded))
        np.testing.assert_array_equal(tf.positions.numpy(), np.asarray(jf.positions))


def test_tracker_utils_match_jax(rigs):
    """fill/remove_identity, extract_markers_from_motion, floor contacts and
    the locator character's round trip."""
    from momentum_tpu.tracking import tracker_utils as ju

    jchar, tchar = rigs
    thetas, _, _ = _markers(jchar, 6)
    ident = np.full(jchar.num_model_parameters, 0.3, np.float32)
    t_m = torch.as_tensor(thetas)
    np.testing.assert_array_equal(
        tt.fill_identity(t_m, torch.as_tensor(ident), character=tchar).numpy(),
        np.asarray(ju.fill_identity(thetas, ident, character=jchar)))
    np.testing.assert_array_equal(tt.remove_identity(t_m, character=tchar).numpy(),
                                  np.asarray(ju.remove_identity(thetas, character=jchar)))
    np.testing.assert_allclose(tt.extract_markers_from_motion(tchar, t_m).numpy(),
                               np.asarray(ju.extract_markers_from_motion(jchar, thetas)),
                               **MODULE_TOL)
    args = ([1, 3], np.asarray([[0.1, 0.2, 0.0], [0.0, -0.3, 0.1]], np.float32))
    t_c, t_h = tt.compute_floor_contact_constraints(tchar, t_m, *args, percentile=0.3)
    j_c, j_h = ju.compute_floor_contact_constraints(jchar, thetas, *args, percentile=0.3)
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), **MODULE_TOL)
    np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
    t_lc, t_mask = tt.create_locator_character(tchar)
    j_lc, j_mask = ju.create_locator_character(jchar)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_lc.parameter_transform.transform.numpy(),
                                  np.asarray(j_lc.parameter_transform.transform))
    params = np.zeros(t_lc.num_model_parameters, np.float32)
    params[:thetas.shape[1]] = thetas[2]
    params[t_mask] = 0.05
    t_id, t_loc = tt.extract_id_and_locators_from_params(torch.as_tensor(params), t_lc, tchar)
    j_id, j_loc = ju.extract_id_and_locators_from_params(params, j_lc, jchar)
    np.testing.assert_array_equal(t_id.numpy(), np.asarray(j_id))
    np.testing.assert_allclose(t_loc.offset.numpy(), np.asarray(j_loc.offset), atol=1e-5)
    assert tt.is_related_joint(tchar.skeleton, 1, 2) and not tt.is_related_joint(
        tchar.skeleton, 0, 3)


def test_floor_and_calibration_extras_match_jax(rigs):
    """A rig with Floor_ locators: per-frame tracking with the half-plane
    floor; and calibration's stacked first-frame modules (the height, the
    equality floor pin) and adaptive floor contacts, each in two GN
    iterations of the scale's sequence solve, against JAX's energies and
    scale."""
    jchar, tchar = rigs
    names = ("l0", "l1", "Floor_a", "Floor_b")
    jf = dataclasses.replace(jchar, locators=dataclasses.replace(jchar.locators, names=names))
    tf = dataclasses.replace(tchar, locators=dataclasses.replace(tchar.locators, names=names))
    thetas, jm, tm = _markers(jchar, 6, noise=0.02)
    jm, tm = (dataclasses.replace(m, names=names) for m in (jm, tm))
    cfg = dict(max_iter=15, regularization=1e-5, method=LM)
    _energies(jt.track_poses_per_frame(jf, jm, jt.TrackingConfig(**cfg)),
              tt.track_poses_per_frame(tf, tm, tt.TrackingConfig(**cfg)))
    universal = np.zeros(jchar.num_model_parameters, bool)
    universal[6] = True
    scfg = dict(max_iter=2, regularization=1e-5, line_search=True)
    for extra in (dict(target_height_cm=3.0, enforce_floor_in_first_frame=True),
                  dict(adaptive_floor_contact=True)):
        ccfg = jt.CalibrationConfig(**extra)
        j_ex = jtracker._calibration_extras(jf, ccfg, 6)
        t_ex = ttracker._calibration_extras(tf, tt.CalibrationConfig(**extra), 6)
        if ccfg.adaptive_floor_contact:
            j_ex += (jtracker._adaptive_floor_contacts(jf, ccfg, jnp.asarray(thetas)),)
            t_ex += (ttracker._adaptive_floor_contacts(tf, ccfg, torch.as_tensor(thetas)),)
        assert len(t_ex) == len(j_ex) == (2 if "target_height_cm" in extra else 1)
        j_res, j_u = jt.track_sequence(jf, jm, jt.TrackingConfig(**scfg), universal=universal,
                                       initial=jnp.asarray(thetas), extra_per_frame_errors=j_ex)
        t_res, t_u = tt.track_sequence(tf, tm, tt.TrackingConfig(**scfg), universal=universal,
                                       initial=torch.as_tensor(thetas),
                                       extra_per_frame_errors=t_ex)
        _energies(j_res, t_res)
        np.testing.assert_allclose(t_u.numpy(), np.asarray(j_u), rtol=1e-3, atol=1e-4)


def _keypoints(jchar, thetas, seed=21):
    """(JAX keypoint data, the port's) of two cameras 6 units from the rig
    (a pinhole and an OpenCV one, by look_at): JAX's projections of the
    locators at `thetas` plus N(0, 0.5 px), a confidence of 0 on 10% of them
    and 0.5-1 on the rest."""
    from momentum_tpu.camera import Camera, OpenCVIntrinsics, PinholeIntrinsics
    from momentum_tpu_torch import bridge

    from test_torch_port_helpers import camera_to_numpy

    rng = np.random.default_rng(seed)
    cams = [Camera.create(PinholeIntrinsics.create(500.0, 500.0, 320.0, 240.0,
                                                   image_size=(640, 480))),
            Camera.create(OpenCVIntrinsics.create(450.0, 460.0, 330.0, 235.0,
                                                  k=(-0.05, 0.01, 0, 0, 0, 0), p=(0.001, 0.0),
                                                  image_size=(640, 480)))]
    cams = [cams[0].look_at((0.5, 1.5, 6.0), (0.0, 1.5, 0.0)),
            cams[1].look_at((5.0, 2.0, 3.0), (0.0, 1.5, 0.0))]
    world = jax.vmap(jchar.locators.world_positions)(
        jax.vmap(jchar.skeleton_states)(jnp.asarray(thetas)))
    out_j, out_t = [], []
    for cam in cams:
        uv = np.asarray(cam.project(world)[0][..., :2])
        tgt = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
        conf = (rng.uniform(0.5, 1.0, uv.shape[:-1])
                * (rng.random(uv.shape[:-1]) > 0.1)).astype(np.float32)
        out_j.append(jt.tracker.CameraKeypointData(camera=cam, targets=jnp.asarray(tgt),
                                                   confidence=jnp.asarray(conf)))
        out_t.append(tt.CameraKeypointData(
            camera=bridge.camera_from_numpy(camera_to_numpy(cam), device="cpu"),
            targets=torch.as_tensor(tgt), confidence=torch.as_tensor(conf)))
    return tuple(out_j), tuple(out_t)


KP_WEIGHT = 1e-3  # 0.5 px keypoint noise against 0.01 marker noise: comparable energies


@pytest.mark.parametrize("entry", ["per_frame", "batched", "batched_refine", "sequence",
                                   "calibrate", "refine"])
def test_keypoint_entry_points_match_jax(rigs, entry):
    """Markers and two cameras' 2D keypoints through each of the five
    keypoint entry points (CameraKeypointData, projection_weight > 0),
    against JAX's per-frame energies (and the calibrated scale)."""
    jchar, tchar = rigs
    f = 6
    # the calibration's first solves start at rest, where an occluded marker
    # leaves the 4-locator rig's GN steps to roundoff (as in the marker-only
    # case): every marker seen there, LM
    calibrate = entry == "calibrate"
    thetas, jm, tm = _markers(jchar, f, occlusion=0.0 if calibrate else 0.1,
                              scale=0.2 if calibrate else None)
    jk, tk = _keypoints(jchar, thetas)
    kw = dict(regularization=1e-5, method=LM, projection_weight=KP_WEIGHT)
    if entry == "per_frame":
        jres = jt.track_poses_per_frame(jchar, jm, jt.TrackingConfig(max_iter=15, **kw),
                                        camera_keypoints=jk)
        tres = tt.track_poses_per_frame(tchar, tm, tt.TrackingConfig(max_iter=15, **kw),
                                        camera_keypoints=tk)
    elif entry.startswith("batched"):
        refine = (4, 2, 3) if entry == "batched_refine" else None
        jres = jax.jit(lambda m: jt.track_poses_batched(
            jchar, m, jt.TrackingConfig(max_iter=15, refine=refine, **kw),
            camera_keypoints=jk))(jm)
        tres = tt.track_poses_batched(tchar, tm, tt.TrackingConfig(max_iter=15, refine=refine,
                                                                   **kw), camera_keypoints=tk)
    elif entry == "sequence":
        cfg = dict(max_iter=20, regularization=1e-5, smoothing=1e-4,
                   projection_weight=KP_WEIGHT)
        jres, _ = jt.track_sequence(jchar, jm, jt.TrackingConfig(**cfg), camera_keypoints=jk)
        tres, _ = tt.track_sequence(tchar, tm, tt.TrackingConfig(**cfg), camera_keypoints=tk)
    elif entry == "calibrate":
        cfg = dict(calib_frames=3, major_iter=1, max_iter=15, regularization=1e-6,
                   projection_weight=KP_WEIGHT, method=LM)
        j_id, j_m = jt.calibrate_model(jchar, jm, jt.CalibrationConfig(**cfg),
                                       camera_keypoints=jk)
        t_id, t_m = tt.calibrate_model(tchar, tm, tt.CalibrationConfig(**cfg),
                                       camera_keypoints=tk)
        assert abs(float(t_id[6]) - float(j_id[6])) <= 1e-4
        np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=2e-3)
        return
    else:
        noisy = thetas + np.random.default_rng(2).normal(0, 0.05, thetas.shape)
        noisy = noisy.astype(np.float32)
        cfg = dict(max_iter=10, regularization=1e-5, regularizer=1e-3, smoothing=1e-4,
                   projection_weight=KP_WEIGHT)
        jres, _ = jtracker.refine_motion(jchar, jm, jnp.asarray(noisy),
                                         jt.config.RefineConfig(**cfg), camera_keypoints=jk)
        tres, _ = tt.refine_motion(tchar, tm, torch.as_tensor(noisy), tt.RefineConfig(**cfg),
                                   camera_keypoints=tk)
    _energies(jres, tres)
    # the keypoints count: without them the energies differ
    if entry == "per_frame":
        bare = tt.track_poses_per_frame(tchar, tm, tt.TrackingConfig(max_iter=15, **kw))
        assert not np.allclose(bare.errors.numpy(), tres.errors.numpy(), rtol=1e-2)


def test_track_sequence_collision_term_matches_jax():
    """track_sequence with the collision term (collision_error_weight > 0)
    on create_test_character, against JAX's energy. The fixture's capsules
    run along whole bones and touch only when the chain folds, so two of
    them are swapped for a pair that meets when joint 1 bends by more than
    ~0.13 rad: joint 0's upward and joint 2's downward, 0.5 long, radius
    0.499, 1.0 apart at rest. The term is active on the clip."""
    from momentum_tpu.character.character import CollisionGeometry as JCollision
    from momentum_tpu_torch import bridge

    from test_torch_port_helpers import character_to_numpy

    jchar = jax_test_character(4)
    tf = np.zeros((2, 8), np.float32)
    tf[:, 5] = [np.sin(np.pi / 4), -np.sin(np.pi / 4)]  # +Y from joint 0, -Y from joint 2
    tf[:, 6] = np.cos(np.pi / 4)
    tf[:, 7] = 1.0
    jchar = dataclasses.replace(jchar, collision=JCollision(
        parent=jnp.asarray([0, 2], jnp.int32), transform=jnp.asarray(tf),
        radius=jnp.full((2, 2), 0.499, jnp.float32), length=jnp.full((2,), 0.5, jnp.float32)))
    tchar = dataclasses.replace(  # the locators with their names, which the bridge drops
        bridge.character_from_numpy(character_to_numpy(jchar), device="cpu"),
        locators=tfix.create_test_character(4, device="cpu").locators)
    thetas, jm, tm = _markers(jchar, 5)
    cfg = dict(max_iter=10, regularization=1e-5, smoothing=1e-4, collision_error_weight=50.0)
    jres, _ = jt.track_sequence(jchar, jm, jt.TrackingConfig(**cfg))
    tres, _ = tt.track_sequence(tchar, tm, tt.TrackingConfig(**cfg))
    _energies(jres, tres)
    coll = terr.CollisionErrorFunction.create(tchar, weight=50.0, device="cpu")
    np.testing.assert_array_equal(coll.pair_a.numpy(), [0])
    ctx = TSSF(tchar, (coll,)).context(torch.as_tensor(thetas))
    assert float(coll.error(tchar, ctx).max()) > 0
    plain, _ = tt.track_sequence(tchar, tm, tt.TrackingConfig(
        **dict(cfg, collision_error_weight=0.0)))
    assert not np.allclose(plain.errors.numpy(), tres.errors.numpy(), rtol=1e-4)


def test_keypoints_and_gloves_raise(rigs):
    """The glove and keypoint paths, both once refused here, run: per-frame
    tracking and the sequence solve with a glove on the 4-joint rig (its
    bone under joint 2, sensors on joint 3) and with keypoints give finite
    motions."""
    from momentum_tpu_torch.math import skel_state as tss
    from momentum_tpu_torch.tracking.glove_utils import (
        GloveConfig, GloveSequence, create_glove_character)

    jchar, tchar = rigs
    thetas, _, tm = _markers(jchar, 2)
    _, tk = _keypoints(jchar, thetas)
    gcfg = GloveConfig(wrist_joint_names=("joint2", "joint1"))
    gchar = create_glove_character(tchar, gcfg)
    assert gchar.num_joints == tchar.num_joints + 2
    x = torch.zeros(gchar.num_model_parameters)
    states = gchar.skeleton_states(x)
    bone = gchar.skeleton.joint_names.index("glove_joint2")
    rel = tss.multiply(tss.inverse(states[bone]), states[3])
    glove = GloveSequence(joint_index=np.asarray([3], np.int32),
                          positions=np.tile(rel[:3].numpy(), (2, 1, 1)),
                          orientations=np.tile(rel[3:7].numpy(), (2, 1, 1)),
                          valid=np.ones((2, 1), bool))
    gcfg_track = tt.TrackingConfig(max_iter=5)
    res = tt.track_poses_per_frame(gchar, tm, gcfg_track, glove_data=((glove, 0),),
                                   glove_config=gcfg)
    seq, _ = tt.track_sequence(gchar, tm, gcfg_track, glove_data=((glove, 0),),
                               glove_config=gcfg)
    assert bool(torch.isfinite(res.motion).all()) and bool(torch.isfinite(seq.motion).all())
    cfg = tt.TrackingConfig(max_iter=5, projection_weight=KP_WEIGHT)
    res = tt.track_poses_per_frame(tchar, tm, cfg, camera_keypoints=tk)
    assert bool(torch.isfinite(res.motion).all())
    seq, _ = tt.track_sequence(tchar, tm, cfg, camera_keypoints=tk)
    assert bool(torch.isfinite(seq.motion).all())
