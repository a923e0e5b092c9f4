"""Parity of the port's full residual stack with momentum_tpu on the CPU:
orientation, limit and pose-prior modules, their normal-equation
contributions, SkeletonSolverFunction.normal_equations, Gauss-Newton and
solve_ik, and bench.py's full-stack solve (bench.py:242-323) at B = 64.

Tolerances, each with what this file measured:
  * rows: 1e-5 absolute on rows of magnitude ≤ 2 (measured ≤ 7.2e-7: FK in
    f32, summed in another order); energies 1e-5 relative (≤ 4.8e-7);
  * JᵀJ and Jᵀr, port against JAX and against the dense JᵀJ/Jᵀr of the
    port's own rows: 1e-5 of the largest entry, the tolerance of
    tests/test_solver.py::test_normal_equations_match_dense_jacobian
    (measured ≤ 1.5e-6); Σ rows² 1e-5 relative;
  * the whole solve: marker conv@1e-5 within 2/B, median marker energy
    within 20%, divergent fraction 0, as the IK path's parity test compares
    its solve (energies and statistics, not raw parameters: ROADMAP F5).
    Measured: both 1.0 converged, medians 6.4357e-8 (port) and 6.4434e-8
    (JAX).
The pose prior's best component (an argmax) could flip on a near-tie
between the packages; the tests count the flips and hold the rest (none
flips on these inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu import errors as jerr
from momentum_tpu.errors.pose_prior import Mppca as JaxMppca
from momentum_tpu.math import skel_state as jss
from momentum_tpu.solver import SkeletonSolverFunction as JaxSolverFunction
from momentum_tpu.solver import SolverOptions as JaxSolverOptions
from momentum_tpu.solver.ik import solve_ik as jax_solve_ik
from momentum_tpu.testing.workloads import build_fullbody_ik_problem as jax_problem
from momentum_tpu_torch import bridge
from momentum_tpu_torch.errors import (
    LimitErrorFunction, Mppca, OrientationErrorFunction, PosePriorErrorFunction)
from momentum_tpu_torch.solver import (
    SkeletonSolverFunction, SolverOptions, solve_gauss_newton, solve_ik,
    solve_levenberg_marquardt)
from momentum_tpu_torch.solver import ik as port_ik
from momentum_tpu_torch.testing import workloads as twork

from test_torch_port_helpers import (
    character_to_numpy, jax_fullbody_character, jax_fullstack_modules,
    orientation_error_to_numpy, port_fullbody_character,
    port_fullstack_modules as _port_modules)

ROW_ATOL = 1e-5
ENERGY_RTOL = 1e-5
NE_TOL = 1e-5  # of the largest entry (tests/test_solver.py:298)


def _jax_modules(char, targets, q):
    """bench.py's four full-stack modules, targets set."""
    pos, ori, lim, pp = jax_fullstack_modules(char)
    return (dataclasses.replace(pos, target=targets), dataclasses.replace(ori, target=q),
            lim, pp)


@pytest.fixture(scope="module")
def stack():
    """tests/test_solver.py's normal-equation case: 3 elements near random
    poses, element 0 pushed outside its limit on parameter 8."""
    jchar = jax_fullbody_character()
    p = jchar.num_model_parameters
    rng = np.random.default_rng(3)
    gt = rng.uniform(-0.3, 0.3, (3, p)).astype(np.float32)
    states = jax.vmap(jchar.skeleton_states)(jnp.asarray(gt))
    targets = jax.vmap(jchar.locators.world_positions)(states)
    q = jss.split(states)[1]
    x = gt + 0.1 * rng.normal(0, 1, (3, p)).astype(np.float32)
    x[0, 8] = 1.5
    jmods = _jax_modules(jchar, targets, q)
    return jchar, port_fullbody_character(), jmods, _port_modules(jmods), x


MODULES = {"position": 0, "orientation": 1, "limit": 2, "pose_prior": 3}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_residual_and_error_match_jax(stack, name):
    jchar, tchar, jmods, tmods, x = stack
    i = MODULES[name]
    jfn = JaxSolverFunction(jchar, (jmods[i],), prefer_fused=True)
    tfn = SkeletonSolverFunction(tchar, (tmods[i],))
    xt = torch.as_tensor(x)
    rows_j = np.asarray(jfn.residual(jnp.asarray(x)))
    rows_t = tfn.residual(xt).numpy()
    assert rows_t.shape == rows_j.shape
    np.testing.assert_allclose(rows_t, rows_j, rtol=0, atol=ROW_ATOL)
    np.testing.assert_allclose(tfn.error(xt).numpy(), np.asarray(jfn.error(jnp.asarray(x))),
                               rtol=ENERGY_RTOL, atol=1e-12)
    if name == "limit":  # the pushed element is the only one outside its limits
        assert np.count_nonzero(rows_t[0]) == 1 and not rows_t[1:].any()


def _dense_normal(fn, module, x):
    """JᵀJ, Jᵀr, Σ rows² from the port's own rows: the fused Jacobian where
    the module has one, else autograd through its residual (test-only)."""
    if hasattr(module, "jacobian_model"):
        rows, j = fn.residual_and_jacobian(x)
    else:
        rows = fn.residual(x)
        j = torch.autograd.functional.jacobian(lambda z: fn.residual(z).sum(0), x)
        j = j.transpose(0, 1)  # (B, R, P)
    jt = j.transpose(-1, -2)
    return jt @ j, (jt @ rows[..., None])[..., 0], torch.sum(rows * rows, dim=-1)


def _assert_normal_close(got, want):
    for g, w in zip(got[:2], want[:2]):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=NE_TOL * np.abs(w).max())
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=NE_TOL)


@pytest.mark.parametrize("name", list(MODULES))
def test_accumulate_normal_matches_dense_rows(stack, name):
    _, tchar, _, tmods, x = stack
    module = tmods[MODULES[name]]
    assert module.supports_normal_contrib(tchar)
    fn = SkeletonSolverFunction(tchar, (module,))
    xt = torch.as_tensor(x)
    _assert_normal_close([t.numpy() for t in fn.normal_equations(xt)],
                         [t.numpy() for t in _dense_normal(fn, module, xt)])


@pytest.mark.parametrize("name", list(MODULES) + ["stack"])
def test_normal_equations_match_jax(stack, name):
    jchar, tchar, jmods, tmods, x = stack
    pick = list(MODULES.values()) if name == "stack" else [MODULES[name]]
    jfn = JaxSolverFunction(jchar, tuple(jmods[i] for i in pick), prefer_fused=True)
    tfn = SkeletonSolverFunction(tchar, tuple(tmods[i] for i in pick))
    assert tfn.has_structured_modules
    _assert_normal_close([t.numpy() for t in tfn.normal_equations(torch.as_tensor(x))],
                         jfn.normal_equations(jnp.asarray(x)))
    np.testing.assert_allclose(tfn.residual_sq(torch.as_tensor(x)).numpy(),
                               np.asarray(jfn.residual_sq(jnp.asarray(x))), rtol=NE_TOL)


def test_pose_prior_best_component_matches_jax(stack):
    _, _, jmods, tmods, x = stack
    rng = np.random.default_rng(5)
    xs = np.concatenate([x, rng.normal(0, 1.5, (61, x.shape[1])).astype(np.float32)])
    best_j, d_j, sq_j = (np.asarray(v) for v in jmods[3]._best(jnp.asarray(xs)))
    best_t, d_t, sq_t = (v.numpy() for v in tmods[3]._best(torch.as_tensor(xs)))
    same = best_t == best_j
    assert same.sum() >= len(xs) - 1, f"{(~same).sum()} of {len(xs)} selections flipped"
    assert len(np.unique(best_j)) == 2  # both components are selected somewhere
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=0, atol=1e-6)
    np.testing.assert_allclose(sq_t[same], sq_j[same], rtol=ENERGY_RTOL)


def test_mppca_from_components_matches_jax():
    rng = np.random.default_rng(4)
    k, d = 3, 12
    args = dict(pi=np.asarray([0.5, 0.3, 0.2]), mu=rng.normal(0, 1, (k, d)),
                w_list=[rng.normal(0, 0.3, (d, 2)) for _ in range(k)],
                sigma2=np.asarray([0.5, 1.0, 2.0]))
    pj, pt = JaxMppca.from_components(**args), Mppca.from_components(**args, device="cpu")
    for f in ("mu", "cinv", "l", "rpre"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), f)
    xs = rng.normal(0, 1, (5, d)).astype(np.float32)
    np.testing.assert_allclose(pt.log_probability(torch.as_tensor(xs)).numpy(),
                               np.asarray(pj.log_probability(jnp.asarray(xs))), rtol=1e-5)


def test_pose_prior_create_maps_names_like_jax():
    """Prior dimensions map onto parameters by name; an unknown name reads 0
    and owns no JᵀJ cell."""
    names = ("a", "b", "c", "d")
    args = dict(pi=np.asarray([1.0]), mu=np.zeros((1, 3)), w_list=[np.ones((3, 1))],
                sigma2=np.asarray([1.0]), names=("c", "zz", "a"))
    pj = jerr.PosePriorErrorFunction.create(JaxMppca.from_components(**args), names)
    pt = PosePriorErrorFunction.create(Mppca.from_components(**args, device="cpu"), names)
    assert pt.param_index == pj.param_index == (2, -1, 0)
    np.testing.assert_array_equal(pt.sub_jtj.numpy(), np.asarray(pj.sub_jtj))
    x = np.asarray([[0.3, -0.2, 0.5, 0.7]], np.float32)
    np.testing.assert_array_equal(pt._sub_params(torch.as_tensor(x)).numpy(),
                                  np.asarray(pj._sub_params(jnp.asarray(x))))


def test_orientation_create_pads_with_identity_like_jax():
    q = np.asarray([[0.0, 0.0, np.sin(0.2), np.cos(0.2)]], np.float32)
    oj = jerr.OrientationErrorFunction.create([3], q, capacity=3)
    ot = OrientationErrorFunction.create([3], q, capacity=3, device="cpu")
    for k, v in orientation_error_to_numpy(oj).items():
        np.testing.assert_array_equal(orientation_error_to_numpy(ot)[k], v, k)


def test_limit_counts_rows_like_jax():
    jchar = jax_fullbody_character()
    tchar = port_fullbody_character()
    assert (LimitErrorFunction.create(device="cpu").num_rows_for(tchar)
            == jerr.LimitErrorFunction.create().num_rows_for(jchar) == 151)


def test_bridge_refuses_limits_the_port_lacks():
    """The bridge once refused the record types the port lacked; it now
    carries every one across: a JAX character with a Linear, LinearJoint,
    HalfPlane and Ellipsoid record each keeps them, table for table, and
    the limit energy at a pose that violates all of them is JAX's."""
    from momentum_tpu.character import limits as jl

    jchar = jax_fullbody_character()
    ell = np.diag([0.2, 0.3, 0.25, 1.0]).astype(np.float32)
    extra = [jl.create_linear(7, 8, 1.5, 0.1, weight=2.0),
             jl.create_linear_joint(2, 3, 3, 4, 0.5, -0.2),
             jl.create_halfplane(9, 10, (0.6, 0.8), 0.05, weight=3.0),
             jl.create_ellipsoid(1, 4, np.asarray([0.3, 0.1, 0.0]), ell, weight=5.0)]
    limits = jchar.limits
    for e in extra:
        limits = jl.concat_limits(limits, e)
    jbig = dataclasses.replace(jchar, limits=limits)
    tbig = bridge.character_from_numpy(character_to_numpy(jbig), device="cpu")
    assert tbig.limits.counts == jbig.limits.counts
    for k, v in character_to_numpy(jbig).items():
        if k.startswith(("minmax", "linear", "halfplane", "ellipsoid")):
            np.testing.assert_array_equal(getattr(tbig.limits, k).numpy(), v, k)
    x = np.random.default_rng(2).uniform(-0.6, 0.6, (3, jchar.num_model_parameters))
    x = x.astype(np.float32)
    jlim, tlim = jerr.LimitErrorFunction.create(), LimitErrorFunction.create(device="cpu")
    want = jax.vmap(JaxSolverFunction(jbig, (jlim,)).error)(jnp.asarray(x))
    got = SkeletonSolverFunction(tbig, (tlim,)).error(torch.as_tensor(x))
    assert float(np.min(np.asarray(want))) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ENERGY_RTOL)


def test_gauss_newton_jacobian_and_normal_paths_agree(stack):
    """GN's two branches — rows + fused Jacobian, and the normal equations —
    take the same steps on position + orientation (the modules that have
    both). Elements 1-2 only: element 0, pushed far out and without the
    limit and prior terms, solves a system so ill-conditioned that the two
    JᵀJ's last-bit differences move its first step by 1.2e-2 (ROADMAP F5);
    on elements 1-2 the steps agree to ≤ 8.4e-5 (measured)."""
    _, tchar, _, tmods, x = stack
    fn = SkeletonSolverFunction(tchar, tuple(dataclasses.replace(m, target=m.target[1:])
                                             for m in tmods[:2]))
    opts = SolverOptions(max_iterations=3, regularization=1e-5, energy_from_residual=True)
    xt = torch.as_tensor(x[1:])
    a = solve_gauss_newton(fn.residual, fn.residual_sq, xt, options=opts,
                           jacobian_fn=fn.residual_and_jacobian)
    b = solve_gauss_newton(fn.residual, fn.residual_sq, xt, options=opts,
                           normal_fn=fn.normal_equations)
    assert a.iterations == b.iterations == 3
    da, db = a.params - xt, b.params - xt
    assert float(((da - db).norm(dim=-1) / db.norm(dim=-1)).max()) <= 1e-3
    np.testing.assert_allclose(a.error.numpy(), b.error.numpy(), rtol=1e-3)


def test_gauss_newton_matches_jax_one_iteration(stack):
    """One GN step of the whole stack through solve_ik. Elements 1-2: steps
    to 1e-3 relative norm (measured 7.7e-5) and energies after the step to
    1e-4 relative (measured 4e-5). Element 0, pushed far out, solves an
    ill-conditioned system: its step differs by 9.6e-3 relative norm and
    its energy after the step by 1.0e-2 relative; held to 2e-2 (ROADMAP F5)."""
    jchar, tchar, jmods, tmods, x = stack
    opts = dict(max_iterations=1, regularization=1e-5, energy_from_residual=True)
    jfn = JaxSolverFunction(jchar, jmods, prefer_fused=True)
    tfn = SkeletonSolverFunction(tchar, tmods)
    jres = jax_solve_ik(jfn, jnp.asarray(x), None, JaxSolverOptions(**opts),
                        method="gauss_newton")
    tres = solve_ik(tfn, torch.as_tensor(x), options=SolverOptions(**opts),
                    method="gauss_newton")
    np.testing.assert_allclose(tres.error.numpy(), np.asarray(jres.error), rtol=ENERGY_RTOL)
    e_t = tfn.residual_sq(tres.params).numpy()
    e_j = np.asarray(jfn.residual_sq(jres.params))
    np.testing.assert_allclose(e_t[1:], e_j[1:], rtol=1e-4)
    np.testing.assert_allclose(e_t[0], e_j[0], rtol=2e-2)
    delta_j = np.asarray(jres.params)[1:] - x[1:]
    delta_t = tres.params.numpy()[1:] - x[1:]
    rel = np.linalg.norm(delta_t - delta_j, axis=-1) / np.linalg.norm(delta_j, axis=-1)
    assert rel.max() <= 1e-3


def test_gauss_newton_frozen_parameters_do_not_move(stack):
    _, tchar, _, tmods, x = stack
    fn = SkeletonSolverFunction(tchar, tmods)
    mask = torch.ones(x.shape[1])
    mask[:7] = 0.0  # root and global scale frozen
    res = solve_gauss_newton(fn.residual, fn.residual_sq, torch.as_tensor(x), mask,
                             SolverOptions(max_iterations=2, regularization=1e-5,
                                           energy_from_residual=True),
                             normal_fn=fn.normal_equations)
    np.testing.assert_array_equal(res.params.numpy()[:, :7], x[:, :7])
    assert np.abs(res.params.numpy()[:, 7:] - x[:, 7:]).max() > 1e-3


def test_solve_ik_reverts_failed_elements_and_counts(stack):
    """An indefinite damped system gives an all-NaN step (ROADMAP F1), and
    solve_ik hands back x0 for that element (tensor_ik.cpp:168-175)."""
    _, tchar, _, tmods, x = stack
    port_ik.reset_solve_counters()
    fn = SkeletonSolverFunction(tchar, tmods)
    xt = torch.as_tensor(x)
    res = solve_ik(fn, xt, options=SolverOptions(max_iterations=2, regularization=-1e6,
                                                 energy_from_residual=True))
    np.testing.assert_array_equal(res.params.numpy(), x)
    assert port_ik.get_solve_counters() == {"n_total_solve_ik": 3, "n_total_solve_ik_iter": 6}


def test_unported_solver_options_raise(stack):
    _, tchar, _, tmods, x = stack
    fn = SkeletonSolverFunction(tchar, tmods)
    xt = torch.as_tensor(x)
    for opts in (SolverOptions(linear_solver="qr"), SolverOptions(linear_solver="cg"),
                 SolverOptions(do_line_search=True), SolverOptions(store_history=True)):
        with pytest.raises(NotImplementedError):
            solve_gauss_newton(fn.residual, fn.error, xt, options=opts,
                               normal_fn=fn.normal_equations)
    with pytest.raises(NotImplementedError):
        solve_ik(fn, xt, method="gradient_descent")
    with pytest.raises(NotImplementedError):  # LM on the normal equations: no histories
        solve_ik(fn, xt, options=SolverOptions(store_history=True),
                 method="levenberg_marquardt")
    # limits and priors have no analytic Jacobian: their rows come by forward mode
    rows, jac = fn.residual_and_jacobian(xt)
    assert jac.shape == rows.shape + (xt.shape[-1],) and bool(torch.isfinite(jac).all())
    with pytest.raises(NotImplementedError):
        solve_levenberg_marquardt(fn.residual, fn.error, xt,
                                  options=SolverOptions(linear_solver="qr"),
                                  jacobian_fn=fn.residual_and_jacobian)


B = 64


def _jax_fullstack_solve(batch, seed=0):
    """bench.py's solve_full (bench.py:284-312), GN 2 + 1 on the worst half,
    on the JAX package: (params, marker energy)."""
    char, ef0, targets, x0, states = jax_problem(batch, seed=seed, return_states=True)
    pos, ori, lim, pp = _jax_modules(char, targets, jss.split(states)[1])
    opts = JaxSolverOptions(regularization=1e-5, energy_from_residual=True)
    cap = batch // 2

    def stage(tg, qt, x, iters):
        fn = JaxSolverFunction(char, (dataclasses.replace(pos, target=tg),
                                      dataclasses.replace(ori, target=qt), lim, pp),
                               prefer_fused=True)
        return jax_solve_ik(fn, x, None, dataclasses.replace(opts, max_iterations=iters),
                            method="gauss_newton").params

    def marker(tg, params):
        return JaxSolverFunction(char, (dataclasses.replace(ef0, target=tg),)).error(params)

    @jax.jit
    def solve(tg, qt, x0):
        p1 = stage(tg, qt, x0, 2)
        e1 = marker(tg, p1)
        _, idx = jax.lax.top_k(jnp.nan_to_num(e1, nan=3e38, posinf=3e38), cap)
        p2 = stage(tg[idx], qt[idx], p1[idx], 1)
        return p1.at[idx].set(p2), e1.at[idx].set(marker(tg[idx], p2))

    return solve(targets, jss.split(states)[1], x0)


def test_fullstack_problem_matches_jax():
    char, efs, targets, q, x0 = twork.build_fullstack_problem(8, seed=0, device="cpu")
    _, _, targets_j, x0_j, states_j = jax_problem(8, seed=0, return_states=True)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(x0_j))
    np.testing.assert_allclose(targets.numpy(), np.asarray(targets_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jss.split(states_j)[1]), rtol=0,
                               atol=1e-6)
    assert [type(e).__name__ for e in efs] == [
        "PositionErrorFunction", "OrientationErrorFunction", "LimitErrorFunction",
        "PosePriorErrorFunction"]
    assert efs[3].param_index == tuple(range(char.num_model_parameters))


def test_fullstack_solve_matches_jax():
    """The slice as a whole: bench.py's full-stack recipe at B = 64, seed 0,
    on both packages: the same marker convergence statistics."""
    _, e_j = _jax_fullstack_solve(B)
    e_j = np.asarray(e_j)
    char, efs, targets, q, x0 = twork.build_fullstack_problem(B, seed=0, device="cpu")
    params, e_t, _ = twork.make_fullstack_solve(char, efs, B)(targets, q, x0)
    e_t = e_t.numpy()
    assert params.shape == x0.shape and torch.isfinite(params).all()
    assert np.all(np.isfinite(e_t)) and np.all(np.isfinite(e_j))
    assert abs(np.mean(e_t < 1e-5) - np.mean(e_j < 1e-5)) <= 2 / B
    assert abs(np.median(e_t) / np.median(e_j) - 1) <= 0.2
    assert np.mean(e_t < 1e-5) >= 0.98
