"""Parity of the port's solver family with momentum_tpu on the CPU: the
SolveResult and SolverOptions layouts (ROADMAP F19), Gauss-Newton by QR,
by matrix-free CG and with the line search, the histories, gradient
descent, LM by QR and with the carried Jacobian, `verbose`, solve_ik's
routing, the solver classes, the solver variants of config D's problem
(with tools/jax_reference.py's recipe), and solve_multipose on config 5's
test rig.

Tolerances (tests/test_solver.py's): parameters to 2e-4 absolute on the
small problems (the linear least squares and the 4-joint rig, whose
solves are well conditioned), energies to 1e-3 relative or 1e-9 (a
converged element's energy is float32 roundoff, ~1e-12), histories as the
parameters (their energies, of intermediate iterates, to 1e-2). The
sequence solve as test_torch_port_sequence.py's: the error to 1e-3
relative, parameters to 1e-3 absolute.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu.errors import LimitErrorFunction as JLimit
from momentum_tpu.errors import PositionErrorFunction as JPos
from momentum_tpu.sequence import solver_function as jsf
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.solver import gauss_newton as jgn
from momentum_tpu.solver import solvers as jsolvers
from momentum_tpu.solver.ik import solve_ik as jax_solve_ik
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu_torch.errors import LimitErrorFunction as TLimit
from momentum_tpu_torch.errors import PositionErrorFunction as TPos
from momentum_tpu_torch.sequence import solver_function as tsf
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn
from momentum_tpu_torch.solver import SolverOptions as TOpts
from momentum_tpu_torch.solver import gauss_newton as tgn
from momentum_tpu_torch.solver import solve_ik, solvers as tsolvers
from momentum_tpu_torch.testing import workloads
from momentum_tpu_torch.testing.fixtures import create_test_character

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402
from test_torch_port_helpers import one_torch_thread  # noqa: F401

PARAM_ATOL = 2e-4
ERR_RTOL = 1e-3
ERR_ATOL = 1e-9  # a converged energy is float32 roundoff, ~1e-12
HIST_RTOL = 1e-2  # the energies of intermediate float32 iterates (measured 1.5e-3)
B = 4


def test_solve_result_has_jax_layout():
    """F19: SolveResult's fields are JAX's, in JAX's order, so positional
    construction and indexing mean the same in both packages."""
    assert tgn.SolveResult._fields == jgn.SolveResult._fields == (
        "params", "error", "iterations", "converged", "error_history", "param_history",
        "lambda_final")
    res = tgn.SolveResult(*range(7))
    assert (res.error_history, res.param_history, res.lambda_final) == (4, 5, 6)
    assert tgn.SolveResult(*range(4)).error_history is None


def test_solver_options_take_every_jax_field():
    """Every field of JAX's SolverOptions, in JAX's order, with JAX's default."""
    t_fields = dataclasses.fields(TOpts)
    j_fields = dataclasses.fields(JOpts)
    assert [f.name for f in t_fields] == [f.name for f in j_fields]
    for tf, jf in zip(t_fields, j_fields):
        assert tf.default == jf.default, tf.name


def _linear(seed, rows, cols):
    """A linear least-squares problem r(x) = A x − b in both packages (the
    batched form broadcasts over x's leading dimensions)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (rows, cols)).astype(np.float32)
    b = rng.normal(0, 1, rows).astype(np.float32)
    aj, bj, at, bt = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)

    def jres(x):
        return jnp.einsum("rp,...p->...r", aj, x) - bj

    def tres(x):
        return x @ at.T - bt

    def energy(res):
        return lambda x: (res(x) ** 2).sum(-1)

    return (jres, energy(jres)), (tres, energy(tres)), a, b


@pytest.mark.parametrize("solver,kw", [
    ("solve_gauss_newton", dict(linear_solver="qr")),
    ("solve_levenberg_marquardt", dict(linear_solver="qr")),
    ("solve_gauss_newton", dict(linear_solver="cg", cg_iterations=32, cg_tol=1e-9)),
], ids=["gn_qr", "lm_qr", "gn_cg"])
def test_linear_least_squares_match_jax_and_cholesky(solver, kw):
    """QR and CG give the Cholesky path's steps (test_solver.py's linear
    problems), in the port as in JAX, and reach the least-squares optimum."""
    (jr, je), (tr, te), a, b = _linear(3, 10, 4)
    x0 = np.zeros(4, np.float32)
    tsolve, jsolve = getattr(tgn, solver), getattr(jgn, solver)
    opts = dict(max_iterations=8, **kw)
    res_t = tsolve(tr, te, torch.as_tensor(x0), options=TOpts(**opts))
    res_j = jsolve(jr, je, jnp.asarray(x0), options=JOpts(**opts))
    res_c = tsolve(tr, te, torch.as_tensor(x0), options=TOpts(max_iterations=8))
    np.testing.assert_allclose(res_t.params.numpy(), np.asarray(res_j.params), atol=PARAM_ATOL)
    np.testing.assert_allclose(res_t.params.numpy(), res_c.params.numpy(), atol=PARAM_ATOL)
    xstar = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(res_t.params.numpy(), xstar, atol=1e-3)


def test_cg_masks_and_batches_like_jax():
    """CG with an enabled mask keeps the frozen parameters at x0 exactly; on
    a batch every element runs its own CG and lands on the unbatched
    solve's parameters (test_solver.py's test, against JAX's)."""
    (jr, je), (tr, te), _, _ = _linear(7, 12, 5)
    mask = np.asarray([1, 1, 0, 1, 0], np.float32)
    opts = dict(max_iterations=8, linear_solver="cg")
    res_t = tgn.solve_gauss_newton(tr, te, torch.zeros(5), torch.as_tensor(mask),
                                   TOpts(**opts))
    res_j = jgn.solve_gauss_newton(jr, je, jnp.zeros(5), jnp.asarray(mask), JOpts(**opts))
    assert float(res_t.params[2]) == 0.0 and float(res_t.params[4]) == 0.0
    np.testing.assert_allclose(res_t.params.numpy(), np.asarray(res_j.params), atol=PARAM_ATOL)
    x0b = np.random.default_rng(7).normal(0, 0.1, (4, 5)).astype(np.float32)
    res_b = tgn.solve_gauss_newton(tr, te, torch.as_tensor(x0b), options=TOpts(**opts))
    res_jb = jgn.solve_gauss_newton(jr, je, jnp.asarray(x0b), options=JOpts(**opts))
    res_c = tgn.solve_gauss_newton(tr, te, torch.zeros(5), options=TOpts(max_iterations=8))
    np.testing.assert_allclose(res_b.params.numpy(), np.asarray(res_jb.params), atol=PARAM_ATOL)
    for i in range(4):
        np.testing.assert_allclose(res_b.params[i].numpy(), res_c.params.numpy(), atol=5e-4)


@pytest.fixture(scope="module")
def rig():
    """(JAX fn, port fn, x0 (B, P)): the 4-joint test rig's locators at B
    random poses as position targets, x0 zeros plus 0.1 noise."""
    jchar = jax_test_character(4)
    tchar = create_test_character(4, device="cpu")
    p = jchar.num_model_parameters
    rng = np.random.default_rng(12)
    truth = rng.uniform(-0.4, 0.4, (B, p)).astype(np.float32)
    targets = np.array(jax.vmap(lambda t: jchar.locators.world_positions(
        jchar.skeleton_states(t)))(jnp.asarray(truth)))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    jfn = JFn(jchar, (dataclasses.replace(JPos.create(*args), target=jnp.asarray(targets)),))
    tfn = TFn(tchar, (dataclasses.replace(TPos.create(*args, device="cpu"),
                                          target=torch.as_tensor(targets)),))
    x0 = (truth + rng.normal(0, 0.1, truth.shape)).astype(np.float32)
    return jfn, tfn, x0


_VARIANTS = {
    "gn_qr": ("solve_gauss_newton", dict(linear_solver="qr"), {}),
    "gn_cg": ("solve_gauss_newton", dict(linear_solver="cg"), {}),
    "gn_line_search": ("solve_gauss_newton", dict(do_line_search=True), {}),
    "gn_history": ("solve_gauss_newton", dict(store_history=True), {}),
    "gn_cg_history": ("solve_gauss_newton", dict(linear_solver="cg", store_history=True), {}),
    "lm_qr": ("solve_levenberg_marquardt", dict(linear_solver="qr"), {}),
    "lm_history": ("solve_levenberg_marquardt", dict(store_history=True), {}),
    "lm_carry_jacobian": ("solve_levenberg_marquardt",
                          dict(carry_jacobian=True, energy_from_residual=True,
                               store_history=True), {}),
    "gradient_descent": ("solve_gradient_descent", dict(), dict(learning_rate=0.002)),
}


@pytest.mark.parametrize("name", sorted(_VARIANTS))
def test_solver_variant_matches_jax(rig, name):
    """Each solver variant, batch-native on the 4-joint rig from the same
    warm starts with the analytic Jacobian, against JAX's: parameters,
    energies, iterations, LM's damping and the histories."""
    jfn, tfn, x0 = rig
    solver, kw, extra = _VARIANTS[name]
    opts = dict(max_iterations=6, regularization=1e-3, **kw)
    if solver == "solve_gauss_newton" and kw.get("linear_solver") == "cg":
        res_j = jgn.solve_gauss_newton(jfn.residual, jfn.error, jnp.asarray(x0),
                                       options=JOpts(**opts))
        res_t = tgn.solve_gauss_newton(tfn.residual, tfn.error, torch.as_tensor(x0),
                                       options=TOpts(**opts))
    else:
        res_j = getattr(jgn, solver)(jfn.residual, jfn.error, jnp.asarray(x0),
                                     options=JOpts(**opts),
                                     jacobian_fn=jfn.residual_and_jacobian, **extra)
        res_t = getattr(tgn, solver)(tfn.residual, tfn.error, torch.as_tensor(x0),
                                     options=TOpts(**opts),
                                     jacobian_fn=tfn.residual_and_jacobian, **extra)
    assert res_t.iterations == int(res_j.iterations)
    np.testing.assert_allclose(res_t.params.numpy(), np.asarray(res_j.params), atol=PARAM_ATOL)
    np.testing.assert_allclose(res_t.error.numpy(), np.asarray(res_j.error), rtol=ERR_RTOL,
                               atol=ERR_ATOL)
    np.testing.assert_array_equal(res_t.converged.numpy(), np.asarray(res_j.converged))
    if res_j.lambda_final is not None:
        np.testing.assert_allclose(res_t.lambda_final.numpy(), np.asarray(res_j.lambda_final))
    if kw.get("store_history"):
        assert res_t.error_history.shape == (6, B)
        assert res_t.param_history.shape == (6, B, x0.shape[1])
        np.testing.assert_allclose(res_t.param_history.numpy(),
                                   np.asarray(res_j.param_history), atol=PARAM_ATOL)
        np.testing.assert_allclose(res_t.error_history.numpy(),
                                   np.asarray(res_j.error_history), rtol=HIST_RTOL,
                                   atol=ERR_ATOL)
    else:
        assert res_t.error_history is None and res_t.param_history is None


def test_verbose_prints_each_iteration(rig, capsys):
    """verbose: one line a GN, CG or LM iteration with the mean energy."""
    _, tfn, x0 = rig
    for solver, kw, tag in ((tgn.solve_gauss_newton, {}, "GN iter"),
                            (tgn.solve_gauss_newton, dict(linear_solver="cg"), "GN-CG iter"),
                            (tgn.solve_levenberg_marquardt, {}, "LM iter")):
        res = solver(tfn.residual, tfn.error, torch.as_tensor(x0),
                     options=TOpts(max_iterations=3, verbose=True, **kw))
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(tag + " ")]
        assert len(lines) == res.iterations == 3


def test_solve_ik_routes_like_jax(rig):
    """solve_ik's gradient descent runs and matches JAX's; with limits (a
    module with direct normal equations) the QR path takes the rows, not
    normal_fn, in both packages, and the Cholesky path the normal equations."""
    jfn, tfn, x0 = rig
    opts = dict(max_iterations=6, regularization=1e-3)
    res_t = solve_ik(tfn, torch.as_tensor(x0), options=TOpts(**opts), method="gradient_descent")
    res_j = jax_solve_ik(jfn, jnp.asarray(x0), None, JOpts(**opts), method="gradient_descent")
    np.testing.assert_allclose(res_t.params.numpy(), np.asarray(res_j.params), atol=PARAM_ATOL)
    jfl = JFn(jfn.character, jfn.error_functions + (JLimit.create(),))
    tfl = TFn(tfn.character, tfn.error_functions + (TLimit.create(device="cpu"),))
    assert tfl.has_structured_modules
    for solver in ("qr", "cholesky"):
        o = dict(opts, linear_solver=solver)
        rt = solve_ik(tfl, torch.as_tensor(x0), options=TOpts(**o))
        rj = jax_solve_ik(jfl, jnp.asarray(x0), None, JOpts(**o))
        np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), atol=PARAM_ATOL)
        np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error), rtol=ERR_RTOL,
                                   atol=ERR_ATOL)
    with pytest.raises(ValueError, match="unknown method"):
        solve_ik(tfn, torch.as_tensor(x0), method="newton")


@pytest.mark.parametrize("cls", ["GaussNewtonSolver", "GaussNewtonSolverQR",
                                 "SubsetGaussNewtonSolver", "SparseGaussNewtonSolver",
                                 "TrustRegionQR", "GradientDescentSolver"])
def test_solver_class_matches_jax(rig, cls):
    """Each IK solver class on one element of the rig (x0 of shape (P,))
    with a subset enabled and histories on: its options, solve, get_error
    and histories against JAX's class."""
    jfn, tfn, x0 = rig
    jfn = JFn(jfn.character, (dataclasses.replace(jfn.error_functions[0],
                                                  target=jfn.error_functions[0].target[0]),))
    tfn = TFn(tfn.character, (dataclasses.replace(tfn.error_functions[0],
                                                  target=tfn.error_functions[0].target[0]),))
    x0 = x0[0]
    mask = np.ones(x0.shape[0], np.float32)
    mask[[2, 5]] = 0.0
    opts = dict(max_iterations=5, regularization=1e-3)
    js = getattr(jsolvers, cls)(jfn, JOpts(**opts))
    ts = getattr(tsolvers, cls)(tfn, TOpts(**opts))
    assert ts.options.linear_solver == js.options.linear_solver
    for s in (js, ts):
        s.set_enabled_parameters(mask)
        s.set_store_history()
    pt = ts.solve(x0).numpy()
    pj = np.asarray(js.solve(jnp.asarray(x0)))
    np.testing.assert_array_equal(pt[mask == 0], x0[mask == 0])
    np.testing.assert_allclose(pt, pj, atol=PARAM_ATOL)
    assert abs(ts.get_error(pt) - js.get_error(jnp.asarray(pj))) <= (
        ERR_RTOL * js.get_error(jnp.asarray(pj)) + ERR_ATOL)
    if cls == "GradientDescentSolver":  # no histories, as in JAX
        assert ts.error_history is None and js.error_history is None
    else:
        np.testing.assert_allclose(ts.parameter_history.numpy(),
                                   np.asarray(js.parameter_history), atol=PARAM_ATOL)
        assert ts.error_history.shape == js.error_history.shape == (5,)


def test_variant_recipe_is_the_tools():
    assert workloads.variant_recipe() == jax_reference.variant_recipe()


@pytest.fixture(scope="module")
def config_d():
    return workloads.build_diff_ik_problem(8, device="cpu")


@pytest.mark.parametrize("name", sorted(workloads.variant_recipe()))
def test_config_d_variant_runs(config_d, name):
    """Each solver variant on config D's position problem at B = 8 (the
    full-body rig), as chip_smoke.py runs it at B = 2048 against the JAX
    tool's figures: every iteration run, every element finite, the GN and
    LM variants below 1e-3 of the warm start's median energy, the
    histories' shapes. (Each variant's parity with JAX is the 4-joint
    rig's tests above.)"""
    solver, res = workloads.solve_variant(config_d, name)
    _, opts, _ = workloads.variant_recipe()[name]
    fn = TFn(config_d.char, (dataclasses.replace(config_d.ef0, target=config_d.targets),))
    e = fn.error(res.params).numpy()
    e0 = fn.error(config_d.x0).numpy()
    assert res.iterations == opts["max_iterations"] and np.isfinite(e).all()
    if name != "gradient_descent":
        assert np.median(e) < 1e-3 * np.median(e0)
    if opts.get("store_history"):
        assert solver.error_history.shape == (5, 8)
        assert solver.parameter_history.shape == (5, 8, config_d.x0.shape[1])


def test_solve_multipose_matches_jax():
    """solve_multipose (and MultiposeSolver) on config 5's 16-joint test rig:
    12 poses sharing one universal parameter (6), no sequence module;
    GN 12 (converged) against JAX's."""
    frames = 12
    jchar, tchar = jax_test_character(16), create_test_character(16, device="cpu")
    p = jchar.num_model_parameters
    gt = np.random.default_rng(0).uniform(-0.2, 0.2, (frames, p)).astype(np.float32)
    targets = np.array(jax.vmap(jchar.locators.world_positions)(
        jax.vmap(jchar.skeleton_states)(jnp.asarray(gt))))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    jef = jax.vmap(lambda t: dataclasses.replace(JPos.create(*args), target=t))(
        jnp.asarray(targets))
    tef = tsf.stack_frames([dataclasses.replace(TPos.create(*args, device="cpu"),
                                                target=torch.as_tensor(t)) for t in targets])
    universal = np.zeros(p, bool)
    universal[6] = True
    jfn = jsf.SequenceSolverFunction.create(jchar, frames, universal=universal,
                                            per_frame_errors=(jef,))
    tfn = tsf.SequenceSolverFunction.create(tchar, frames, universal=universal,
                                            per_frame_errors=(tef,))
    jpf, ju = jfn.split(jnp.zeros((frames, p)))
    tpf, tu = tfn.split(torch.zeros(frames, p))
    opts = dict(max_iterations=12)
    jres = jsolvers.solve_multipose(jfn, jpf, ju, JOpts(**opts))
    tres = tsolvers.solve_multipose(tfn, tpf, tu, TOpts(**opts))
    assert tres.iterations == int(jres.iterations)
    assert abs(float(tres.error) / float(jres.error) - 1) <= ERR_RTOL
    np.testing.assert_allclose(tres.per_frame.numpy(), np.asarray(jres.per_frame), atol=1e-3)
    np.testing.assert_allclose(tres.universal.numpy(), np.asarray(jres.universal), atol=1e-3)
    cls = tsolvers.MultiposeSolver(tfn, TOpts(**opts))
    out = cls.solve(tpf, tu)
    assert cls.last_result is out
    np.testing.assert_array_equal(out.per_frame.numpy(), tres.per_frame.numpy())
    for seq_cls in (tsolvers.SequenceSolver, tsolvers.SequenceCholeskySolver):
        np.testing.assert_allclose(seq_cls(tfn, TOpts(**opts)).solve(tpf, tu).per_frame.numpy(),
                                   tres.per_frame.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="no sequence error functions"):
        tsolvers.solve_multipose(dataclasses.replace(tfn, sequence_errors=(object(),)), tpf, tu)
