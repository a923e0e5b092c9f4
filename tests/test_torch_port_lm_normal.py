"""Parity of the port's Levenberg-Marquardt on the normal equations and with
a parameter mask with momentum_tpu's on the CPU: solve_levenberg_marquardt's
`normal_fn` and `enabled_mask` branches, solve_ik's LM dispatch over the full
residual stack (position + orientation + limits + pose prior), and
benchmarks/bench_suite.py config 2: its single frame (LM 20, :118-155) and
2b's 40-iteration LM optimum on bench.py's full-stack problem at B = 64
(:229-231), against which 2b scores the GN 2 + 1 solve.

Tolerances, each with what this file measured:
  * final energies 1e-3 relative (measured: the 40-iteration optimum
    ≤ 1.2e-6 per element, the single frame 7e-7, the masked solves ≤ 1.3e-6);
    the solves are compared by energy, not raw parameters (ROADMAP F5);
  * frozen parameters exactly (they never move);
  * 2b's conv_at_1e5 (GN energy within 1e-5 of the optimum's) exactly:
    both 3 of 64.
"""

import dataclasses
import inspect
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.math import skel_state as jss
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.solver.gauss_newton import solve_levenberg_marquardt as jax_lm
from momentum_tpu.solver.ik import solve_ik as jax_solve_ik
from momentum_tpu.testing.workloads import build_fullbody_ik_problem as jax_problem
from momentum_tpu_torch.solver import (
    SkeletonSolverFunction, SolverOptions, solve_ik, solve_levenberg_marquardt)
from momentum_tpu_torch.testing import workloads as twork

from test_torch_port_helpers import (
    jax_fullstack_modules, port_fullbody_character, port_fullstack_modules)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

ENERGY_RTOL = 1e-3
B = 64


@pytest.fixture(scope="module")
def stack():
    """bench.py's full-stack problem at B = 64, seed 0, on both packages
    (the port's carried across by the bridge): (JAX solver-function maker,
    port solver-function maker, targets, q, x0)."""
    jchar, ef0, targets, x0, states = jax_problem(B, seed=0, return_states=True)
    q = jss.split(states)[1]
    jmods = jax_fullstack_modules(jchar)
    tchar = port_fullbody_character()
    tmods = port_fullstack_modules(jmods)

    def jfn(tg, qt, mods=(0, 1, 2, 3)):
        m = (dataclasses.replace(jmods[0], target=tg), dataclasses.replace(jmods[1], target=qt),
             *jmods[2:])
        return JFn(jchar, tuple(m[i] for i in mods), prefer_fused=True)

    def tfn(tg, qt, mods=(0, 1, 2, 3)):
        m = (dataclasses.replace(tmods[0], target=torch.as_tensor(np.asarray(tg))),
             dataclasses.replace(tmods[1], target=torch.as_tensor(np.asarray(qt))), *tmods[2:])
        return SkeletonSolverFunction(tchar, tuple(m[i] for i in mods))

    return jfn, tfn, targets, q, np.asarray(x0)


def _mask(p):
    mask = np.ones(p, np.float32)
    mask[:7] = 0.0  # root and global scale frozen
    mask[40:46] = 0.0
    return mask


def test_lm_takes_jax_positional_arguments():
    """F11: the port's LM has JAX's signature, enabled_mask fourth."""
    names = list(inspect.signature(solve_levenberg_marquardt).parameters)
    assert names == list(inspect.signature(jax_lm).parameters) == [
        "residual_fn", "error_fn", "x0", "enabled_mask", "options", "jacobian_fn",
        "normal_fn", "lambda0"]


def test_lm_masked_normal_equations_match_jax(stack):
    """LM on the normal equations with 13 parameters frozen, 5 iterations,
    through solve_ik: the frozen parameters stay exactly at x0, and the
    energies match JAX's."""
    jfn, tfn, targets, q, x0 = stack
    x0, tg, qt = x0[:8], targets[:8], q[:8]
    mask = _mask(x0.shape[1])
    opts = dict(max_iterations=5, regularization=1e-5, energy_from_residual=True)
    rj = jax_solve_ik(jfn(tg, qt), jnp.asarray(x0), jnp.asarray(mask), JOpts(**opts),
                      method="levenberg_marquardt")
    fn = tfn(tg, qt)
    # every module of the stack has an analytic Jacobian, the pose prior's
    # too since F26, as in JAX: the normal equations still take the solve
    assert fn.has_structured_modules and fn.fully_analytic == jfn(tg, qt).fully_analytic
    rt = solve_ik(fn, torch.as_tensor(x0), torch.as_tensor(mask), SolverOptions(**opts),
                  method="levenberg_marquardt")
    frozen = mask == 0
    np.testing.assert_array_equal(rt.params.numpy()[:, frozen], x0[:, frozen])
    np.testing.assert_array_equal(np.asarray(rj.params)[:, frozen], x0[:, frozen])
    assert np.abs(rt.params.numpy()[:, ~frozen] - x0[:, ~frozen]).max() > 1e-3
    np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error), rtol=ENERGY_RTOL)
    np.testing.assert_allclose(fn.residual_sq(rt.params).numpy(),
                               np.asarray(jfn(tg, qt).residual_sq(rj.params)),
                               rtol=ENERGY_RTOL)


def test_lm_masked_jacobian_matches_jax(stack):
    """LM on the analytic rows (position + orientation, their fused
    Jacobians) with the same mask, the exact energy: frozen parameters
    exact, energies as JAX's."""
    jfn, tfn, targets, q, x0 = stack
    x0, tg, qt = x0[:8], targets[:8], q[:8]
    mask = _mask(x0.shape[1])
    opts = dict(max_iterations=4, regularization=1e-5)
    jf, tf = jfn(tg, qt, (0, 1)), tfn(tg, qt, (0, 1))
    rj = jax_lm(jf.residual, jf.error, jnp.asarray(x0), jnp.asarray(mask), JOpts(**opts),
                jacobian_fn=jf.residual_and_jacobian)
    assert tf.fully_analytic
    rt = solve_levenberg_marquardt(tf.residual, tf.error, torch.as_tensor(x0),
                                   torch.as_tensor(mask), SolverOptions(**opts),
                                   tf.residual_and_jacobian)
    frozen = mask == 0
    np.testing.assert_array_equal(rt.params.numpy()[:, frozen], x0[:, frozen])
    np.testing.assert_allclose(rt.error.numpy(), np.asarray(rj.error), rtol=ENERGY_RTOL)


def test_lm_normal_fn_every_iteration_and_first_energy(stack):
    """As JAX (gauss_newton.py:528-531, 579-583): with normal_fn the solver
    evaluates it at every iteration's x, after a reject too, and the first
    energy is error_fn(x0) even with energy_from_residual."""
    _, tfn, targets, q, x0 = stack
    fn = tfn(targets[:4], q[:4])
    calls = []

    def uphill(x):
        """The normal equations with Jᵀr negated: every step climbs and is
        rejected, so x stays x0."""
        calls.append(x.clone())
        jtj, jtr, sq = fn.normal_equations(x)
        return jtj, -jtr, sq

    xt = torch.as_tensor(x0[:4])
    opts = SolverOptions(max_iterations=4, regularization=1e-5, energy_from_residual=True)
    res = solve_levenberg_marquardt(fn.residual, fn.residual_sq, xt, options=opts,
                                    normal_fn=uphill)
    assert res.iterations == len(calls) == 4 and not bool(res.converged.any())
    assert all(torch.equal(c, xt) for c in calls) and torch.equal(res.params, xt)
    np.testing.assert_allclose(res.lambda_final.numpy(), 0.01 * 10.0 ** 4, rtol=1e-6)
    never = solve_levenberg_marquardt(fn.residual, lambda x: fn.residual_sq(x) + 1.0, xt,
                                      options=dataclasses.replace(opts, max_iterations=0),
                                      normal_fn=fn.normal_equations)
    np.testing.assert_array_equal(never.error.numpy(), (fn.residual_sq(xt) + 1.0).numpy())


def test_config2_frame_matches_jax():
    """bench_suite.py config 2's single frame: the same draws as JAX, and
    the final LM energy within 1e-3 (measured 7e-7)."""
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char_t, efs_t, x0_t = twork.build_fullstack_frame(device="cpu")
    jchar = create_fullbody_character()
    p = jchar.num_model_parameters
    rng = np.random.default_rng(0)
    gt = jnp.asarray(rng.uniform(-0.3, 0.3, p).astype(np.float32))
    states = jchar.skeleton_states(gt)
    pos, ori, lim, pp = jax_fullstack_modules(jchar)
    fn = JFn(jchar, (dataclasses.replace(pos, target=jchar.locators.world_positions(states)),
                     dataclasses.replace(ori, target=jss.split(states)[1]), lim, pp))
    x0 = gt + 0.05 * jnp.asarray(rng.normal(0, 1, p).astype(np.float32))
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0))
    np.testing.assert_allclose(efs_t[0].target.numpy(), np.asarray(fn.error_functions[0].target),
                               rtol=0, atol=1e-5)
    rj = jax_solve_ik(fn, x0, None, JOpts(max_iterations=20), method="levenberg_marquardt")
    rt = twork.solve_fullstack_frame(char_t, efs_t, x0_t)
    assert rt.params.shape == x0_t.shape and rt.error.shape == ()
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=ENERGY_RTOL)


def test_config2b_lm_optimum_and_convergence_match_jax(stack):
    """2b at B = 64: each element's 40-iteration LM optimum on the normal
    equations (energies within 1e-3, measured ≤ 1.2e-6), and the GN 2 + 1
    solve's conv_at_1e5 against it, exactly as JAX's. JAX's solves run in a
    thread meanwhile (XLA runs outside the GIL)."""
    jfn, _, targets, q, x0 = stack
    opts = JOpts(max_iterations=40, regularization=1e-5, energy_from_residual=True)

    def jax_side():
        ref_j = jax.jit(lambda x: jax_solve_ik(jfn(targets, q), x, None, opts,
                                               method="levenberg_marquardt"))(jnp.asarray(x0))
        gn = dataclasses.replace(opts, max_iterations=2, regularization=1e-5)
        r1 = jax_solve_ik(jfn(targets, q), jnp.asarray(x0), None, gn, method="gauss_newton")
        marker = jfn(targets, q, (0,)).error(r1.params)
        _, idx = jax.lax.top_k(marker, B // 2)
        r2 = jax_solve_ik(jfn(targets[idx], q[idx]), r1.params[idx], None,
                          dataclasses.replace(gn, max_iterations=1), method="gauss_newton")
        return np.asarray(ref_j.error), np.asarray(r1.error.at[idx].set(r2.error))

    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_side)
        char, efs, tg, qt, x0_t = twork.build_fullstack_problem(B, seed=0, device="cpu")
        ref_t = twork.fullstack_lm_optimum(char, efs, tg, qt, x0_t)
        _, _, err_t = twork.make_fullstack_solve(char, efs, B)(tg, qt, x0_t)
        ref_j_error, err_j = jax_run.result()
    np.testing.assert_array_equal(x0_t.numpy(), x0)
    np.testing.assert_allclose(ref_t.error.numpy(), ref_j_error, rtol=ENERGY_RTOL)
    conv_t = np.mean(err_t.numpy() - ref_t.error.numpy() < 1e-5)
    conv_j = np.mean(err_j - ref_j_error < 1e-5)
    assert conv_t == conv_j == 3 / 64
