"""Parity of the port's position residuals and fused model-space Jacobian
(PositionErrorFunction, analytic_jacobian.fused_point_jacobian_model_merged,
SkeletonSolverFunction) with momentum_tpu on the full-body rig, B = 8.

Tolerance 1e-5 abs (rows and Jacobian entries are O(1) on this rig; both
sides are float32 chains of FK + a few contractions whose summation order
differs between the frameworks)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.errors import PositionErrorFunction as JPos
from momentum_tpu.math.generalized_loss import GeneralizedLoss as JLoss
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu_torch.bridge import position_error_from_numpy
from momentum_tpu_torch.errors import PositionErrorFunction as TPos
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss as TLoss
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn

from test_torch_port_helpers import (
    jax_fullbody_character, port_fullbody_character, position_error_to_numpy)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 8


@pytest.fixture(scope="module")
def problem():
    char_j = jax_fullbody_character()
    char_t = port_fullbody_character()
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.3, 0.3, (B, char_j.num_model_parameters)).astype(np.float32)
    n_loc = char_j.locators.num_locators
    targets = rng.normal(0, 0.5, (B, n_loc, 3)).astype(np.float32)
    cweight = rng.uniform(0.5, 2.0, n_loc).astype(np.float32)
    return char_j, char_t, x, targets, cweight


def _error_functions(problem, loss_j=None, capacity=None):
    char_j, _, _, targets, cweight = problem
    ef_j = JPos.create(np.asarray(char_j.locators.parent),
                       np.asarray(char_j.locators.offset),
                       np.zeros((char_j.locators.num_locators, 3)), cweight=cweight,
                       weight=1.7, loss=loss_j, capacity=capacity)
    tgt = np.zeros((B, ef_j.parent.shape[0], 3), np.float32)
    tgt[:, :targets.shape[1]] = targets
    ef_j = dataclasses.replace(ef_j, target=jnp.asarray(tgt))
    return ef_j, position_error_from_numpy(position_error_to_numpy(ef_j), device="cpu")


@pytest.mark.parametrize("loss", [None, (0.0, 0.5), (1.0, 2.0), (-0.5, 1.0)],
                         ids=["l2", "cauchy", "l1", "general"])
def test_rows_and_energy_match_jax(problem, loss):
    char_j, char_t, x, _, _ = problem
    ef_j, ef_t = _error_functions(problem, loss_j=None if loss is None else JLoss(*loss))
    fn_j, fn_t = JFn(char_j, (ef_j,)), TFn(char_t, (ef_t,))
    x_t = torch.as_tensor(x)
    np.testing.assert_allclose(fn_t.residual(x_t).numpy(),
                               np.asarray(fn_j.residual(jnp.asarray(x))), **TOL)
    e_j = np.asarray(fn_j.error(jnp.asarray(x)))
    np.testing.assert_allclose(fn_t.error(x_t).numpy(), e_j, rtol=1e-5)


def test_fused_model_jacobian_matches_jax(problem):
    char_j, char_t, x, _, _ = problem
    ef_j, ef_t = _error_functions(problem)
    rows_j, jac_j = JFn(char_j, (ef_j,), prefer_fused=True).residual_and_jacobian(
        jnp.asarray(x))
    rows_t, jac_t = TFn(char_t, (ef_t,)).residual_and_jacobian(torch.as_tensor(x))
    assert jac_t.shape == (B, 3 * 80, char_t.num_model_parameters)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **TOL)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), **TOL)


def test_fused_model_jacobian_matches_finite_differences(problem):
    """The port's Jacobian is the derivative of its own rows: central
    differences with step 1e-2 on a few parameters, at 2e-3 abs (O(step²)
    truncation plus float32 rounding of the rows divided by the step)."""
    _, char_t, x, _, _ = problem
    _, ef_t = _error_functions(problem)
    fn = TFn(char_t, (ef_t,))
    _, jac = fn.residual_and_jacobian(torch.as_tensor(x[:1]))
    eps = 1e-2
    for p in (0, 3, 6, 40, 156):
        dx = np.zeros_like(x[:1])
        dx[0, p] = eps
        hi = fn.residual(torch.as_tensor(x[:1] + dx)).double()
        lo = fn.residual(torch.as_tensor(x[:1] - dx)).double()
        fd = ((hi - lo) / (2 * eps)).numpy()
        np.testing.assert_allclose(jac[0, :, p].numpy(), fd[0], atol=2e-3)


def test_padded_rows_are_zero(problem):
    """Capacity padding adds rows with parent 0 and weight 0 (ROADMAP F3):
    their rows and Jacobian rows vanish and the rest match JAX."""
    char_j, char_t, x, _, _ = problem
    ef_j, ef_t = _error_functions(problem, capacity=96)
    rows_j, jac_j = JFn(char_j, (ef_j,), prefer_fused=True).residual_and_jacobian(
        jnp.asarray(x))
    rows_t, jac_t = TFn(char_t, (ef_t,)).residual_and_jacobian(torch.as_tensor(x))
    assert rows_t.shape == (B, 3 * 96)
    assert torch.all(rows_t[:, 240:] == 0) and torch.all(jac_t[:, 240:] == 0)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **TOL)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), **TOL)


@pytest.mark.parametrize("alpha,c", [(2.0, 1.0), (2.0, 0.3), (1.0, 1.5), (0.0, 0.7),
                                     (-1e9, 1.0), (0.5, 1.0), (-2.0, 2.0)])
def test_generalized_loss_matches_jax(rng, alpha, c):
    s = rng.uniform(0, 5, 100).astype(np.float32)
    lj, lt = JLoss(alpha, c), TLoss(alpha, c)
    np.testing.assert_allclose(lt.value(torch.as_tensor(s)).numpy(),
                               np.asarray(lj.value(jnp.asarray(s))), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lt.deriv(torch.as_tensor(s)).numpy(),
                               np.asarray(lj.deriv(jnp.asarray(s))), rtol=1e-5, atol=1e-7)


def test_create_matches_jax_tables(problem):
    char_j, _, _, _, cweight = problem
    args = (np.asarray(char_j.locators.parent), np.asarray(char_j.locators.offset),
            np.ones((80, 3)))
    ef_j = JPos.create(*args, cweight=cweight, weight=0.5, capacity=100)
    ef_t = TPos.create(*args, cweight=cweight, weight=0.5, capacity=100)
    for k in ("parent", "offset", "target", "cweight", "weight"):
        np.testing.assert_array_equal(getattr(ef_t, k).numpy(), np.asarray(getattr(ef_j, k)))
    assert ef_t.num_rows() == ef_j.num_rows() == 300
