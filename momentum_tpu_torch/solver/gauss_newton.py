"""Batch-native Gauss-Newton and Levenberg-Marquardt, after
momentum_tpu/solver/gauss_newton.py.

Gauss-Newton (gauss_newton_solver.cpp:224-262): each iteration solves
(JᵀJ + reg·I) δ = Jᵀr at x, from the normal equations' provider or from
the analytic rows and Jacobian, and steps to x − δ unconditionally.

Levenberg-Marquardt: each iteration solves (JᵀJ + λ·diag(JᵀJ) + reg·I) δ =
Jᵀr at x, tries x − δ, and accepts it only where the energy drops, shrinking
λ on accept and growing it on reject (the TrustRegionQRT equivalent,
trust_region_qr.cpp:82-230). An element stops once an accepted step changes
its energy by at most threshold·FLT_EPS relative (solver.cpp:86-121).

Both take their linearization from the normal equations' provider
(structured modules add JᵀJ without rows), from the analytic rows and
Jacobian, or, given the residual alone, from forward mode: one JVP per
parameter-basis tangent, vmapped (`ad_jacobian`, JAX's linearize plus
vmapped JVP, :141-156). Both freeze the parameters an enabled_mask
disables.

Both loops run eagerly: the test "any element still running" reads one bool
from the device each iteration (a host sync; the JAX package's `cond` ran on
the device). QR, CG, line search, histories and LM's carried Jacobian come
later (ROADMAP M5) and raise NotImplementedError or are not offered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from momentum_tpu_torch.math.linalg import damped_psd_solve

__all__ = ["SolverOptions", "SolveResult", "solve_gauss_newton",
           "solve_levenberg_marquardt"]

_FLT_EPS = float(torch.finfo(torch.float32).eps)
_FLT_MIN = float(torch.finfo(torch.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver configuration (solver.h:19-34, gauss_newton_solver.h:17-30)."""

    min_iterations: int = 1
    max_iterations: int = 50
    threshold: float = 1.0
    regularization: float = 0.05
    lambda_init: float = 0.01
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    # Use Σ rows² (the GN surrogate, exact for L2 losses) as the energy for
    # convergence and acceptance instead of calling error_fn.
    energy_from_residual: bool = False
    # only "cholesky" is ported; "qr" and "cg" raise (ROADMAP M5)
    linear_solver: str = "cholesky"
    # GN/LM raise for it (ROADMAP M5); the sequence solver's Armijo search
    # halves the step up to line_search_steps times
    do_line_search: bool = False
    line_search_steps: int = 10
    store_history: bool = False
    # Sequence solver only: accumulate the block normal equations in float64
    # and factor them in float64, downcasting the step (the reference's
    # useDoublePrecisionNormalEquations, sequence_cholesky_solver.h:31-33;
    # the JAX package's branch with x64 enabled, ROADMAP F13)
    f64_normal_equations: bool = False
    # Sequence solver only: the equilibrated band's diagonal jitter (None:
    # sequence.solver's default, 1e-7 in float32)
    equilibrated_jitter: Optional[float] = None


class SolveResult(NamedTuple):
    params: torch.Tensor
    error: torch.Tensor  # final energy (at the pre-step params of the last iteration)
    iterations: int
    converged: torch.Tensor
    # per-element damping at exit; pass as `lambda0` to resume the solve
    lambda_final: Optional[torch.Tensor] = None


def ad_jacobian(residual_fn: Callable, x: torch.Tensor):
    """(rows (..., R), Jᵀ (..., P, R)) of residual_fn at x (..., P) by
    forward mode: torch.func.jvp with each parameter-basis tangent e_p,
    vmapped over p. With a batched primal, e_p is broadcast across the
    batch; the JVP is linear, so it gives every element's column p at once.
    FK reaches kernel K1 through its jvp and vmap rules (ops/fk.py)."""
    p = x.shape[-1]
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    tangents = eye.reshape((p,) + (1,) * (x.ndim - 1) + (p,)).expand((p,) + x.shape)
    rows, jt = torch.func.vmap(lambda t: torch.func.jvp(residual_fn, (x,), (t,)))(tangents)
    return rows[0], jt.movedim(0, -2)


def _jacobian(residual_fn: Callable, x: torch.Tensor, jacobian_fn: Optional[Callable]):
    """(rows, Jᵀ) with Jᵀ (..., P, R): from the analytic provider when one
    is given, else by forward mode (`ad_jacobian`)."""
    if jacobian_fn is None:
        return ad_jacobian(residual_fn, x)
    rows, j = jacobian_fn(x)
    return rows, j.transpose(-1, -2)


def _converged(last_err, err, threshold):
    return torch.abs(last_err - err) / (torch.abs(err) + _FLT_MIN) <= threshold * _FLT_EPS


def _refuse_unported(opts: SolverOptions):
    if opts.linear_solver != "cholesky" or opts.do_line_search or opts.store_history:
        raise NotImplementedError("the port solves with Cholesky only, without line "
                                  "search or histories (ROADMAP M5)")


def solve_gauss_newton(
    residual_fn: Callable,
    error_fn: Callable,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor] = None,
    options: SolverOptions = SolverOptions(),
    jacobian_fn: Optional[Callable] = None,
    normal_fn: Optional[Callable] = None,
) -> SolveResult:
    """Damped Gauss-Newton on x0 (..., P).

    normal_fn: x -> (JᵀJ, Jᵀr, Σ rows²), the direct provider
    (SkeletonSolverFunction.normal_equations); else jacobian_fn: x -> (rows,
    J (..., R, P)); else the Jacobian of residual_fn by forward mode.
    enabled_mask (P,) 0/1 freezes the disabled parameters."""
    opts = options
    _refuse_unported(opts)
    p = x0.shape[-1]
    mask = (x0.new_ones(p) if enabled_mask is None else enabled_mask.to(x0.dtype))
    damp = opts.regularization + (1.0 - mask)
    err_shape = x0.shape[:-1]
    x = x0
    last_err = torch.full(err_shape, torch.finfo(torch.float32).max, dtype=x0.dtype,
                          device=x0.device)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    it = 0
    while it < opts.max_iterations and not bool(done.all()):
        if normal_fn is not None:
            jtj, jtr, sq = normal_fn(x)
            if enabled_mask is not None:
                jtj = jtj * (mask[:, None] * mask[None, :])
                jtr = jtr * mask
            err = sq if opts.energy_from_residual else error_fn(x)
        else:
            rows, jt = _jacobian(residual_fn, x, jacobian_fn)
            jt = jt * mask[:, None]
            jtj = jt @ jt.transpose(-1, -2)
            jtr = (jt @ rows[..., None])[..., 0]
            err = torch.sum(rows * rows, dim=-1) if opts.energy_from_residual else error_fn(x)
        x_new = x - damped_psd_solve(jtj, damp, jtr) * mask
        newly_done = (it + 1 >= opts.min_iterations) & _converged(last_err, err, opts.threshold)
        x = torch.where(done[..., None], x, x_new)
        last_err = torch.where(done, last_err, err)
        it += 1
        done = done | newly_done
    return SolveResult(params=x, error=last_err, iterations=it, converged=done)


def solve_levenberg_marquardt(
    residual_fn: Callable,
    error_fn: Callable,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor] = None,
    options: SolverOptions = SolverOptions(),
    jacobian_fn: Optional[Callable] = None,
    normal_fn: Optional[Callable] = None,
    lambda0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """LM with multiplicative damping on x0 (..., P), JAX's signature.

    residual_fn: x -> rows (..., R); error_fn: x -> energy (...,);
    normal_fn: x -> (JᵀJ, Jᵀr, Σ rows²), the direct provider
    (SkeletonSolverFunction.normal_equations), called at every iteration's
    x, after a reject too; the energy is then error_fn's (with
    energy_from_residual the caller passes a Σ rows² evaluator, residual_sq);
    else jacobian_fn: x -> (rows (..., R), J (..., R, P)); else the
    Jacobian of residual_fn by forward mode. enabled_mask (P,) 0/1 freezes
    the disabled parameters. lambda0: optional per-element initial damping
    that overrides options.lambda_init, e.g. a previous solve's
    `lambda_final`."""
    opts = options
    _refuse_unported(opts)
    p = x0.shape[-1]
    mask = x0.new_ones(p) if enabled_mask is None else enabled_mask.to(x0.dtype)
    err_shape = x0.shape[:-1]

    def energy(x):
        if opts.energy_from_residual and normal_fn is None:
            r = residual_fn(x)
            return torch.sum(r * r, dim=-1)
        return error_fn(x)

    def solve_normal(jtj, jtr, diag, lam):
        """δ of (JᵀJ + λ·max(diag, 1e-12) + reg + (1 − mask)) δ = Jᵀr, masked."""
        damp_diag = (lam[..., None] * torch.clamp(diag, min=1e-12) + opts.regularization
                     + (1.0 - mask))
        return damped_psd_solve(jtj, damp_diag, jtr) * mask

    def step(x, lam):
        """x minus one damped step from the linearization at x."""
        if normal_fn is not None:
            jtj, jtr, _ = normal_fn(x)
            if enabled_mask is not None:
                jtj = jtj * (mask[:, None] * mask[None, :])
                jtr = jtr * mask
            return x - solve_normal(jtj, jtr, jtj.diagonal(dim1=-2, dim2=-1), lam)
        rows, jt = _jacobian(residual_fn, x, jacobian_fn)
        if enabled_mask is not None:
            jt = jt * mask[:, None]
        jtj = jt @ jt.transpose(-1, -2)
        jtr = (jt @ rows[..., None])[..., 0]
        return x - solve_normal(jtj, jtr, torch.sum(jt * jt, dim=-1), lam)

    lam = torch.broadcast_to(
        torch.as_tensor(opts.lambda_init if lambda0 is None else lambda0,
                        dtype=x0.dtype, device=x0.device), err_shape).clone()
    x = x0
    err = torch.broadcast_to(energy(x0), err_shape)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    it = 0
    while it < opts.max_iterations and not bool(done.all()):
        x_trial = step(x, lam)
        err_trial = energy(x_trial)
        accept = err_trial < err
        x_new = torch.where(accept[..., None], x_trial, x)
        err_new = torch.where(accept, err_trial, err)
        lam_new = torch.clamp(
            torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
            opts.lambda_min, opts.lambda_max)
        conv = accept & _converged(err, err_trial, opts.threshold)
        newly_done = (it + 1 >= opts.min_iterations) & conv
        x = torch.where(done[..., None], x, x_new)
        err = torch.where(done, err, err_new)
        lam = torch.where(done, lam, lam_new)
        it += 1
        done = done | newly_done
    return SolveResult(params=x, error=err, iterations=it, converged=done,
                       lambda_final=lam)
