"""Batch-native Gauss-Newton, Levenberg-Marquardt and gradient descent,
after momentum_tpu/solver/gauss_newton.py.

Gauss-Newton (gauss_newton_solver.cpp:224-262): each iteration solves
(JᵀJ + reg·I) δ = Jᵀr at x, from the normal equations' provider, from the
analytic rows and Jacobian, or by QR of the damped stack [J; √reg·I]
(`linear_solver="qr"`, the reference's GaussNewtonSolverQR), and steps to
x − δ, or to x − α·δ with a halving line search (`do_line_search`). With
`linear_solver="cg"` it solves the same system matrix-free by conjugate
gradients, each product Jᵀ(J v) one forward-mode and one reverse-mode sweep
of the residual (`solve_gauss_newton_cg`, the counterpart of the
reference's SparseGaussNewtonSolver).

Levenberg-Marquardt: each iteration solves (JᵀJ + λ·diag(JᵀJ) + reg·I) δ =
Jᵀr at x (by Cholesky or QR), tries x − δ, and accepts it only where the
energy drops, shrinking λ on accept and growing it on reject (the
TrustRegionQRT equivalent, trust_region_qr.cpp:82-230). With
`carry_jacobian` (and Σ rows² as the energy) the trial's rows and Jacobian
are kept for the next iteration: one linearization an iteration.

An element stops once a step changes its energy by at most
threshold·FLT_EPS relative (solver.cpp:86-121). The linearization comes from
the normal equations' provider (structured modules add JᵀJ without rows),
from the analytic rows and Jacobian, or, given the residual alone, from
forward mode: one JVP per parameter-basis tangent, vmapped (`ad_jacobian`,
JAX's linearize plus vmapped JVP, :141-156). Every solver freezes the
parameters an enabled_mask disables; `store_history` keeps each
iteration's energy and parameters (solver.h:72-92).

The loops run eagerly: the test "any element still running" reads one bool
from the device each iteration (a host sync; the JAX package's `cond` ran on
the device), and `verbose` prints the mean energy there. Each such read is
a `<solver>.sync` span (utils/profiling.py::host_sync); each solve, loop
turn, linearization (`lm.jacobian`, in every solver that asks for one), LM
step and trial energy is a span too, free while no profiler records.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from momentum_tpu_torch.math.linalg import damped_psd_solve
from momentum_tpu_torch.utils.profiling import host_sync, profile_scope, spanned

__all__ = ["SolverOptions", "SolveResult", "solve_gauss_newton",
           "solve_gauss_newton_cg", "solve_levenberg_marquardt",
           "solve_gradient_descent"]

_FLT_EPS = float(torch.finfo(torch.float32).eps)
_FLT_MIN = float(torch.finfo(torch.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver configuration (solver.h:19-34, gauss_newton_solver.h:17-30);
    JAX's fields in JAX's order."""

    min_iterations: int = 1
    max_iterations: int = 50
    threshold: float = 1.0
    # print the mean energy each iteration (solver.h:30)
    verbose: bool = False
    regularization: float = 0.05
    # GN: backtracking halving search of up to line_search_steps steps; the
    # sequence solver's Armijo search halves the step as often
    do_line_search: bool = False
    line_search_steps: int = 10
    # LM only:
    lambda_init: float = 0.01
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    # Use Σ rows² (the GN surrogate, exact for L2 losses) as the energy for
    # convergence and acceptance instead of calling error_fn.
    energy_from_residual: bool = False
    # keep every iteration's energy and parameters in SolveResult's
    # error_history / param_history (solver.h:72-77 setStoreHistory)
    store_history: bool = False
    # LM with energy_from_residual and no normal_fn: carry the trial's rows
    # and Jacobian into the next iteration (one linearization an iteration)
    carry_jacobian: bool = False
    # "cholesky" (the normal equations), "qr" (QR of [J; √damp·I]) or "cg"
    # (GN only: matrix-free conjugate gradients)
    linear_solver: str = "cholesky"
    # "cg" only: the inner-iteration cap and relative-residual stop
    cg_iterations: int = 64
    cg_tol: float = 1e-6
    # Sequence solver only: accumulate the block normal equations in float64
    # and factor them in float64, downcasting the step (the reference's
    # useDoublePrecisionNormalEquations, sequence_cholesky_solver.h:31-33;
    # the JAX package's branch with x64 enabled, ROADMAP F13)
    f64_normal_equations: bool = False
    # Sequence solver only: the equilibrated band's diagonal jitter (None:
    # sequence.solver's default, 1e-7 in float32)
    equilibrated_jitter: Optional[float] = None


class SolveResult(NamedTuple):
    """JAX's layout (momentum_tpu/solver/gauss_newton.py:126-138)."""

    params: torch.Tensor
    error: torch.Tensor  # final energy (at the pre-step params of the last iteration)
    iterations: int
    converged: torch.Tensor
    # (max_iterations, ...) energies and (max_iterations, ..., P) parameters
    # with SolverOptions.store_history, rows past `iterations` zero; else None
    error_history: Optional[torch.Tensor] = None
    param_history: Optional[torch.Tensor] = None
    # LM only: per-element damping at exit; pass as `lambda0` to resume the solve
    lambda_final: Optional[torch.Tensor] = None


def ad_jacobian(residual_fn: Callable, x: torch.Tensor, chunk_size: Optional[int] = None):
    """(rows (..., R), Jᵀ (..., P, R)) of residual_fn at x (..., P) by
    forward mode: torch.func.jvp with each parameter-basis tangent e_p,
    vmapped over p (`chunk_size` tangents at a time, all at once by
    default). With a batched primal, e_p is broadcast across the batch; the
    JVP is linear, so it gives every element's column p at once. FK reaches
    kernel K1 through its jvp and vmap rules (ops/fk.py)."""
    p = x.shape[-1]
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    tangents = eye.reshape((p,) + (1,) * (x.ndim - 1) + (p,)).expand((p,) + x.shape)
    rows, jt = torch.func.vmap(lambda t: torch.func.jvp(residual_fn, (x,), (t,)),
                               chunk_size=chunk_size)(tangents)
    return rows[0], jt.movedim(0, -2)


@spanned("lm.jacobian")
def _jacobian(residual_fn: Callable, x: torch.Tensor, jacobian_fn: Optional[Callable]):
    """(rows, Jᵀ) with Jᵀ (..., P, R): from the analytic provider when one
    is given, else by forward mode (`ad_jacobian`)."""
    if jacobian_fn is None:
        return ad_jacobian(residual_fn, x)
    rows, j = jacobian_fn(x)
    return rows, j.transpose(-1, -2)


def _converged(last_err, err, threshold):
    return torch.abs(last_err - err) / (torch.abs(err) + _FLT_MIN) <= threshold * _FLT_EPS


def _mask(x0: torch.Tensor, enabled_mask: Optional[torch.Tensor]) -> torch.Tensor:
    p = x0.shape[-1]
    return x0.new_ones(p) if enabled_mask is None else enabled_mask.to(x0.dtype)


def _history(opts: SolverOptions, x0: torch.Tensor):
    """Zeroed (energies (max_iter, ...), parameters (max_iter, ..., P)), or
    None without store_history."""
    if not opts.store_history:
        return None
    n = opts.max_iterations
    return (x0.new_zeros((n,) + x0.shape[:-1]), x0.new_zeros((n,) + x0.shape))


def _result(x, err, it, done, hist, lam=None) -> SolveResult:
    return SolveResult(x, err, it, done, None if hist is None else hist[0],
                       None if hist is None else hist[1], lam)


@spanned("gn.line_search")
def _line_search(error_fn: Callable, x: torch.Tensor, delta: torch.Tensor,
                 err0: torch.Tensor, steps: int) -> torch.Tensor:
    """Per-element step length: the largest α in {1, 1/2, 1/4, ...} (up to
    `steps` of them) whose x − α·δ lowers the energy below err0, else the
    full step (the reference's simple decrease criterion). The halving
    stops once every element has found its step; the rest could not
    change the result."""
    alpha = torch.ones_like(err0)
    best = torch.ones_like(err0)
    found = torch.zeros_like(err0, dtype=torch.bool)
    for _ in range(steps):
        e = error_fn(x - alpha[..., None] * delta)
        good = (e < err0) & ~found
        best = torch.where(good, alpha, best)
        found = found | good
        if host_sync("gn.line_search", bool, found.all()):
            break
        alpha = alpha * 0.5
    return torch.where(found, best, torch.ones_like(best))


def _qr_step(jt: torch.Tensor, rows: torch.Tensor, damp_diag: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """δ = argmin ‖J δ − r‖² + ‖√damp·δ‖² by QR of the damped stack
    [J; √damp·I] (the reference's Householder-QR solvers): jt (..., P, R),
    rows (..., R), damp_diag broadcasting against (..., P). A library QR and
    triangular solve, outside any kernel in JAX too."""
    j = jt.transpose(-1, -2)
    p = j.shape[-1]
    damp = torch.broadcast_to(damp_diag, j.shape[:-2] + (p,))
    aug = torch.cat([j, torch.diag_embed(torch.sqrt(damp))], dim=-2)  # (..., R+P, P)
    rhs = torch.cat([rows, rows.new_zeros(rows.shape[:-1] + (p,))], dim=-1)
    q, r = torch.linalg.qr(aug)  # reduced: q (..., R+P, P), r (..., P, P)
    qtr = q.transpose(-1, -2) @ rhs[..., None]
    return torch.linalg.solve_triangular(r, qtr, upper=True)[..., 0] * mask


@spanned("cg.solve")
def _cg(matvec: Callable, b: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """Batched conjugate gradients on an SPD `matvec` from x = 0, b (..., P):
    every element runs its own CG, an element whose residual fell to
    tol·‖b‖ taking zero-length steps (JAX's masked early stop). The loop
    ends when no element is active; the remaining iterations would not
    change x."""
    x = torch.zeros_like(b)
    r = b
    pvec = r
    rs = torch.sum(r * r, dim=-1)
    rs0 = rs
    for _ in range(iters):
        active = rs > (tol * tol) * rs0
        if not host_sync("cg", bool, active.any()):
            break
        ap = matvec(pvec)
        pap = torch.sum(pvec * ap, dim=-1)
        alpha = torch.where(active, rs / torch.clamp(pap, min=_FLT_MIN), 0.0)
        x = x + alpha[..., None] * pvec
        r = r - alpha[..., None] * ap
        rs_new = torch.sum(r * r, dim=-1)
        beta = torch.where(active, rs_new / torch.clamp(rs, min=_FLT_MIN), 0.0)
        pvec = r + beta[..., None] * pvec
        rs = torch.where(active, rs_new, rs)
    return x


@spanned("gn_cg.solve")
def solve_gauss_newton_cg(
    residual_fn: Callable,
    error_fn: Callable,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor] = None,
    options: SolverOptions = SolverOptions(),
) -> SolveResult:
    """Matrix-free Gauss-Newton on x0 (..., P): each step solves
    (JᵀJ + damp·I) δ = Jᵀr by conjugate gradients, J v by one
    torch.func.jvp of residual_fn and Jᵀw by the VJP taken once at x, so J
    and JᵀJ are never formed (O(P) memory per element; the reference's
    SparseGaussNewtonSolver, gauss_newton_solver_sparse.h:50-90). FK runs
    through K1 in each sweep (its jvp and backward rules, ops/fk.py).
    Convergence and masking as solve_gauss_newton."""
    opts = options
    mask = _mask(x0, enabled_mask)
    damp = opts.regularization + (1.0 - mask)
    err_shape = x0.shape[:-1]
    x = x0
    last_err = torch.full(err_shape, torch.finfo(torch.float32).max, dtype=x0.dtype,
                          device=x0.device)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    hist = _history(opts, x0)
    it = 0
    while it < opts.max_iterations and not host_sync("gn_cg", bool, done.all()):
        with profile_scope("gn_cg.iteration"):
            rows, vjp_fn = torch.func.vjp(residual_fn, x)
            x_lin = x

            def matvec(v):
                jv = torch.func.jvp(residual_fn, (x_lin,), (v * mask,))[1]
                return vjp_fn(jv)[0] * mask + damp * v

            jtr = vjp_fn(rows)[0]
            delta = _cg(matvec, jtr * mask, opts.cg_iterations, opts.cg_tol) * mask
            err = torch.sum(rows * rows, dim=-1) if opts.energy_from_residual else error_fn(x)
            if opts.verbose:
                print(f"GN-CG iter {it}: error {host_sync('gn_cg', float, err.mean())}")
            if opts.do_line_search:
                delta = _line_search(error_fn, x, delta, err,
                                     opts.line_search_steps)[..., None] * delta
            x_new = x - delta
            newly_done = ((it + 1 >= opts.min_iterations)
                          & _converged(last_err, err, opts.threshold))
            x = torch.where(done[..., None], x, x_new)
            last_err = torch.where(done, last_err, err)
            if hist is not None:
                hist[0][it], hist[1][it] = err, x
            it += 1
            done = done | newly_done
    return _result(x, last_err, it, done, hist)


@spanned("gn.solve")
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
    `linear_solver="qr"` factors the damped stack (without normal_fn);
    `"cg"` goes to solve_gauss_newton_cg. enabled_mask (P,) 0/1 freezes the
    disabled parameters."""
    opts = options
    if opts.linear_solver == "cg":
        return solve_gauss_newton_cg(residual_fn, error_fn, x0, enabled_mask, opts)
    mask = _mask(x0, enabled_mask)
    damp = opts.regularization + (1.0 - mask)
    err_shape = x0.shape[:-1]
    x = x0
    last_err = torch.full(err_shape, torch.finfo(torch.float32).max, dtype=x0.dtype,
                          device=x0.device)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    hist = _history(opts, x0)
    it = 0
    while it < opts.max_iterations and not host_sync("gn", bool, done.all()):
        with profile_scope("gn.iteration"):
            if normal_fn is not None:
                jtj, jtr, sq = normal_fn(x)
                if enabled_mask is not None:
                    jtj = jtj * (mask[:, None] * mask[None, :])
                    jtr = jtr * mask
                delta = damped_psd_solve(jtj, damp, jtr) * mask
                err = sq if opts.energy_from_residual else error_fn(x)
            else:
                rows, jt = _jacobian(residual_fn, x, jacobian_fn)
                jt = jt * mask[:, None]
                if opts.linear_solver == "qr":
                    delta = _qr_step(jt, rows, damp, mask)
                else:
                    jtj = jt @ jt.transpose(-1, -2)
                    jtr = (jt @ rows[..., None])[..., 0]
                    delta = damped_psd_solve(jtj, damp, jtr) * mask
                err = (torch.sum(rows * rows, dim=-1) if opts.energy_from_residual
                       else error_fn(x))
            if opts.verbose:
                print(f"GN iter {it}: error {host_sync('gn', float, err.mean())}")
            if opts.do_line_search:
                delta = _line_search(error_fn, x, delta, err,
                                     opts.line_search_steps)[..., None] * delta
            x_new = x - delta
            newly_done = ((it + 1 >= opts.min_iterations)
                          & _converged(last_err, err, opts.threshold))
            x = torch.where(done[..., None], x, x_new)
            last_err = torch.where(done, last_err, err)
            if hist is not None:
                hist[0][it], hist[1][it] = err, x
            it += 1
            done = done | newly_done
    return _result(x, last_err, it, done, hist)


@spanned("gd.solve")
def solve_gradient_descent(
    residual_fn: Callable,
    error_fn: Callable,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor] = None,
    options: SolverOptions = SolverOptions(),
    learning_rate: float = 0.01,
    jacobian_fn: Optional[Callable] = None,
    normal_fn: Optional[Callable] = None,
) -> SolveResult:
    """First-order descent (gradient_descent_solver.h) on x0 (..., P): each
    iteration x −= lr·∇E with ∇E = 2·Jᵀr, from normal_fn's Jᵀr or from the
    rows and Jacobian; the GN solvers' convergence test. No histories, as
    in JAX."""
    opts = options
    mask = _mask(x0, enabled_mask)
    err_shape = x0.shape[:-1]
    x = x0
    last_err = torch.full(err_shape, torch.finfo(torch.float32).max, dtype=x0.dtype,
                          device=x0.device)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    it = 0
    while it < opts.max_iterations and not host_sync("gd", bool, done.all()):
        with profile_scope("gd.iteration"):
            if normal_fn is not None:
                _, jtr, sq = normal_fn(x)
                grad = 2.0 * jtr * mask
                err = sq if opts.energy_from_residual else error_fn(x)
            else:
                rows, jt = _jacobian(residual_fn, x, jacobian_fn)
                grad = 2.0 * ((jt * mask[:, None]) @ rows[..., None])[..., 0]
                err = (torch.sum(rows * rows, dim=-1) if opts.energy_from_residual
                       else error_fn(x))
            x_new = x - learning_rate * grad
            newly_done = ((it + 1 >= opts.min_iterations)
                          & _converged(last_err, err, opts.threshold))
            x = torch.where(done[..., None], x, x_new)
            last_err = torch.where(done, last_err, err)
            it += 1
            done = done | newly_done
    return SolveResult(params=x, error=last_err, iterations=it, converged=done)


@spanned("lm.solve")
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
    Jacobian of residual_fn by forward mode. Without normal_fn the step
    factors the normal equations or, with `linear_solver="qr"`, the damped
    stack. enabled_mask (P,) 0/1 freezes the disabled parameters. lambda0:
    optional per-element initial damping that overrides
    options.lambda_init, e.g. a previous solve's `lambda_final`."""
    opts = options
    mask = _mask(x0, enabled_mask)
    err_shape = x0.shape[:-1]

    @spanned("lm.energy")
    def energy(x):
        if opts.energy_from_residual and normal_fn is None:
            r = residual_fn(x)
            return torch.sum(r * r, dim=-1)
        return error_fn(x)

    def damping(diag, lam):
        """λ·max(diag, 1e-12) + reg + (1 − mask)."""
        return (lam[..., None] * torch.clamp(diag, min=1e-12) + opts.regularization
                + (1.0 - mask))

    @spanned("lm.step")
    def step(x, lam):
        """x minus one damped step from the normal equations at x."""
        jtj, jtr, _ = normal_fn(x)
        if enabled_mask is not None:
            jtj = jtj * (mask[:, None] * mask[None, :])
            jtr = jtr * mask
        damp = damping(jtj.diagonal(dim1=-2, dim2=-1), lam)
        return x - damped_psd_solve(jtj, damp, jtr) * mask

    @spanned("lm.step")
    def step_from(x, rows, jt, lam):
        """x minus one damped step from the rows and Jᵀ at x."""
        jt = jt * mask[:, None]
        damp = damping(torch.sum(jt * jt, dim=-1), lam)
        if opts.linear_solver == "qr":
            return x - _qr_step(jt, rows, damp, mask)
        jtj = jt @ jt.transpose(-1, -2)
        jtr = (jt @ rows[..., None])[..., 0]
        return x - damped_psd_solve(jtj, damp, jtr) * mask

    # λ from the options is a copy from the host, which drains the card's queue
    lam = torch.broadcast_to(
        host_sync("lm.init", torch.as_tensor, opts.lambda_init, dtype=x0.dtype,
                  device=x0.device) if lambda0 is None
        else torch.as_tensor(lambda0, dtype=x0.dtype, device=x0.device), err_shape).clone()
    fused = opts.energy_from_residual and opts.carry_jacobian and normal_fn is None
    x = x0
    if fused:
        rows, jt = _jacobian(residual_fn, x0, jacobian_fn)
        err = torch.sum(rows * rows, dim=-1)
    else:
        err = torch.broadcast_to(energy(x0), err_shape)
    done = torch.zeros(err_shape, dtype=torch.bool, device=x0.device)
    hist = _history(opts, x0)
    it = 0
    while it < opts.max_iterations and not host_sync("lm", bool, done.all()):
        with profile_scope("lm.iteration"):
            if fused:
                x_trial = step_from(x, rows, jt, lam)
                rows_t, jt_t = _jacobian(residual_fn, x_trial, jacobian_fn)
                with profile_scope("lm.energy"):
                    err_trial = torch.sum(rows_t * rows_t, dim=-1)
            elif normal_fn is not None:
                x_trial = step(x, lam)
                err_trial = energy(x_trial)
            else:
                x_trial = step_from(x, *_jacobian(residual_fn, x, jacobian_fn), lam)
                err_trial = energy(x_trial)
            accept = err_trial < err
            if fused:
                rows = torch.where(accept[..., None], rows_t, rows)
                jt = torch.where(accept[..., None, None], jt_t, jt)
            x_new = torch.where(accept[..., None], x_trial, x)
            err_new = torch.where(accept, err_trial, err)
            lam_new = torch.clamp(
                torch.where(accept, lam * opts.lambda_down, lam * opts.lambda_up),
                opts.lambda_min, opts.lambda_max)
            if opts.verbose and not fused:
                print(f"LM iter {it}: error {host_sync('lm', float, err_new.mean())} "
                      f"(accepted {host_sync('lm', float, accept.to(x0.dtype).mean())})")
            conv = accept & _converged(err, err_trial, opts.threshold)
            newly_done = (it + 1 >= opts.min_iterations) & conv
            x = torch.where(done[..., None], x, x_new)
            err = torch.where(done, err, err_new)
            lam = torch.where(done, lam, lam_new)
            if hist is not None:
                hist[0][it], hist[1][it] = err, x
            it += 1
            done = done | newly_done
    return _result(x, err, it, done, hist, lam)
