"""Gauss-Newton on the band-plus-arrowhead multi-frame system, after
momentum_tpu/sequence/solver.py (the reference's
character_sequence_solver/sequence_solver.{h,cpp}, which streams per-frame
Jacobians into a banded Householder QR, :235-370, 493-560).

Each iteration forms the block-banded normal equations directly (the
reference's SequenceCholeskySolverT, sequence_cholesky_solver.h:20-60):

  * the per-frame modules' rows and Jacobians for all frames at once: the
    analytic full-θ Jacobian when every module has one, else forward mode;
  * the sequence modules' Jacobians over sliding windows by forward mode
    (bandwidth = the largest window − 1, sequence_solver.cpp:54-57);
  * their products added into the diagonal, off-diagonal and arrowhead
    blocks;
  * a block-tridiagonal Schur solve (block_tridiag.py), windows over 2
    aggregated into superblocks first.

The JAX package's while_loop is a Python loop here with one host sync an
iteration (the test "done"), as the port's GN and LM have; the
convergence test is solver.cpp:98-101's. Spans (utils/profiling.py):
`sequence.solve` around a take, `sequence.iteration` around each GN turn,
and inside it `sequence.normal_equations`, `sequence.equilibrate`,
`sequence.system` (the whole banded solve) and `sequence.error`; every
host sync is a `.sync` span: the test "done" (`sequence.sync`), the line
search's test and the index tables copied from the host
(`sequence.index.sync`), each of which drains the card's queue too.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from momentum_tpu_torch.sequence.block_tridiag import (
    banded_to_tridiag, block_tridiag_solve, schur_arrowhead_solve)
from momentum_tpu_torch.sequence.solver_function import SequenceSolverFunction
from momentum_tpu_torch.solver.gauss_newton import SolverOptions, _converged
from momentum_tpu_torch.solver.skeleton_solver_function import SkeletonSolverFunction
from momentum_tpu_torch.utils.profiling import host_sync, profile_scope, spanned

__all__ = ["SequenceSolveResult", "solve_sequence", "make_frame_jacobian", "window_jacobian"]


class SequenceSolveResult(NamedTuple):
    per_frame: torch.Tensor  # (F, n_pf)
    universal: torch.Tensor  # (n_u,)
    error: torch.Tensor  # the energy at the last iteration's pre-step parameters
    iterations: int
    converged: torch.Tensor


def _jacobian_columns(res_fn, x: torch.Tensor, u: torch.Tensor):
    """(rows (N, R), dx (N, R, *s), du (N, R, nu)) of res_fn(x, u) -> (N, R)
    for x (N, *s) whose N items are independent: the forward-mode Jacobian
    (jacfwd's tangents, one a column of x's item or of u) with each tangent
    set on every item at once, so N items cost what one does."""
    n, shape = x.shape[0], x.shape[1:]
    d, nu = math.prod(shape), u.shape[-1]
    eye = torch.eye(d + nu, dtype=x.dtype, device=x.device)
    t_x = eye[:, :d].reshape((d + nu, 1) + shape).expand((d + nu, n) + shape)
    rows, cols = torch.func.vmap(
        lambda tx, tu: torch.func.jvp(res_fn, (x, u), (tx, tu)))(t_x, eye[:, d:])
    cols = cols.movedim(0, -1)  # (N, R, d + nu)
    return rows[0], cols[..., :d].reshape(cols.shape[:-1] + shape), cols[..., d:]


def make_frame_jacobian(fn: SequenceSolverFunction):
    """(pf (F, n_pf), u (n_u,)) -> (rows (F, R), J_pf (F, R, n_pf), J_u
    (F, R, n_u)) of the per-frame modules: the analytic full-θ Jacobian
    (residual_and_jacobian, its per-frame and universal columns selected)
    when every module has one and the rig has at least 64 parameters, else
    forward mode through the frame contexts: JAX's gate (:82-85), and like
    JAX's the analytic branch takes each module's joint-space Jacobian
    through the parameter transform (prefer_fused=False). The forms agree
    to float32 roundoff, but a calibration's scale solve from poorly
    tracked poses and the refine's near-null directions amplify that
    roundoff, so the port takes the branch JAX takes."""
    ssf = SkeletonSolverFunction(fn.character, fn.per_frame_errors, prefer_fused=False)
    if ssf.fully_analytic and fn.character.num_model_parameters >= 64:
        def frame_jac(pf, u):
            rows, jac = ssf.residual_and_jacobian(fn.join(pf, u))
            return (rows, jac.index_select(-1, fn._index("per_frame_index", pf.device)),
                    jac.index_select(-1, fn._index("universal_index", pf.device)))
        return frame_jac

    def frame_jac(pf, u):
        return _jacobian_columns(
            lambda a, b: fn.frame_residual(fn.join(a, b), fn.per_frame_errors), pf, u)
    return frame_jac


def window_jacobian(fn: SequenceSolverFunction, sef, pf: torch.Tensor, u: torch.Tensor):
    """(rows (F-W+1, R), J_w (F-W+1, R, W, n_pf), J_u (F-W+1, R, n_u)) of the
    sequence module `sef` on every window of W frames, by forward mode (JAX's
    jacfwd over each window, :157-162). FK runs only if the module reads
    the skeleton states or the mesh."""
    w = sef.window
    states = sef.reads_states or sef.needs_mesh

    def seq_res(pf_win, u_):
        return sef.residual(fn.character, fn._context(fn.join(pf_win, u_), states))

    win_idx = torch.arange(fn.num_frames - w + 1)[:, None] + torch.arange(w)[None, :]
    return _jacobian_columns(seq_res, pf[host_sync("sequence.index", win_idx.to, pf.device)], u)


@spanned("sequence.normal_equations")
def _normal_equations(fn: SequenceSolverFunction, pf: torch.Tensor, u: torch.Tensor,
                      f64: bool = False):
    """The block-banded normal equations of the GN step H δ = Jᵀr (applied
    as x -= δ): (diag (F, p, p), offs [(F-k, p, p) for k = 1..q], u_coupling
    (F, p, nu), u_block (nu, nu), rhs_f (F, p), rhs_u (nu,), q).

    f64: every JᵀJ / Jᵀr product accumulates in float64 (the reference's
    useDoublePrecisionNormalEquations, sequence_cholesky_solver.h:31-33)."""
    f, p, nu = fn.num_frames, fn.num_per_frame, fn.num_universal
    dtype = torch.float64 if f64 else pf.dtype

    def acc(x):
        return x.to(dtype)

    # ---- per-frame modules: block diagonal and arrowhead ----
    rows, j_pf, j_u = (acc(t) for t in make_frame_jacobian(fn)(pf, u))
    j_pf_t = j_pf.transpose(-1, -2)
    diag = j_pf_t @ j_pf
    u_coupling = j_pf_t @ j_u
    u_block = j_u.flatten(0, 1).T @ j_u.flatten(0, 1)
    rhs_f = (j_pf_t @ rows[..., None])[..., 0]
    rhs_u = j_u.flatten(0, 1).T @ rows.flatten()

    # ---- sequence modules: band and arrowhead ----
    q = 1
    offs = {}
    for sef in fn.sequence_errors:
        w = sef.window
        q = max(q, w - 1)
        fw = f - w + 1
        s_rows, s_jw, s_ju = (acc(t) for t in window_jacobian(fn, sef, pf, u))
        for k in range(w):
            jk_t = s_jw[:, :, k, :].transpose(-1, -2)  # (fw, p, R)
            diag[k:k + fw] += jk_t @ s_jw[:, :, k, :]
            u_coupling[k:k + fw] += jk_t @ s_ju
            rhs_f[k:k + fw] += (jk_t @ s_rows[..., None])[..., 0]
            for d in range(1, w - k):
                off = offs.setdefault(d, diag.new_zeros((f - d, p, p)))
                off[k:k + fw] += jk_t @ s_jw[:, :, k + d, :]
        u_block += s_ju.flatten(0, 1).T @ s_ju.flatten(0, 1)
        rhs_u += s_ju.flatten(0, 1).T @ s_rows.flatten()

    off_list = [offs.get(d, diag.new_zeros((f - d, p, p))) for d in range(1, q + 1)]
    return diag, off_list, u_coupling, u_block, rhs_f, rhs_u, q


@spanned("sequence.system")
def _solve_banded_arrowhead(diag, offs, u_coupling, u_block, rhs_f, rhs_u, q):
    """Solve the assembled system; aggregate superblocks when q > 1."""
    f, p, nu = u_coupling.shape
    if q == 1:
        if nu == 0:
            return block_tridiag_solve(diag, offs[0], rhs_f[..., None])[..., 0], rhs_u
        return schur_arrowhead_solve(diag, offs[0], u_coupling, u_block, rhs_f, rhs_u)
    pad = (-f) % q
    if pad:
        eye = torch.eye(p, dtype=diag.dtype, device=diag.device).expand(pad, p, p)
        diag = torch.cat([diag, eye])
        offs = [torch.cat([o, o.new_zeros((pad, p, p))])[:f + pad - d]
                for d, o in zip(range(1, q + 1), offs)]
        u_coupling = torch.cat([u_coupling, u_coupling.new_zeros((pad, p, nu))])
        rhs_f = torch.cat([rhs_f, rhs_f.new_zeros((pad, p))])
    fp = f + pad
    g = fp // q
    sd, su = banded_to_tridiag(diag, offs)
    rf = rhs_f.reshape(g, q * p)
    if nu == 0:
        x, x_u = block_tridiag_solve(sd, su, rf[..., None])[..., 0], rhs_u
    else:
        x, x_u = schur_arrowhead_solve(sd, su, u_coupling.reshape(g, q * p, nu), u_block,
                                       rf, rhs_u)
    return x.reshape(fp, p)[:f], x_u


# Numerical guards on the equilibrated system, the JAX package's
# (sequence/solver.py:227-266), with its sizing:
#
# - _EQUILIBRATED_JITTER (band): the roundoff margin of positive
#   definiteness. f32 JᵀJ accumulation on mm-scale marker data measured a
#   min-eig of −1.4e-9 relative (indefinite, Cholesky NaN); 1e-7 restores PD
#   with ~70× margin. It is multiplicative (jitter · max-over-frames
#   diagonal) on every pose DoF and quality-sensitive: real-clip calibration
#   per-frame p90 measured 10.03 mm at 1e-7, 14.75 at 1e-6, 17.68 at 1e-5.
#
# - _EQUILIBRATED_DIAG_FLOOR: a per-frame pivot floor on the scaled band
#   diagonal. The global max-over-frames scale leaves a DoF observed
#   strongly in some frame with near-zero scaled pivots where it is
#   unobserved; f32 elimination through those pivots blows up (a synthetic
#   scale calibration landed at 0.069 instead of 0.25). Lifting just those
#   pivots to 1e-5 restores stability without bias where it matters.
_EQUILIBRATED_JITTER = 1e-7
_EQUILIBRATED_DIAG_FLOOR = 1e-5
# Universal (arrowhead) block jitter: the Schur complement S = ub − UᵀT⁻¹U
# is a small difference of ≈unit quantities accumulated over f·p f32
# products, with ~1e-6 relative noise when the universal DoFs are weakly
# determined; undamped, it throws the scale estimate (0.069 instead of 0.25
# at 1e-7; exactly 0.25000 at 1e-6). Real-clip calibration p90 stays at its
# 10.03 mm optimum with 1e-6 here as long as the band jitter stays at 1e-7.
_EQUILIBRATED_JITTER_U = 1e-6
# the same guards at the float64 noise floor (f64 mode, ROADMAP F13)
_F64_GUARDS = (1e-14, 1e-12, 1e-14)


def _equilibration_scale(diag: torch.Tensor) -> torch.Tensor:
    """(F, p, p) block diagonals → (p,) global per-DoF D^-1/2 scale."""
    d = torch.diagonal(diag, dim1=-2, dim2=-1)  # (F, p)
    return torch.rsqrt(torch.clamp(torch.max(d, dim=0).values, min=1e-30))


@spanned("sequence.equilibrate")
def _equilibrate(system, opts: SolverOptions):
    """The regularized system scaled by D^-1/2 on both sides, global per
    DoF (max over frames), with the roundoff jitter and the per-frame pivot
    floor (the guards above): (scaled system, s (p,), s_u (nu,))."""
    diag, offs, uc, ub, rf, ru, q = system
    p, nu, wdt = diag.shape[-1], ub.shape[-1], diag.dtype  # float64 in f64 mode
    diag = diag + opts.regularization * torch.eye(p, dtype=wdt, device=diag.device)
    ub = ub + opts.regularization * torch.eye(nu, dtype=wdt, device=diag.device)
    s = _equilibration_scale(diag)
    s_u = torch.rsqrt(torch.clamp(torch.diagonal(ub), min=1e-30))
    diag = diag * s[None, :, None] * s[None, None, :]
    dsc = torch.diagonal(diag, dim1=-2, dim2=-1)  # (F, p), ≤ 1
    if opts.f64_normal_equations:
        default_jitter, diag_floor, jitter_u = _F64_GUARDS
    else:
        default_jitter, diag_floor, jitter_u = (
            _EQUILIBRATED_JITTER, _EQUILIBRATED_DIAG_FLOOR, _EQUILIBRATED_JITTER_U)
    band_jitter = default_jitter if opts.equilibrated_jitter is None else opts.equilibrated_jitter
    lift = torch.clamp(diag_floor - dsc, min=0.0) + band_jitter
    diag = diag + lift[..., None] * torch.eye(p, dtype=wdt, device=diag.device)
    offs = [o * s[None, :, None] * s[None, None, :] for o in offs]
    uc = uc * s[None, :, None] * s_u[None, None, :]
    ub = (ub * s_u[:, None] * s_u[None, :]
          + jitter_u * torch.eye(nu, dtype=wdt, device=diag.device))
    return (diag, offs, uc, ub, rf * s[None, :], ru * s_u, q), s, s_u


def _step(fn: SequenceSolverFunction, pf, u, opts: SolverOptions):
    """The GN step (d_pf, d_u) at (pf, u), in pf's dtype."""
    system, s, s_u = _equilibrate(
        _normal_equations(fn, pf, u, f64=opts.f64_normal_equations), opts)
    d_pf, d_u = _solve_banded_arrowhead(*system)
    return (d_pf * s[None, :]).to(pf.dtype), (d_u * s_u).to(pf.dtype)


@spanned("sequence.solve")
def solve_sequence(fn: SequenceSolverFunction, pf0: torch.Tensor, u0: torch.Tensor,
                   options: SolverOptions = SolverOptions()) -> SequenceSolveResult:
    """Gauss-Newton over the multi-frame objective from (pf0, u0).

    f64_normal_equations follows the JAX package with x64 enabled (ROADMAP
    F13): float64 accumulation and factorization (the plain Cholesky, which
    K2+K3's float32 arithmetic would not honour), float64-sized guards, and
    the step downcast. do_line_search backtracks the step by halves, up to
    line_search_steps times, until the energy drops (Armijo without slope,
    sequence_solver.cpp's line-search option)."""
    opts = options
    pf, u = pf0, u0
    # a copy from the host: the card's queue drains first
    last_err = host_sync("sequence.init", torch.tensor, torch.finfo(torch.float32).max,
                         dtype=pf0.dtype, device=pf0.device)
    it, done = 0, torch.zeros((), dtype=torch.bool, device=pf0.device)
    while it < opts.max_iterations and not host_sync("sequence", bool, done):
        with profile_scope("sequence.iteration"):
            d_pf, d_u = _step(fn, pf, u, opts)
            with profile_scope("sequence.error"):
                err = fn.error(pf, u)
            if opts.do_line_search:
                alpha = 1.0
                with profile_scope("sequence.line_search"):
                    for _ in range(opts.line_search_steps):
                        trial = fn.error(pf - alpha * d_pf, u - alpha * d_u) < err
                        if host_sync("sequence.line_search", bool, trial):
                            break
                        alpha *= 0.5
                    else:
                        alpha = 1.0  # no step scale lowered the energy: take the full step
                d_pf, d_u = alpha * d_pf, alpha * d_u
            done = (it + 1 >= opts.min_iterations) & _converged(last_err, err, opts.threshold)
            pf, u, last_err = pf - d_pf, u - d_u, err
            it += 1
    return SequenceSolveResult(pf, u, last_err, it, done)
