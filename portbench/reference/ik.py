"""Plain batched Levenberg-Marquardt with a compacted tail, from the
semantics of momentum's trust-region LM (trust_region_qr.cpp) as the
configuration states them:

  per iteration, per element: rows r and J at x;
    (JᵀJ + diag(λ·max(diag JᵀJ, 1e-12) + reg)) δ = Jᵀr   (plain Cholesky)
    trial x − δ, accepted only where Σ r² drops; λ·down on accept, λ·up on
    reject, clamped; an element stops once an accepted step changes its
    energy by ≤ threshold·FLT_EPS relative.
  compaction: k_full iterations on the batch, then r_refine more on the
    `capacity` elements of highest energy, resuming their λ.
"""

from __future__ import annotations

import torch

from portbench.reference import kinematics as kin

_FLT_EPS = float(torch.finfo(torch.float32).eps)
_FLT_MIN = float(torch.finfo(torch.float32).tiny)
_BIG = 3.0e38


def _step(rr, x, targets, lam, opts):
    rows, jac = kin.residual_and_jacobian(rr, x, targets)
    jt = jac.transpose(-1, -2)
    jtj = jt @ jac
    jtr = (jt @ rows[..., None])[..., 0]
    diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12)
    damp = lam[:, None] * diag + opts["regularization"]
    chol, info = torch.linalg.cholesky_ex(jtj + torch.diag_embed(damp))
    delta = torch.cholesky_solve(jtr[..., None], chol)[..., 0]
    delta = torch.where((info != 0)[:, None], torch.full_like(delta, float("nan")), delta)
    return x - delta


def levenberg_marquardt(rr, targets, x0, iters: int, lam0, opts: dict):
    """(x, energy, λ) after up to `iters` LM iterations on every element."""
    batch = x0.shape[0]
    lam = (torch.full((batch,), opts["lambda_init"], dtype=x0.dtype, device=x0.device)
           if lam0 is None else lam0.clone())
    x = x0
    err = kin.energy(rr, x, targets)
    done = torch.zeros(batch, dtype=torch.bool, device=x0.device)
    for it in range(iters):
        if bool(done.all()):
            break
        x_trial = _step(rr, x, targets, lam, opts)
        err_trial = kin.energy(rr, x_trial, targets)
        accept = err_trial < err
        conv = accept & (torch.abs(err - err_trial) / (torch.abs(err_trial) + _FLT_MIN)
                         <= opts["threshold"] * _FLT_EPS)
        lam_new = torch.clamp(torch.where(accept, lam * opts["lambda_down"],
                                          lam * opts["lambda_up"]),
                              opts["lambda_min"], opts["lambda_max"])
        x = torch.where((done | ~accept)[:, None], x, x_trial)
        err = torch.where(done | ~accept, err, err_trial)
        lam = torch.where(done, lam, lam_new)
        done = done | ((it + 1 >= opts["min_iterations"]) & conv)
    return x, err, lam


def solve_compacted(rr, targets, x0, opts: dict, k_full: int, r_refine: int, capacity: int):
    """(x, energy) of the compacted schedule on one batch."""
    x, err, lam = levenberg_marquardt(rr, targets, x0, k_full, None, opts)
    key = torch.nan_to_num(err, nan=_BIG, posinf=_BIG)
    idx = torch.topk(key, capacity).indices
    x2, err2, _ = levenberg_marquardt(rr, targets[idx], x[idx], r_refine, lam[idx], opts)
    return x.index_copy(0, idx, x2), err.index_copy(0, idx, err2)


def energies(rr, theta, targets, block: int = 4096):
    """Σ r² of each element, evaluated in blocks."""
    return torch.cat([kin.energy(rr, theta[i:i + block], targets[i:i + block])
                      for i in range(0, theta.shape[0], block)])
