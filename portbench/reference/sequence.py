"""Plain Gauss-Newton over a whole take, from the semantics of momentum's
SequenceSolver with the options the configuration states:

  unknowns: per-frame parameters pf (F, p) and universal ones u (nu,),
    joined into θ_f; energy E = Σ_f ‖locators(θ_f) − target_f‖²
    + Σ_f ‖w·(θ_{f+1} − θ_f)‖² (the smoothness term, w = √(weight·0.1));
  per iteration: the block-tridiagonal normal equations with the universal
    arrowhead, plus reg·I; a global per-parameter equilibration D^-1/2
    (max over frames), the band's pivots lifted to a floor plus a jitter,
    the universal block's jitter; the system solved by one block Cholesky
    over the frames and a Schur complement on the universal parameters;
    the energy at the pre-step parameters; stop once it changes by
    ≤ threshold·FLT_EPS relative.

The block Cholesky runs frame after frame, so it shares nothing with the
partitioned solve of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import kinematics as kin

_FLT_EPS = float(torch.finfo(torch.float32).eps)
_FLT_MIN = float(torch.finfo(torch.float32).tiny)


class Take:
    """A take's fixed data: the rig, the targets (F, L, 3), which parameters
    are universal, and the smoothness weight w."""

    def __init__(self, rr, targets, universal: torch.Tensor, smooth_w: float):
        self.rr, self.targets, self.w = rr, targets, smooth_w
        dev = targets.device
        self.u_idx = torch.nonzero(universal).flatten().to(dev)
        self.pf_idx = torch.nonzero(~universal).flatten().to(dev)
        self.order = torch.argsort(torch.cat([self.pf_idx, self.u_idx]))

    def join(self, pf, u):
        both = torch.cat([pf, u.expand(pf.shape[0], u.shape[-1])], dim=-1)
        return both.index_select(-1, self.order)

    def frame_energies(self, pf, u):
        """(F,) the position energy of each frame."""
        return kin.energy(self.rr, self.join(pf, u), self.targets)

    def energy(self, pf, u):
        theta = self.join(pf, u)
        s = self.w * (theta[1:] - theta[:-1])
        return torch.sum(kin.energy(self.rr, theta, self.targets)) + torch.sum(s * s)


def _band_cholesky_solve(diag, upper, rhs):
    """x with T x = rhs for T SPD block-tridiagonal: diag (F, p, p), upper
    (F-1, p, p) = T[f, f+1], rhs (F, p, k); one block Cholesky T = L Lᵀ."""
    f_total = diag.shape[0]
    chols, cs, zs = [], [], []
    a = diag[0]
    for f in range(f_total):
        if f:
            a = diag[f] - cs[-1].transpose(-1, -2) @ cs[-1]
        chol = torch.linalg.cholesky_ex(a)[0]
        b = rhs[f] if not f else rhs[f] - cs[-1].transpose(-1, -2) @ zs[-1]
        zs.append(torch.linalg.solve_triangular(chol, b, upper=False))
        chols.append(chol)
        if f + 1 < f_total:
            cs.append(torch.linalg.solve_triangular(chol, upper[f], upper=False))
    xs = [torch.linalg.solve_triangular(chols[-1].transpose(-1, -2), zs[-1], upper=True)]
    for f in range(f_total - 2, -1, -1):
        xs.append(torch.linalg.solve_triangular(chols[f].transpose(-1, -2),
                                                zs[f] - cs[f] @ xs[-1], upper=True))
    return torch.stack(xs[::-1])


def _normal_equations(take: Take, pf, u):
    theta = take.join(pf, u)
    rows, jac = kin.residual_and_jacobian(take.rr, theta, take.targets)
    j_pf = jac.index_select(-1, take.pf_idx)
    j_u = jac.index_select(-1, take.u_idx)
    j_pf_t = j_pf.transpose(-1, -2)
    diag = j_pf_t @ j_pf
    uc = j_pf_t @ j_u
    ub = j_u.flatten(0, 1).T @ j_u.flatten(0, 1)
    rf = (j_pf_t @ rows[..., None])[..., 0]
    ru = j_u.flatten(0, 1).T @ rows.flatten()
    # smoothness: rows w·(θ_{f+1} − θ_f), whose Jacobian is −w·I and +w·I on
    # the per-frame columns and 0 on the universal ones
    w2 = take.w * take.w
    p = pf.shape[-1]
    eye = torch.eye(p, dtype=pf.dtype, device=pf.device)
    s_pf = take.w * (pf[1:] - pf[:-1])
    diag[:-1] += w2 * eye
    diag[1:] += w2 * eye
    upper = (-w2 * eye).expand(pf.shape[0] - 1, p, p).clone()
    rf[:-1] -= take.w * s_pf
    rf[1:] += take.w * s_pf
    return diag, upper, uc, ub, rf, ru


def gn_step(take: Take, pf, u, opts: dict):
    """(d_pf, d_u) of one Gauss-Newton step at (pf, u)."""
    diag, upper, uc, ub, rf, ru = _normal_equations(take, pf, u)
    p, nu = diag.shape[-1], ub.shape[-1]
    dev, dt = diag.device, diag.dtype
    reg = opts["regularization"]
    diag = diag + reg * torch.eye(p, dtype=dt, device=dev)
    ub = ub + reg * torch.eye(nu, dtype=dt, device=dev)
    s = torch.rsqrt(torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1).max(dim=0).values,
                                min=1e-30))
    s_u = torch.rsqrt(torch.clamp(torch.diagonal(ub), min=1e-30))
    diag = diag * s[None, :, None] * s[None, None, :]
    lift = torch.clamp(opts["diag_floor"] - torch.diagonal(diag, dim1=-2, dim2=-1), min=0.0)
    diag = diag + (lift + opts["band_jitter"])[..., None] * torch.eye(p, dtype=dt, device=dev)
    upper = upper * s[None, :, None] * s[None, None, :]
    uc = uc * s[None, :, None] * s_u[None, None, :]
    ub = ub * s_u[:, None] * s_u[None, :] + opts["universal_jitter"] * torch.eye(
        nu, dtype=dt, device=dev)
    rf, ru = rf * s[None, :], ru * s_u
    sol = _band_cholesky_solve(diag, upper, torch.cat([uc, rf[..., None]], dim=-1))
    t_inv_u, t_inv_b = sol[..., :nu], sol[..., nu]
    schur = ub - torch.einsum("fpu,fpv->uv", uc, t_inv_u)
    x_u = torch.linalg.solve(schur, ru - torch.einsum("fpu,fp->u", uc, t_inv_b))
    x_f = t_inv_b - torch.einsum("fpu,u->fp", t_inv_u, x_u)
    return x_f * s[None, :], x_u * s_u


def gauss_newton(take: Take, pf0, u0, opts: dict):
    """(pf, u, energy at the last pre-step parameters, iterations)."""
    pf, u = pf0, u0
    last = float(torch.finfo(torch.float32).max)
    it = 0
    while it < opts["max_iterations"]:
        d_pf, d_u = gn_step(take, pf, u, opts)
        err = float(take.energy(pf, u))
        done = (it + 1 >= opts["min_iterations"]
                and abs(last - err) / (abs(err) + _FLT_MIN) <= opts["threshold"] * _FLT_EPS)
        pf, u, last = pf - d_pf, u - d_u, err
        it += 1
        if done:
            break
    return pf, u, last, it
