"""MPPCA pose prior (math/mppca.h) and its error function
(character_solver/pose_prior_error_function.{h,cpp}), after
momentum_tpu/errors/pose_prior.py.

Mixture of probabilistic PCA: p(x) = Σ_c π_c N(x | μ_c, C_c) with
C_c = W_c·W_cᵀ + σ_c²·I. Precomputed per component (mppca.h:40-59): Cinv_c,
Rpre_c = log π_c − ½ log|C_c| − (d/2) log 2π, and a factor L_c with
L_cᵀ·L_c = C_c⁻¹ for the GN whitening.

The error function keeps the reference's best component
(pose_prior_error_function.cpp:111-114,218-249): the one maximizing
R_c = Rpre_c − ½ d_cᵀ·Cinv_c·d_c; then
    error     = weight · kPosePriorWeight · ½ d*ᵀ·Cinv*·d*       (.cpp:179)
    residual  = sqrt(½·weight·kPosePriorWeight) · L*·d*          (.cpp:181-187)
with kPosePriorWeight = 1e-3 (pose_prior_error_function.h:73). `Mppca`'s
file members read and write .mppca files through io/pose_prior.py.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import ErrorFunction, EvalContext

__all__ = ["Mppca", "PosePriorErrorFunction", "K_POSE_PRIOR_WEIGHT"]

K_POSE_PRIOR_WEIGHT = 1e-3  # pose_prior_error_function.h:73


@dataclasses.dataclass(frozen=True, eq=False)
class Mppca:
    """Precomputed MPPCA mixture (K components over d dimensions)."""

    mu: torch.Tensor  # (K, d)
    cinv: torch.Tensor  # (K, d, d)
    l: torch.Tensor  # (K, d, d), LᵀL = Cinv
    rpre: torch.Tensor  # (K,)
    names: tuple = ()

    @property
    def num_components(self) -> int:
        return self.mu.shape[0]

    @property
    def dim(self) -> int:
        return self.mu.shape[1]

    @classmethod
    def from_components(cls, pi, mu, w_list, sigma2, names=(), device="cuda"):
        """Build from raw mixture parameters (mppca.h set(), mppca.cpp), in
        numpy float64, stored as float32."""
        device = resolve(device, "Mppca.from_components")
        pi = np.asarray(pi, np.float64)
        mu = np.asarray(mu, np.float64)
        sigma2 = np.asarray(sigma2, np.float64)
        k, d = mu.shape
        cinv = np.zeros((k, d, d))
        l = np.zeros((k, d, d))
        rpre = np.zeros(k)
        for c in range(k):
            w = np.asarray(w_list[c], np.float64).reshape(d, -1)
            cov = w @ w.T + sigma2[c] * np.eye(d)
            cinv[c] = np.linalg.inv(cov)
            l[c] = np.linalg.cholesky(cinv[c]).T  # Cinv = G·Gᵀ, L = Gᵀ: LᵀL = Cinv
            _, logdet = np.linalg.slogdet(cov)
            rpre[c] = (math.log(max(pi[c], 1e-300)) - 0.5 * logdet
                       - 0.5 * d * math.log(2 * math.pi))

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return cls(mu=t(mu), cinv=t(cinv), l=t(l), rpre=t(rpre), names=tuple(names))

    def log_probability(self, x: torch.Tensor) -> torch.Tensor:
        """Best-component log-likelihood max_c R_c."""
        diff = x[..., None, :] - self.mu
        sq = 0.5 * torch.einsum("...kd,kde,...ke->...k", diff, self.cinv, diff)
        return torch.max(self.rpre - sq, dim=-1).values

    def get_mixture(self, i_model: int):
        """(pi, mu, W, sigma2) of component `i_model`, recovered from the
        stored covariance in numpy float64 (pymomentum Mppca.get_mixture,
        momentum_geometry.cpp:526-583): sigma² is the smallest covariance
        eigenvalue, W's columns the eigenvectors above it scaled by the
        square roots of the remainders (those past 1e-4), and pi comes back
        out of Rpre."""
        if not 0 <= i_model < self.num_components:
            raise IndexError(f"component {i_model} out of range")
        cinv = self.cinv[i_model].detach().cpu().double().numpy()
        d = cinv.shape[0]
        evals_inv, evecs = np.linalg.eigh(cinv)  # ascending in Cinv
        c_eigs = 1.0 / evals_inv  # descending covariance eigenvalues
        sigma2 = float(c_eigs[-1])
        lam = c_eigs - sigma2
        below = np.flatnonzero(lam < 1e-4)
        rank = int(below[0]) if below.size else d
        w = evecs[:, :rank] * np.sqrt(np.maximum(lam[:rank], 0.0))[None, :]
        c_logdet = float(-np.sum(np.log(evals_inv)))
        log_pi = float(self.rpre[i_model]) + 0.5 * c_logdet + 0.5 * d * np.log(2.0 * np.pi)
        return float(np.exp(log_pi)), self.mu[i_model].detach().cpu().numpy(), w, sigma2

    # the .mppca file members (pymomentum Mppca.save / load / to_bytes /
    # from_bytes), over io/pose_prior.py
    def save(self, path) -> None:
        from momentum_tpu_torch.io.pose_prior import save_mppca

        save_mppca(path, self)

    def to_bytes(self) -> bytes:
        from momentum_tpu_torch.io.pose_prior import mppca_to_bytes

        return mppca_to_bytes(self)

    @classmethod
    def load(cls, path, device="cuda") -> "Mppca":
        from momentum_tpu_torch.io.pose_prior import load_mppca

        return load_mppca(path, device)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "Mppca":
        from momentum_tpu_torch.io.pose_prior import mppca_from_bytes

        return mppca_from_bytes(bytes(data), device)


@dataclasses.dataclass(frozen=True, eq=False)
class PosePriorErrorFunction(ErrorFunction):
    prior: Mppca
    weight: torch.Tensor
    # prior dimension -> model parameter index (−1: unmapped, reads 0.0); the
    # reference's ppMap_ by name (pose_prior_error_function.cpp:41-54)
    param_index: tuple = ()
    # Sᵀ·Cinv_k·S (K, P, P) for the normal equations: J = coef·L_k·S is
    # constant per selected component, so JᵀJ is a gather. Built by create();
    # None when constructed directly (then only dense rows are available).
    sub_jtj: Optional[torch.Tensor] = None

    @property
    def has_normal_contrib(self) -> bool:
        return self.sub_jtj is not None

    @functools.cached_property
    def _selection(self):
        """S, the static dim → parameter selection, as its nonzero pairs:
        (prior dims that map to a parameter, their parameter indices), built
        once for each module."""
        idx = np.asarray(self.param_index, np.int64)
        dims = np.flatnonzero(idx >= 0)
        dev = self.prior.mu.device
        return (torch.as_tensor(dims, device=dev), torch.as_tensor(idx[dims], device=dev))

    def _sub_params(self, model_params: torch.Tensor) -> torch.Tensor:
        dims, params = self._selection
        x = model_params.new_zeros(model_params.shape[:-1] + (self.prior.dim,))
        x[..., dims] = model_params.index_select(-1, params)
        return x

    def _best(self, model_params):
        """(best component (...,), d* (..., d), ½ d*ᵀCinv*d* (...,))."""
        diff = self._sub_params(model_params)[..., None, :] - self.prior.mu  # (..., K, d)
        sq = 0.5 * torch.einsum("...kd,kde,...ke->...k", diff, self.prior.cinv, diff)
        best = torch.argmax(self.prior.rpre - sq, dim=-1)
        d_best = torch.gather(diff, -2, best[..., None, None].expand(
            best.shape + (1, diff.shape[-1])))[..., 0, :]
        sq_best = torch.gather(sq, -1, best[..., None])[..., 0]
        return best, d_best, sq_best

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        _, _, sq_best = self._best(ctx.model_params)
        return self.weight * K_POSE_PRIOR_WEIGHT * sq_best

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        best, d_best, _ = self._best(ctx.model_params)
        rows = torch.einsum("...de,...e->...d", self.prior.l[best], d_best)
        return torch.sqrt(0.5 * K_POSE_PRIOR_WEIGHT * self.weight) * rows

    def num_rows(self) -> int:
        return self.prior.dim

    has_analytic_jacobian = True

    def jacobian(self, character, ctx: EvalContext, jc):
        """rows = c·L*·d*, J_model = c·L*·S with c = √(½·kW·w) and S the
        selection: column j of L* lands on parameter param_index[j], an
        unmapped dimension nowhere (pose_prior_error_function.cpp:181-195).
        No joint-space rows: (rows, None, J_model)."""
        best, d_best, _ = self._best(ctx.model_params)
        coef = torch.sqrt(0.5 * K_POSE_PRIOR_WEIGHT * self.weight)
        l_best = coef * self.prior.l[best]  # (..., d, d)
        rows = torch.einsum("...de,...e->...d", l_best, d_best)
        dims, params = self._selection
        j_model = l_best.new_zeros(l_best.shape[:-1] + ctx.model_params.shape[-1:])
        return rows, None, j_model.index_add(-1, params, l_best.index_select(-1, dims))

    def accumulate_normal(self, character, ctx: EvalContext, jc, pt_mat, acc):
        """With J = coef·L*·S constant per selected component, JᵀJ =
        coef²·SᵀCinv*S is a gather from the per-component table and
        Jᵀr = coef²·Sᵀ(Cinv*·d*) a d → P scatter. Adds into acc's tensors in
        place and returns acc."""
        jtj, jtr, sq = acc
        best, d_best, sq_best = self._best(ctx.model_params)
        coef2 = 0.5 * K_POSE_PRIOR_WEIGHT * self.weight
        jtj.add_(coef2 * self.sub_jtj[best])
        # Cinv_k·d* for every component k, then the selected one: (..., K, d)
        # instead of gathering a (..., d, d) matrix per element
        cinvd_all = torch.einsum("kde,...e->...kd", self.prior.cinv, d_best)
        cinvd = torch.gather(cinvd_all, -2, best[..., None, None].expand(
            best.shape + (1, cinvd_all.shape[-1])))[..., 0, :]
        dims, params = self._selection
        jtr.index_add_(-1, params, coef2 * cinvd[..., dims])
        sq.add_(2.0 * coef2 * sq_best)  # Σ rows² = coef²·d*ᵀCinv*d*
        return acc

    @classmethod
    def create(cls, prior: Mppca, parameter_names, weight=1.0):
        """Map prior dimensions onto model parameters by name (loadInternal,
        pose_prior_error_function.cpp:41-54) and build sub_jtj in float64."""
        name_to_idx = {n: i for i, n in enumerate(parameter_names)}
        idx = (tuple(name_to_idx.get(n, -1) for n in prior.names) if prior.names
               else tuple(range(prior.dim)))
        idx_np = np.asarray(idx, np.int64)
        sel = np.zeros((prior.dim, len(parameter_names)))
        valid = idx_np >= 0
        sel[np.arange(prior.dim)[valid], idx_np[valid]] = 1.0
        cinv = prior.cinv.detach().cpu().double().numpy()
        sub_jtj = np.einsum("dp,kde,eq->kpq", sel, cinv, sel)
        dev = prior.mu.device
        return cls(prior=prior, weight=torch.tensor(weight, dtype=torch.float32, device=dev),
                   param_index=idx,
                   sub_jtj=torch.as_tensor(sub_jtj, dtype=torch.float32, device=dev))
