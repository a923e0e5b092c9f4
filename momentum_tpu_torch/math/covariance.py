"""Low-rank covariance C = σ²·I + AᵀA (math/covariance_matrix.h:17-85),
after momentum_tpu/math/covariance.py: products, solves and the
log-determinant by Woodbury without forming AᵀA. With A (k, n), k ≪ n,

    C⁻¹·x = x/σ² − Aᵀ(σ²·I_k + AAᵀ)⁻¹A·x / σ²
    log|C| = 2(n−k)·log σ + log|σ²I_k + AAᵀ|

The k × k solve is linalg.psd_solve, through K2+K3 for a float32 system
on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math.linalg import psd_solve

__all__ = ["LowRankCovarianceMatrix"]


@dataclasses.dataclass(frozen=True, eq=False)
class LowRankCovarianceMatrix:
    a: torch.Tensor  # (k, n) basis
    sigma: torch.Tensor  # scalar

    @classmethod
    def create(cls, sigma, a, device="cuda") -> "LowRankCovarianceMatrix":
        device = resolve(device, "LowRankCovarianceMatrix.create")
        return cls(a=torch.as_tensor(np.asarray(a, np.float32), device=device),
                   sigma=torch.as_tensor(np.float32(sigma), device=device))

    @property
    def dim(self) -> int:
        return self.a.shape[1]

    @property
    def rank(self) -> int:
        return self.a.shape[0]

    def _small(self) -> torch.Tensor:
        eye = torch.eye(self.rank, dtype=self.a.dtype, device=self.a.device)
        return self.sigma ** 2 * eye + self.a @ self.a.T

    def times_vec(self, x: torch.Tensor) -> torch.Tensor:
        """C·x = σ²x + Aᵀ(Ax), x (n,) or (n, m)."""
        return self.sigma ** 2 * x + self.a.T @ (self.a @ x)

    def inverse_times_vec(self, x: torch.Tensor) -> torch.Tensor:
        """C⁻¹·x by Woodbury, x (n,) or (n, m)."""
        core = psd_solve(self._small(), self.a @ x)
        return (x - self.a.T @ core) / self.sigma ** 2

    def log_determinant(self) -> torch.Tensor:
        n, k = self.dim, self.rank
        _, logdet_small = torch.linalg.slogdet(self._small())
        return 2.0 * (n - k) * torch.log(self.sigma) + logdet_small

    def inverse_log_determinant(self) -> torch.Tensor:
        return -self.log_determinant()
