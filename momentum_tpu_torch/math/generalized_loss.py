"""Barron's general & adaptive robust loss on *squared* residuals
(momentum/math/generalized_loss.h:14-58), as momentum_tpu/math/
generalized_loss.py computes it:

    alpha = 2   : L2        f(s) = s/c²
    alpha = 1   : L1/Huber  f(s) = sqrt(s/c² + 1) − 1
    alpha = 0   : Cauchy    f(s) = log(½·s/c² + 1)
    alpha = -∞  : Welsch    f(s) = 1 − exp(−½·s/c²)    (sentinel ALPHA_WELSCH)
    otherwise   : Barron general form (eq. 1 of arXiv:1701.03077)
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GeneralizedLoss", "ALPHA_L2", "ALPHA_L1", "ALPHA_CAUCHY", "ALPHA_WELSCH"]

ALPHA_L2 = 2.0
ALPHA_L1 = 1.0
ALPHA_CAUCHY = 0.0
ALPHA_WELSCH = -1e9
_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GeneralizedLoss:
    """Robust loss; `value`/`deriv` map squared errors elementwise."""

    alpha: float = ALPHA_L2
    c: float = 1.0

    def __post_init__(self):
        if not self.c > 0:
            raise ValueError(f"Loss parameter c must be positive, got {self.c}")

    @property
    def _inv_c2(self) -> float:
        return 1.0 / (self.c * self.c)

    def _kind(self) -> str:
        a = self.alpha
        if abs(a - ALPHA_L2) <= _EPS:
            return "l2"
        if abs(a - ALPHA_L1) <= _EPS:
            return "l1"
        if abs(a - ALPHA_CAUCHY) <= _EPS:
            return "cauchy"
        if a == ALPHA_WELSCH:
            return "welsch"
        return "general"

    def value(self, sqr_error: torch.Tensor) -> torch.Tensor:
        ic2 = self._inv_c2
        s = sqr_error * ic2
        kind = self._kind()
        if kind == "l2":
            return s
        if kind == "l1":
            return torch.sqrt(s + 1.0) - 1.0
        if kind == "cauchy":
            return torch.log1p(0.5 * s)
        if kind == "welsch":
            return 1.0 - torch.exp(-0.5 * s)
        a = self.alpha
        d = abs(a - 2.0)
        return (d / a) * (torch.pow(s / d + 1.0, 0.5 * a) - 1.0)

    def deriv(self, sqr_error: torch.Tensor) -> torch.Tensor:
        """d loss / d (squared error)."""
        ic2 = self._inv_c2
        s = sqr_error * ic2
        kind = self._kind()
        if kind == "l2":
            return torch.full_like(sqr_error, ic2)
        if kind == "l1":
            return 0.5 * ic2 / torch.sqrt(s + 1.0)
        if kind == "cauchy":
            return ic2 / (s + 2.0)
        if kind == "welsch":
            return 0.5 * ic2 * torch.exp(-0.5 * s)
        a = self.alpha
        d = abs(a - 2.0)
        return 0.5 * ic2 * torch.pow(s / d + 1.0, 0.5 * a - 1.0)

    def sqrt_deriv(self, sqr_error: torch.Tensor) -> torch.Tensor:
        """sqrt(deriv): the GN row scale (joint_error_function-inl.h scales
        the rows by sqrt(w·ρ'))."""
        return torch.sqrt(torch.clamp(self.deriv(sqr_error), min=0.0))
