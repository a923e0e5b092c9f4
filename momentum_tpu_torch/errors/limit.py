"""LimitErrorFunction: penalties for parameter-limit violations
(limit_error_function.cpp), over the record types the port's ParameterLimits
holds. Per record the raw residual r is zero inside the feasible range and
linear outside; the energy is kLimitWeight (= 10, limit_error_function.h:91)
· weight · Σ w_rec · ρ(r²):

    MinMax        r = clip(θ_i, lo, hi) − θ_i        (model parameter)
    MinMaxJoint   the same over joint parameters

Passive MinMaxJoint records contribute nothing here: they are pre-FK clamps
(ParameterLimits.apply_passive). Linear, LinearJoint, HalfPlane and
Ellipsoid records come with the rest of the error catalog (ROADMAP M3).
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import ErrorFunction, EvalContext
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["LimitErrorFunction", "K_LIMIT_WEIGHT"]

K_LIMIT_WEIGHT = 10.0  # limit_error_function.h:91


def _minmax_residual(vals, bounds):
    return torch.minimum(torch.maximum(vals, bounds[..., 0]), bounds[..., 1]) - vals


@dataclasses.dataclass(frozen=True, eq=False)
class LimitErrorFunction(ErrorFunction):
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    has_normal_contrib = True

    def _pieces(self, character, ctx: EvalContext):
        """-> list of (r (..., M), w (M,)) per record type, in a fixed order."""
        lim = character.limits
        out = []
        if lim.minmax_index.shape[0]:
            vals = ctx.model_params.index_select(-1, lim.minmax_index.long())
            out.append((_minmax_residual(vals, lim.minmax_bounds), lim.minmax_weight))
        if lim.minmax_joint_index.shape[0]:
            vals = ctx.joint_params.index_select(-1, lim.minmax_joint_index.long())
            out.append((_minmax_residual(vals, lim.minmax_joint_bounds),
                        lim.minmax_joint_weight * (1.0 - lim.minmax_joint_passive)))
        return out

    def _scale(self, w, sq):
        """sqrt(kLimitWeight · weight · w · ρ'(r²))."""
        s = torch.sqrt(torch.clamp(K_LIMIT_WEIGHT * self.weight * w, min=0.0))
        if self.loss.alpha == 2.0:
            return s * (1.0 / self.loss.c)
        return s * torch.sqrt(torch.clamp(self.loss.deriv(sq), min=0.0)).detach()

    def raw(self, character, ctx: EvalContext):
        raise NotImplementedError("LimitErrorFunction evaluates per record type")

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        total = torch.zeros(ctx.model_params.shape[:-1], dtype=ctx.model_params.dtype,
                            device=ctx.model_params.device)
        for r, w in self._pieces(character, ctx):
            total = total + torch.sum(w * self.loss.value(r * r), dim=-1)
        return K_LIMIT_WEIGHT * self.weight * total

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        rows = [self._scale(w, r * r) * r for r, w in self._pieces(character, ctx)]
        if not rows:
            return ctx.model_params.new_zeros(ctx.model_params.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    def supports_normal_contrib(self, character) -> bool:
        """The direct path covers the model-parameter records (one nonzero
        Jacobian entry per row); joint-space records need dense rows."""
        return character.limits.counts["minmax_joint"] == 0

    def accumulate_normal(self, character, ctx: EvalContext, jc, pt_mat, acc):
        """Scatter-add JᵀJ/Jᵀr directly: a MinMax row has the single Jacobian
        entry −s·[r ≠ 0] in column i, so its rank-1 update touches the one
        JᵀJ cell (i, i) (limit_error_function.cpp's sparse rank update),
        instead of M dense rows through the Jacobian. Adds into acc's tensors
        in place and returns acc."""
        jtj, jtr, sq = acc
        lim = character.limits
        if not lim.minmax_index.shape[0]:
            return acc
        idx = lim.minmax_index.long()
        r = _minmax_residual(ctx.model_params.index_select(-1, idx), lim.minmax_bounds)
        s = self._scale(lim.minmax_weight, r * r)
        v = -s * (r != 0).to(r.dtype)  # the row's one Jacobian entry
        rs = s * r
        jtr.index_add_(-1, idx, v * rs)
        jtj.diagonal(dim1=-2, dim2=-1).index_add_(-1, idx, v * v)
        sq.add_(torch.sum(rs * rs, dim=-1))
        return acc

    def num_rows_for(self, character) -> int:
        c = character.limits.counts
        return c["minmax"] + c["minmax_joint"]

    @classmethod
    def create(cls, weight=1.0, loss=None, device="cuda"):
        device = resolve(device, "LimitErrorFunction.create")
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())
