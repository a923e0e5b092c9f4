"""PositionErrorFunction (position_error_function.{h,cpp}:15-27):

    f_c = WorldTransform(parent_c) · offset_c − target_c          (3 rows)

Constraint tables are padded to a static capacity with weight-0 rows whose
parent is 0. Orientation and model-parameter residuals come with the full
residual stack (ROADMAP M2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["PositionErrorFunction"]


def _pad_rows(arr: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros((capacity,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class PositionErrorFunction(VectorErrorFunction):
    """3D point → target constraints ("locator" style)."""

    parent: torch.Tensor  # (C,) int32 joint index
    offset: torch.Tensor  # (C, 3) point in the joint-local frame
    target: torch.Tensor  # (..., C, 3) world-space target
    cweight: torch.Tensor  # (C,) per-constraint weight (0 = padding)
    weight: torch.Tensor  # scalar global weight
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 3
    has_analytic_jacobian = True

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def _parents(self, ctx: EvalContext) -> torch.Tensor:
        # clamped so that no table, padded or not, gathers out of range (ROADMAP F3)
        return self.parent.clamp(0, ctx.skel_states.shape[-2] - 1)

    def _world(self, ctx: EvalContext, parents: torch.Tensor) -> torch.Tensor:
        states = ctx.skel_states.index_select(-2, parents)  # (..., C, 8)
        return ss.transform_points(states, self.offset)

    def raw(self, character, ctx: EvalContext):
        return self._world(ctx, self._parents(ctx)) - self.target, self.cweight

    def jacobian_model(self, character, ctx: EvalContext, jc, pt_mat):
        """Rows (..., 3C) and d(rows)/d(model params) (..., 3C, P) through
        the merged-factor contraction
        (analytic_jacobian.fused_point_jacobian_model_merged)."""
        from momentum_tpu_torch.solver.analytic_jacobian import (
            fused_point_jacobian_model_merged)

        parents = self._parents(ctx)
        world = self._world(ctx, parents)
        f = world - self.target
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        j = fused_point_jacobian_model_merged(jc, world, parents, pt_mat, scale=scale)
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j.reshape(j.shape[:-3] + (rows.shape[-1], pt_mat.shape[1]))

    @classmethod
    def create(cls, parent, offset, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device=None):
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        offset = np.asarray(offset, np.float32).reshape(n, 3)
        target = np.asarray(target, np.float32).reshape(n, 3)
        cweight = (np.ones(n, np.float32) if cweight is None
                   else np.asarray(cweight, np.float32))
        cap = capacity or n

        def t(x):
            return torch.as_tensor(_pad_rows(x, cap), device=device)

        return cls(parent=t(parent), offset=t(offset), target=t(target),
                   cweight=t(cweight),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())
