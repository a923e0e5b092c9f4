"""Error-function (residual module) protocol, after momentum_tpu/errors/base.py.

Every error function is a frozen dataclass of padded constraint tensors with
pure functions of an `EvalContext`:

    raw(ctx)       -> (f, w)   raw residual vectors (..., C, D) + weights (C,)
    residual(ctx)  -> (..., C*D) GN rows, scaled by sqrt(weight · w · ρ'(‖f‖²))
    error(ctx)     -> (...,)   exact energy  weight · Σ_c w_c · ρ(‖f_c‖²)

Unused rows have weight 0 and parent 0. The robust row scale is frozen
(detached) as in JAX (stop_gradient, momentum_tpu/errors/base.py:97-107),
so the forward-mode Jacobian of the rows is the reference's IRLS one.

Modules with structured Jacobians may also add their JᵀJ, Jᵀr and Σ rows²
straight into the normal equations without forming rows (the reference's
per-module getSolverDerivatives rank updates, gauss_newton_solver.cpp:
113-221):

    accumulate_normal(character, ctx, jc, pt_mat, acc) -> acc
    acc = (jtj (..., P, P), jtr (..., P), sq (...,))

with the GN step solving (JᵀJ + D) δ = Jᵀr and x_new = x − δ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["EvalContext", "ErrorFunction", "VectorErrorFunction", "UnionErrorFunction",
           "pad_rows"]


def pad_rows(arr, capacity: int, fill=0) -> np.ndarray:
    """A leading-axis table padded to a static capacity (default zero-fill),
    on the host."""
    arr = np.asarray(arr)
    out = np.full((capacity,) + arr.shape[1:], fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class EvalContext:
    """State shared by all error functions of one evaluation (one FK pass,
    and one skinning pass when a module needs the mesh;
    skeleton_solver_function.h:21-95)."""

    model_params: torch.Tensor  # (..., P)
    joint_params: torch.Tensor  # (..., nJ*7)
    skel_states: torch.Tensor  # (..., nJ, 8) global skeleton states
    mesh_vertices: Optional[torch.Tensor] = None  # (..., V, 3) posed
    mesh_normals: Optional[torch.Tensor] = None  # (..., V, 3)
    rest_vertices: Optional[torch.Tensor] = None  # (..., V, 3) after the blend shapes


class ErrorFunction:
    """Base for residual modules: subclasses hold a scalar `weight` tensor,
    an optional `loss` and implement `raw(character, ctx) -> (f, w)`.
    `needs_mesh` marks modules that read ctx.mesh_vertices.

    A module with an analytic Jacobian (`has_analytic_jacobian`) implements
    `jacobian_model(character, ctx, jc, pt_mat) -> (rows, J (..., R, P))`,
    straight to model space, or `jacobian(character, ctx, jc) -> (rows,
    J_joint (..., R, nJ*7), J_model (..., R, P) or None)`, whose joint-space
    rows the solver function chains through the parameter transform."""

    needs_mesh: bool = False
    has_analytic_jacobian: bool = False
    has_normal_contrib: bool = False

    def supports_normal_contrib(self, character) -> bool:
        """Whether accumulate_normal covers this module's records for this
        character."""
        return self.has_normal_contrib

    def raw(self, character, ctx: EvalContext):
        raise NotImplementedError

    def _loss(self) -> GeneralizedLoss:
        return getattr(self, "loss", GeneralizedLoss())

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        """weight · Σ w_c · ρ(‖f_c‖²) (joint_error_function-inl.h:35-54),
        keeping leading batch dims."""
        f, w = self.raw(character, ctx)
        sq = torch.sum(f * f, dim=-1)
        return self.weight * torch.sum(w * self._loss().value(sq), dim=-1)

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        """Flattened GN rows sqrt(weight · w · ρ'(‖f‖²)) · f."""
        f, w = self.raw(character, ctx)
        scale = self._row_scale(w, torch.sum(f * f, dim=-1))
        return (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))

    def num_rows(self) -> int:
        raise NotImplementedError

    def _row_scale(self, w, sq):
        """sqrt(weight·w·ρ'): 1/c at α = 2, where ρ'·c² == 1."""
        scale = torch.sqrt(torch.clamp(self.weight * w, min=0.0))
        loss = self._loss()
        if loss.alpha == 2.0:
            return scale * (1.0 / loss.c)
        return scale * torch.sqrt(torch.clamp(loss.deriv(sq), min=0.0)).detach()


class VectorErrorFunction(ErrorFunction):
    """Base for modules whose raw() is (C, D) with static C, D."""

    D: int = 3

    def num_rows(self) -> int:
        return self.constraint_count() * self.D

    def constraint_count(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class UnionErrorFunction(ErrorFunction):
    """Several modules in one slot (diff_ik union_error_function.h
    UnionErrorFunctionT): the children's rows concatenated, each scaled by
    sqrt(weight), and the sum of their energies times weight. It has no
    analytic Jacobian, as in JAX: its rows reach the solver by forward mode."""

    children: tuple = ()
    weight: Optional[torch.Tensor] = None  # scalar; None is 1

    def _weight(self, ref: torch.Tensor) -> torch.Tensor:
        return ref.new_ones(()) if self.weight is None else self.weight

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        total = sum(c.error(character, ctx) for c in self.children)
        return self._weight(ctx.model_params) * total

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        rows = [c.residual(character, ctx) for c in self.children]
        if not rows:
            return ctx.model_params.new_zeros(ctx.model_params.shape[:-1] + (0,))
        w = torch.sqrt(self._weight(ctx.model_params))
        return torch.cat([w * r for r in rows], dim=-1)

    def num_rows(self) -> int:
        return sum(c.num_rows() for c in self.children)

    @property
    def needs_mesh(self) -> bool:
        return any(c.needs_mesh for c in self.children)
