"""SkeletonSolverFunction: a Character + error functions seen by the solver
(skeleton_solver_function.h:21-95): one FK per evaluation shared by all
error functions, rows concatenated in order.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.errors.base import EvalContext
from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context

__all__ = ["SkeletonSolverFunction"]


@dataclasses.dataclass(frozen=True, eq=False)
class SkeletonSolverFunction:
    character: Character
    error_functions: tuple

    def context(self, model_params: torch.Tensor) -> EvalContext:
        """One FK pass: parameter transform, passive limits, global states."""
        char = self.character
        jp = char.limits.apply_passive(char.parameter_transform.apply(model_params))
        nj = char.skeleton.num_joints
        states = fk.global_skel_states(char.skeleton, jp.reshape(jp.shape[:-1] + (nj, 7)))
        return EvalContext(model_params=model_params, joint_params=jp,
                           skel_states=states)

    def residual(self, model_params: torch.Tensor) -> torch.Tensor:
        ctx = self.context(model_params)
        return torch.cat([ef.residual(self.character, ctx)
                          for ef in self.error_functions], dim=-1)

    def error(self, model_params: torch.Tensor) -> torch.Tensor:
        """Exact robust energy Σ_ef weight·Σ w·ρ(‖f‖²)
        (skeleton_solver_function.cpp getError:64-82)."""
        ctx = self.context(model_params)
        return sum(ef.error(self.character, ctx) for ef in self.error_functions)

    @property
    def fully_analytic(self) -> bool:
        """Whether every module has a fused model-space Jacobian."""
        return all(hasattr(ef, "jacobian_model") for ef in self.error_functions)

    def residual_and_jacobian(self, model_params: torch.Tensor):
        """(rows (..., R), J (..., R, P)): every module's fused model-space
        Jacobian (`jacobian_model`), stacked in module order."""
        return self._rows_and_jacobian(self.context(model_params), self.error_functions)

    def _rows_and_jacobian(self, ctx: EvalContext, error_functions):
        jc = make_jacobian_context(self.character, ctx)
        pt_mat = self.character.parameter_transform.transform
        rows, jacs = [], []
        for ef in error_functions:
            if not hasattr(ef, "jacobian_model"):
                raise NotImplementedError(
                    f"{type(ef).__name__} has no model-space Jacobian in the port")
            r, j = ef.jacobian_model(self.character, ctx, jc, pt_mat)
            rows.append(r)
            jacs.append(j)
        return torch.cat(rows, dim=-1), torch.cat(jacs, dim=-2)

    @property
    def has_structured_modules(self) -> bool:
        return any(ef.supports_normal_contrib(self.character)
                   for ef in self.error_functions)

    def normal_equations(self, model_params: torch.Tensor):
        """(JᵀJ (..., P, P), Jᵀr (..., P), Σ rows² (...,)) in one pass.

        Modules whose accumulate_normal covers them add their contributions
        directly; the rest go through their fused rows and one JᵀJ product
        (the reference's per-module getSolverDerivatives rank updates,
        gauss_newton_solver.cpp:113-221)."""
        ctx = self.context(model_params)
        p = model_params.shape[-1]
        batch = model_params.shape[:-1]
        direct = [ef for ef in self.error_functions
                  if ef.supports_normal_contrib(self.character)]
        dense = [ef for ef in self.error_functions if not any(ef is d for d in direct)]
        jtj = model_params.new_zeros(batch + (p, p))
        jtr = model_params.new_zeros(batch + (p,))
        sq = model_params.new_zeros(batch)
        if dense:
            rows, j = self._rows_and_jacobian(ctx, dense)
            jt = j.transpose(-1, -2)
            jtj.add_(jt @ j)
            jtr.add_((jt @ rows[..., None])[..., 0])
            sq.add_(torch.sum(rows * rows, dim=-1))
        if direct:
            jc = make_jacobian_context(self.character, ctx)
            pt_mat = self.character.parameter_transform.transform
            acc = (jtj, jtr, sq)
            for ef in direct:
                acc = ef.accumulate_normal(self.character, ctx, jc, pt_mat, acc)
        return jtj, jtr, sq

    def residual_sq(self, model_params: torch.Tensor) -> torch.Tensor:
        """Σ rows² without concatenating the rows (the GN surrogate energy
        when `energy_from_residual` is set)."""
        ctx = self.context(model_params)
        total = model_params.new_zeros(model_params.shape[:-1])
        for ef in self.error_functions:
            r = ef.residual(self.character, ctx)
            total = total + torch.sum(r * r, dim=-1)
        return total
