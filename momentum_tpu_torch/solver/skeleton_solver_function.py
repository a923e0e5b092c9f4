"""SkeletonSolverFunction: a Character + error functions seen by the solver
(skeleton_solver_function.h:21-95): one FK per evaluation, and one skinning
pass when a module needs the posed mesh, shared by all error functions; rows
concatenated in order.

The Jacobian of the modules with an analytic one is chained through the
parameter transform; the others' (the AD modules: body.py's, Plane) comes
by forward mode through the same context (JAX's linearize plus vmapped
JVP, momentum_tpu/solver/skeleton_solver_function.py:167-182), row-aligned
after the analytic modules' rows.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.character.skinning import skin_points, update_normals
from momentum_tpu_torch.errors.base import EvalContext
from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context
from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

__all__ = ["SkeletonSolverFunction"]


@dataclasses.dataclass(frozen=True, eq=False)
class SkeletonSolverFunction:
    character: Character
    error_functions: tuple
    # take the forward-mode Jacobian even when every module has an analytic
    # one (solve_ik then passes no jacobian_fn), for tests and A/Bs
    force_ad: bool = False
    # take a module's model-space `jacobian_model` where it has one; False
    # takes its joint-space `jacobian` chained through the parameter
    # transform, JAX's default (the sequence solver's frame Jacobians take
    # it, as JAX's do)
    prefer_fused: bool = True

    def context(self, model_params: torch.Tensor) -> EvalContext:
        """One FK pass (parameter transform, passive limits, global states),
        then, if a module needs the mesh, the rest mesh (blend shapes, then
        face-expression deltas), LBS skinning and the posed normals."""
        char = self.character
        jp = char.limits.apply_passive(char.parameter_transform.apply(model_params))
        nj = char.skeleton.num_joints
        states = fk.global_skel_states(char.skeleton, jp.reshape(jp.shape[:-1] + (nj, 7)))
        mesh = {}
        if any(ef.needs_mesh for ef in self.error_functions):
            rest = char.mesh.vertices
            body, face = char.shape_bases
            if body is not None:
                basis, index, _ = body
                rest = basis.apply(model_params.index_select(-1, index))
            if face is not None:
                basis, index, _ = face
                rest = rest + basis.compute_deltas(model_params.index_select(-1, index))
            verts = skin_points(char.skin_weights, states, char.inverse_bind_pose, rest)
            mesh = dict(mesh_vertices=verts, mesh_normals=update_normals(verts, char.mesh.faces),
                        rest_vertices=rest)
        return EvalContext(model_params=model_params, joint_params=jp,
                           skel_states=states, **mesh)

    def residual(self, model_params: torch.Tensor) -> torch.Tensor:
        ctx = self.context(model_params)
        return torch.cat([ef.residual(self.character, ctx)
                          for ef in self.error_functions], dim=-1)

    def error(self, model_params: torch.Tensor) -> torch.Tensor:
        """Exact robust energy Σ_ef weight·Σ w·ρ(‖f‖²)
        (skeleton_solver_function.cpp getError:64-82)."""
        ctx = self.context(model_params)
        return sum(ef.error(self.character, ctx) for ef in self.error_functions)

    def gradient(self, model_params: torch.Tensor) -> torch.Tensor:
        """d error / d model params by reverse mode (through K1's backward
        on the card, ROADMAP F8)."""
        return torch.func.grad(self.error)(model_params)

    @property
    def fully_analytic(self) -> bool:
        """Whether every module has an analytic Jacobian (and force_ad is off)."""
        return not self.force_ad and all(ef.has_analytic_jacobian
                                         for ef in self.error_functions)

    def residual_and_jacobian(self, model_params: torch.Tensor):
        """(rows (..., R), J (..., R, P)): the modules with a fused
        model-space Jacobian (`jacobian_model`) first, then the others with
        an analytic one, their joint-space rows chained through the
        parameter transform, then the AD modules' by forward mode."""
        return self._rows_and_jacobian(self.context(model_params), self.error_functions)

    def _rows_and_jacobian(self, ctx: EvalContext, error_functions):
        """The fused modules' rows and J, then the blockwise ones': their
        joint-space rows J (..., R, nJ·7) times the parameter transform (a
        plain GEMM, outside any kernel in JAX too) plus their model-space
        blocks (the blend-shape columns); then the rows and J of the modules
        without an analytic Jacobian, by forward mode through a context of
        their own."""
        analytic = [ef for ef in error_functions if ef.has_analytic_jacobian]
        ad_efs = [ef for ef in error_functions if not ef.has_analytic_jacobian]
        rows, jacs = [], []
        if analytic:
            self._analytic_rows_and_jacobian(ctx, analytic, rows, jacs)
        if ad_efs:
            def ad_residual(x):
                c2 = self.context(x)
                return torch.cat([ef.residual(self.character, c2) for ef in ad_efs], dim=-1)

            r, jt = ad_jacobian(ad_residual, ctx.model_params)
            rows.append(r)
            jacs.append(jt.transpose(-1, -2))
        return torch.cat(rows, dim=-1), torch.cat(jacs, dim=-2)

    def _analytic_rows_and_jacobian(self, ctx: EvalContext, error_functions, rows, jacs):
        """Append the analytic modules' rows and J to `rows` and `jacs`."""
        jc = make_jacobian_context(self.character, ctx)
        pt_mat = self.character.parameter_transform.transform
        fused = [ef for ef in error_functions
                 if self.prefer_fused and hasattr(ef, "jacobian_model")]
        blockwise = [ef for ef in error_functions if not any(ef is f for f in fused)]
        for ef in fused:
            r, j = ef.jacobian_model(self.character, ctx, jc, pt_mat)
            rows.append(r)
            jacs.append(j)
        if blockwise:
            jp_blocks, model_blocks = [], []
            for ef in blockwise:
                r, j_jp, j_model = ef.jacobian(self.character, ctx, jc)
                rows.append(r)
                jp_blocks.append(r.new_zeros(r.shape + pt_mat.shape[:1]) if j_jp is None
                                 else j_jp)
                model_blocks.append(r.new_zeros(r.shape + pt_mat.shape[1:]) if j_model is None
                                    else j_model)
            jacs.append(torch.cat(jp_blocks, dim=-2) @ pt_mat + torch.cat(model_blocks, dim=-2))

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
