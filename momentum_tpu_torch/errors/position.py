"""Position and orientation residual modules:

  PositionErrorFunction (position_error_function.{h,cpp}:15-27)
      f_c = WorldTransform(parent_c) · offset_c − target_c          (3 rows)
  OrientationErrorFunction (orientation_error_function.cpp:15-40)
      f_c = R_world(parent_c) · R_offset_c − R_target_c (flattened) (9 rows)

  ModelParametersErrorFunction (model_parameters_error_function.h)
      f_p = θ_p − target_p, weighted by pweight_p                   (P rows)

Constraint tables are padded to a static capacity with weight-0 rows whose
parent is 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import (
    ErrorFunction, EvalContext, VectorErrorFunction, pad_rows)
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["PositionErrorFunction", "OrientationErrorFunction",
           "ModelParametersErrorFunction"]

_LN2 = 0.6931471805599453  # scale is log2-parameterized (joint_state.cpp:22-62)


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

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows (..., 3C) and their joint-space Jacobian (..., 3C, nJ·7)
        (the position path of skeleton_derivative.cpp); the solver takes
        jacobian_model, this is its joint-space form."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        parents = self._parents(ctx)
        world = self._world(ctx, parents)
        f = world - self.target
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        j = scale[..., None, None] * point_jacobian(jc, world, parents)
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j.reshape(j.shape[:-3] + (rows.shape[-1], j.shape[-1])), None

    def jacobian_model(self, character, ctx: EvalContext, jc, pt_mat):
        """Rows (..., 3C) and d(rows)/d(model params) (..., 3C, P): K6
        (ops/jacobian.py) where its `kernel_takes` says so, else the
        merged-factor contraction
        (analytic_jacobian.fused_point_jacobian_model_merged)."""
        from momentum_tpu_torch.ops.jacobian import point_jacobian_model

        parents = self._parents(ctx)
        world = self._world(ctx, parents)
        f = world - self.target
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        j = point_jacobian_model(jc, world, parents, pt_mat, scale=scale)
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j.reshape(j.shape[:-3] + (rows.shape[-1], pt_mat.shape[1]))

    has_normal_contrib = True

    def accumulate_normal(self, character, ctx: EvalContext, jc, pt_mat, acc):
        """Closed-form JᵀJ/Jᵀr of the position rows from one combined mask
        product. The row block is affine in the constraint point p_c,

            J_c = Ã_c + B̃_c × p_c + ln2·p_c·ũ_c,

        with (Ã, B̃, ũ) = mask @ (A, B, u) for the per-joint factors
        A_j = transAxis·PT_t − (rotAxis·PT_r) × t_j − ln2·t_j ⊗ PT_s,
        B_j = rotAxis·PT_r and u_j = ln2·PT_s stacked into one (nJ, 7, P)
        factor. Adds into acc's tensors in place and returns acc."""
        from momentum_tpu_torch.solver.analytic_jacobian import _cross2

        jtj, jtr, sq = acc
        nj = jc.anc_mask.shape[0]
        p_dim = pt_mat.shape[1]
        ptj = pt_mat.reshape(nj, 7, p_dim)
        parents = self._parents(ctx)
        world = self._world(ctx, parents)  # (..., C, 3)
        f = world - self.target
        sqe = torch.sum(f * f, dim=-1)
        scale = self._row_scale(self.cweight, sqe)  # (..., C)
        mask = jc.anc_mask.index_select(1, parents).T * scale[..., :, None]  # (..., C, nJ)

        t = jc.joint_pos[..., :, :, None]  # (..., nJ, 3, 1)
        a_t = torch.einsum("...nij,njp->...nip", jc.trans_axis, ptj[:, :3])
        d_r = torch.einsum("...nwk,nkp->...nwp", jc.rot_axis, ptj[:, 3:6])
        a = a_t - _cross2(d_r, t) - _LN2 * t * ptj[:, 6][:, None, :]
        u = (_LN2 * ptj[:, 6:7, :]).expand(a.shape[:-2] + (1, p_dim))
        g = torch.cat([a, d_r, u], dim=-2)  # (..., nJ, 7, P)
        gt = torch.einsum("...cn,...nap->...cap", mask, g)  # (..., C, 7, P)
        p = world[..., :, :, None]
        jbar = gt[..., :3, :] + _cross2(gt[..., 3:6, :], p) + p * gt[..., 6:7, :]
        jb = jbar.reshape(jbar.shape[:-3] + (-1, p_dim))  # (..., 3C, P)
        r = (scale[..., None] * f).reshape(f.shape[:-2] + (-1, 1))  # (..., 3C, 1)
        jtj.add_(jb.transpose(-1, -2) @ jb)
        jtr.add_((jb.transpose(-1, -2) @ r)[..., 0])
        sq.add_(torch.sum(scale * scale * sqe, dim=-1))
        return acc

    @classmethod
    def create(cls, parent, offset, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        device = resolve(device, "PositionErrorFunction.create")
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        offset = np.asarray(offset, np.float32).reshape(n, 3)
        target = np.asarray(target, np.float32).reshape(n, 3)
        cweight = (np.ones(n, np.float32) if cweight is None
                   else np.asarray(cweight, np.float32))
        cap = capacity or n

        def t(x):
            return torch.as_tensor(pad_rows(x, cap), device=device)

        return cls(parent=t(parent), offset=t(offset), target=t(target),
                   cweight=t(cweight),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())


@dataclasses.dataclass(frozen=True, eq=False)
class OrientationErrorFunction(VectorErrorFunction):
    """Match a joint's world rotation (with a local offset) to a target
    rotation; the raw residual is the 9-entry matrix difference."""

    parent: torch.Tensor  # (C,) int32
    offset: torch.Tensor  # (C, 4) quaternion offset in the joint frame
    target: torch.Tensor  # (..., C, 4) target world quaternion
    cweight: torch.Tensor  # (C,)
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 9
    has_analytic_jacobian = True
    has_normal_contrib = True

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def _parents(self, ctx: EvalContext) -> torch.Tensor:
        return self.parent.clamp(0, ctx.skel_states.shape[-2] - 1)  # ROADMAP F3

    def _rotations(self, ctx: EvalContext, parents: torch.Tensor):
        """(R_world·R_offset, R_world·R_offset − R_target), each (..., C, 3, 3)."""
        q = ctx.skel_states.index_select(-2, parents)[..., 3:7]
        r_world = quat.to_rotation_matrix(quat.multiply(q, self.offset))
        return r_world, r_world - quat.to_rotation_matrix(self.target)

    def raw(self, character, ctx: EvalContext):
        _, diff = self._rotations(ctx, self._parents(ctx))
        return diff.reshape(diff.shape[:-2] + (9,)), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows (..., 9C) and their joint-space Jacobian (..., 9C, nJ·7):
        column v_j of R_world has the derivative rotationAxis × v_j (the
        orientation path of skeleton_derivative.cpp); the solver takes
        jacobian_model, this is its joint-space form."""
        from momentum_tpu_torch.solver.analytic_jacobian import vector_jacobian

        parents = self._parents(ctx)
        r_world, diff = self._rotations(ctx, parents)
        f = diff.reshape(diff.shape[:-2] + (9,))
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        j = torch.stack([vector_jacobian(jc, r_world[..., k], parents) for k in range(3)],
                        dim=-2)  # (..., C, 3out, 3col, nJ·7), [i, j] = d r[i, j]
        j = scale[..., None, None, None] * j
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j.reshape(j.shape[:-4] + (rows.shape[-1], j.shape[-1])), None

    def jacobian_model(self, character, ctx: EvalContext, jc, pt_mat):
        """Rows (..., 9C) and d(rows)/d(model params) (..., 9C, P): each
        column v_j of R_world has derivative h1 × v_j."""
        from momentum_tpu_torch.solver.analytic_jacobian import fused_vector_jacobian_model

        parents = self._parents(ctx)
        r_world, diff = self._rotations(ctx, parents)
        f = diff.reshape(diff.shape[:-2] + (9,))
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        # [..., i, j, :] = d r[i, j]: the row-major flatten (i*3 + j) of raw()
        j_full = torch.stack([fused_vector_jacobian_model(jc, r_world[..., j], parents,
                                                          pt_mat, scale=scale)
                              for j in range(3)], dim=-2)  # (..., C, 3out, 3col, P)
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j_full.reshape(j_full.shape[:-4] + (rows.shape[-1], pt_mat.shape[1]))

    def accumulate_normal(self, character, ctx: EvalContext, jc, pt_mat, acc):
        """Closed-form JᵀJ/Jᵀr without the 9-row Jacobian: row (i, j) is
        (h1 × v_j)_i with v_j the j-th column of the orthonormal R_world, so

            JᵀJ = 3·h1ᵀh1 − h1ᵀ(Σ_j v_j v_jᵀ)h1 = 2·h1ᵀh1
            Jᵀr = h1ᵀ · Σ_j (v_j × f_j),  f_j = column j of scale·(R_w − R_t).

        Adds into acc's tensors in place and returns acc."""
        from momentum_tpu_torch.solver.analytic_jacobian import (
            _cross2, fused_rotation_factor)

        jtj, jtr, sq = acc
        parents = self._parents(ctx)
        r_world, diff = self._rotations(ctx, parents)
        f9 = diff.reshape(diff.shape[:-2] + (9,))
        sqe = torch.sum(f9 * f9, dim=-1)
        scale = self._row_scale(self.cweight, sqe)
        h1 = fused_rotation_factor(jc, parents, pt_mat, scale=scale)
        h = h1.reshape(h1.shape[:-3] + (-1, h1.shape[-1]))  # (..., 3C, P)
        jtj.add_(2.0 * (h.transpose(-1, -2) @ h))
        g = torch.sum(_cross2(r_world, scale[..., None, None] * diff), dim=-1)  # (..., C, 3)
        jtr.add_((h.transpose(-1, -2) @ g.reshape(g.shape[:-2] + (-1, 1)))[..., 0])
        sq.add_(torch.sum(scale * scale * sqe, dim=-1))
        return acc

    @classmethod
    def create(cls, parent, target, offset=None, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        device = resolve(device, "OrientationErrorFunction.create")
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        target = np.asarray(target, np.float32).reshape(n, 4)
        offset = (np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1)) if offset is None
                  else np.asarray(offset, np.float32).reshape(n, 4))
        cweight = (np.ones(n, np.float32) if cweight is None
                   else np.asarray(cweight, np.float32))
        cap = capacity or n
        ident = np.tile(np.asarray([0, 0, 0, 1], np.float32), (cap, 1))

        def quats(x):  # padded with the identity rotation
            out = ident.copy()
            out[:n] = x
            return torch.as_tensor(out, device=device)

        return cls(parent=torch.as_tensor(pad_rows(parent, cap), device=device),
                   offset=quats(offset), target=quats(target),
                   cweight=torch.as_tensor(pad_rows(cweight, cap), device=device),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())


@dataclasses.dataclass(frozen=True, eq=False)
class ModelParametersErrorFunction(ErrorFunction):
    """L2 pull of the model parameters toward a target pose: error =
    weight·Σ_p pweight_p·(θ_p − target_p)², one row per parameter, no robust
    loss (as the reference). target and pweight may carry a leading frame
    axis (a stacked per-frame module)."""

    target: torch.Tensor  # (..., P)
    pweight: torch.Tensor  # (..., P) per-parameter weights (0 disables)
    weight: torch.Tensor

    has_analytic_jacobian = True

    def raw(self, character, ctx: EvalContext):
        return (ctx.model_params - self.target)[..., None], self.pweight

    def num_rows(self) -> int:
        return self.target.shape[-1]

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows and their model-space Jacobian diag(scale); no joint-space block."""
        scale = torch.sqrt(torch.clamp(self.weight * self.pweight, min=0.0))
        rows = scale * (ctx.model_params - self.target)
        return rows, None, torch.diag_embed(scale.expand(rows.shape))

    @classmethod
    def create(cls, target, pweight=None, weight=1.0, device="cuda"):
        device = resolve(device, "ModelParametersErrorFunction.create")
        target = np.asarray(target, np.float32)
        pweight = np.ones_like(target) if pweight is None else np.asarray(pweight, np.float32)
        return cls(target=torch.as_tensor(target, device=device),
                   pweight=torch.as_tensor(pweight, device=device),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device))
