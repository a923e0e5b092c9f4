"""LimitErrorFunction: penalties for parameter-limit violations, after
momentum_tpu/errors/limit.py (limit_error_function.cpp). Per record the
raw residual r is zero inside the feasible region and linear outside; the
energy is kLimitWeight (= 10, limit_error_function.h:91) · weight · Σ w_rec ·
ρ(‖r‖²), ellipsoid records scaled by kPositionWeight (= 1e-4,
limit_error_function.cpp:21) too:

    MinMax        r = clip(θ_i, lo, hi) − θ_i               (model parameter)
    MinMaxJoint   the same over joint parameters
    Linear        r = θ_tgt·scale − offset − θ_ref   while θ_tgt ∈ [rmin, rmax)
    LinearJoint   the same over joint parameters
    HalfPlane     r = min((θ_1, θ_2)·n − o, 0)
    Ellipsoid     r⃗ = worldPoint − its projection onto the ellipsoid surface (3 rows)

Passive MinMaxJoint records contribute nothing here: they are pre-FK clamps
(ParameterLimits.apply_passive). Every record type has its analytic
Jacobian; the ellipsoid rows hold the surface projection fixed (the
reference's frozen-projection linearization, first-order exact when the
residual is normal to the surface). The model-parameter record types also
add their JᵀJ and Jᵀr straight into the normal equations.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import ErrorFunction, EvalContext
from momentum_tpu_torch.errors.geometric import clamped
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["LimitErrorFunction", "K_LIMIT_WEIGHT"]

K_LIMIT_WEIGHT = 10.0  # limit_error_function.h:91
_K_POSITION_WEIGHT = 1e-4  # limit_error_function.cpp:21 (ellipsoid records)


def _minmax_residual(vals, bounds):
    return torch.minimum(torch.maximum(vals, bounds[..., 0]), bounds[..., 1]) - vals


def _in_range(tgt, rng):
    return (tgt >= rng[..., 0]) & (tgt < rng[..., 1])


def _linear_residual(ref, tgt, scale, offset, rng):
    return torch.where(_in_range(tgt, rng), tgt * scale - offset - ref, 0.0)


def _one_hot(index, n, dtype):
    """(M, n) rows with a 1 in column index[m]."""
    return torch.nn.functional.one_hot(index.long(), n).to(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class LimitErrorFunction(ErrorFunction):
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    has_analytic_jacobian = True
    has_normal_contrib = True

    def _ellipsoid(self, lim, ctx: EvalContext):
        """(clamped parent, clamped frame parent, the world point (..., E, 3),
        its projection onto the ellipsoid surface in world space)
        (limit_error_function.cpp:173-193)."""
        parent = clamped(lim.ellipsoid_parent, ctx)
        frame = clamped(lim.ellipsoid_frame_parent, ctx)
        epar = ctx.skel_states.index_select(-2, frame)
        pos = ss.transform_points(ctx.skel_states.index_select(-2, parent),
                                  lim.ellipsoid_point_offset)
        local = ss.transform_points(ss.inverse(epar), pos)
        inv, mat = lim.ellipsoid_inv, lim.ellipsoid_mat
        ep = torch.einsum("...ij,...j->...i", inv[..., :3, :3], local) + inv[..., :3, 3]
        nrm = ep / torch.clamp(torch.linalg.vector_norm(ep, dim=-1, keepdim=True), min=1e-12)
        proj = torch.einsum("...ij,...j->...i", mat[..., :3, :3], nrm) + mat[..., :3, 3]
        return parent, frame, pos, ss.transform_points(epar, proj)

    def _pieces(self, character, ctx: EvalContext):
        """-> list of (f (..., M, D), w (M,)) per record type, in a fixed order."""
        lim = character.limits
        mp, jp = ctx.model_params, ctx.joint_params
        out = []
        if lim.minmax_index.shape[0]:
            vals = mp.index_select(-1, lim.minmax_index)
            out.append((_minmax_residual(vals, lim.minmax_bounds)[..., None],
                        lim.minmax_weight))
        if lim.minmax_joint_index.shape[0]:
            vals = jp.index_select(-1, lim.minmax_joint_index)
            out.append((_minmax_residual(vals, lim.minmax_joint_bounds)[..., None],
                        lim.minmax_joint_weight * (1.0 - lim.minmax_joint_passive)))
        if lim.linear_ref.shape[0]:
            r = _linear_residual(mp.index_select(-1, lim.linear_ref),
                                 mp.index_select(-1, lim.linear_tgt), lim.linear_scale,
                                 lim.linear_offset, lim.linear_range)
            out.append((r[..., None], lim.linear_weight))
        if lim.linear_joint_ref.shape[0]:
            r = _linear_residual(jp.index_select(-1, lim.linear_joint_ref),
                                 jp.index_select(-1, lim.linear_joint_tgt),
                                 lim.linear_joint_scale, lim.linear_joint_offset,
                                 lim.linear_joint_range)
            out.append((r[..., None], lim.linear_joint_weight))
        if lim.halfplane_idx1.shape[0]:
            d = (mp.index_select(-1, lim.halfplane_idx1) * lim.halfplane_normal[..., 0]
                 + mp.index_select(-1, lim.halfplane_idx2) * lim.halfplane_normal[..., 1]
                 - lim.halfplane_offset)
            out.append((torch.clamp(d, max=0.0)[..., None], lim.halfplane_weight))
        if lim.ellipsoid_parent.shape[0]:
            _, _, pos, proj_world = self._ellipsoid(lim, ctx)
            out.append((pos - proj_world, lim.ellipsoid_weight * _K_POSITION_WEIGHT))
        return out

    def _scale(self, w, sq):
        """sqrt(kLimitWeight · weight · w · ρ'(‖r‖²)), the robust factor frozen."""
        s = torch.sqrt(torch.clamp(K_LIMIT_WEIGHT * self.weight * w, min=0.0))
        if self.loss.alpha == 2.0:
            return s * (1.0 / self.loss.c)
        return s * torch.sqrt(torch.clamp(self.loss.deriv(sq), min=0.0)).detach()

    def raw(self, character, ctx: EvalContext):
        raise NotImplementedError("LimitErrorFunction evaluates per record type")

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        total = ctx.model_params.new_zeros(ctx.model_params.shape[:-1])
        for f, w in self._pieces(character, ctx):
            total = total + torch.sum(w * self.loss.value(torch.sum(f * f, dim=-1)), dim=-1)
        return K_LIMIT_WEIGHT * self.weight * total

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        rows = [(self._scale(w, torch.sum(f * f, dim=-1))[..., None] * f).flatten(-2)
                for f, w in self._pieces(character, ctx)]
        if not rows:
            return ctx.model_params.new_zeros(ctx.model_params.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    def jacobian(self, character, ctx: EvalContext, jc):
        """(rows, joint-space J, model-space J) of every record type
        (limit_error_function.cpp's gradient paths): each row's Jacobian
        lies in the model-space block (MinMax, Linear, HalfPlane) or in the
        joint-space one (MinMaxJoint, LinearJoint, Ellipsoid), the other
        block zero."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        lim = character.limits
        mp, jp = ctx.model_params, ctx.joint_params
        p_dim, jp_dim, dtype = mp.shape[-1], jp.shape[-1], mp.dtype
        batch = mp.shape[:-1]
        rows_l, jjp_l, jm_l = [], [], []

        def add(r, w, j_jp=None, j_model=None):
            """Scalar rows r (..., M) with their Jacobian in one block."""
            s = self._scale(w, r * r)
            n = r.shape[-1]
            rows_l.append(s * r)
            jjp_l.append(r.new_zeros(batch + (n, jp_dim)) if j_jp is None
                         else s[..., None] * j_jp)
            jm_l.append(r.new_zeros(batch + (n, p_dim)) if j_model is None
                        else s[..., None] * j_model)

        def linear_rows(vals, ref_i, tgt_i, scale, offset, rng, n):
            ref, tgt = vals.index_select(-1, ref_i), vals.index_select(-1, tgt_i)
            in_r = _in_range(tgt, rng).to(dtype)[..., None]
            return (_linear_residual(ref, tgt, scale, offset, rng),
                    in_r * (scale[:, None] * _one_hot(tgt_i, n, dtype)
                            - _one_hot(ref_i, n, dtype)))

        if lim.minmax_index.shape[0]:
            r = _minmax_residual(mp.index_select(-1, lim.minmax_index), lim.minmax_bounds)
            add(r, lim.minmax_weight, j_model=-(r != 0).to(dtype)[..., None]
                * _one_hot(lim.minmax_index, p_dim, dtype))
        if lim.minmax_joint_index.shape[0]:
            r = _minmax_residual(jp.index_select(-1, lim.minmax_joint_index),
                                 lim.minmax_joint_bounds)
            add(r, lim.minmax_joint_weight * (1.0 - lim.minmax_joint_passive),
                j_jp=-(r != 0).to(dtype)[..., None]
                * _one_hot(lim.minmax_joint_index, jp_dim, dtype))
        if lim.linear_ref.shape[0]:
            r, j = linear_rows(mp, lim.linear_ref, lim.linear_tgt, lim.linear_scale,
                               lim.linear_offset, lim.linear_range, p_dim)
            add(r, lim.linear_weight, j_model=j)
        if lim.linear_joint_ref.shape[0]:
            r, j = linear_rows(jp, lim.linear_joint_ref, lim.linear_joint_tgt,
                               lim.linear_joint_scale, lim.linear_joint_offset,
                               lim.linear_joint_range, jp_dim)
            add(r, lim.linear_joint_weight, j_jp=j)
        if lim.halfplane_idx1.shape[0]:
            d = (mp.index_select(-1, lim.halfplane_idx1) * lim.halfplane_normal[..., 0]
                 + mp.index_select(-1, lim.halfplane_idx2) * lim.halfplane_normal[..., 1]
                 - lim.halfplane_offset)
            j = (lim.halfplane_normal[:, 0:1] * _one_hot(lim.halfplane_idx1, p_dim, dtype)
                 + lim.halfplane_normal[:, 1:2] * _one_hot(lim.halfplane_idx2, p_dim, dtype))
            add(torch.clamp(d, max=0.0), lim.halfplane_weight,
                j_model=(d < 0).to(dtype)[..., None] * j)
        if lim.ellipsoid_parent.shape[0]:
            parent, frame, pos, proj_world = self._ellipsoid(lim, ctx)
            diff = pos - proj_world
            s = self._scale(lim.ellipsoid_weight * _K_POSITION_WEIGHT,
                            torch.sum(diff * diff, dim=-1))
            jdiff = (point_jacobian(jc, pos, parent)
                     - point_jacobian(jc, proj_world.detach(), frame))  # (..., E, 3, nJ·7)
            rows_l.append((s[..., None] * diff).flatten(-2))
            jjp_l.append((s[..., None, None] * jdiff).flatten(-3, -2))
            jm_l.append(mp.new_zeros(batch + (3 * diff.shape[-2], p_dim)))

        if not rows_l:
            return (mp.new_zeros(batch + (0,)), mp.new_zeros(batch + (0, jp_dim)),
                    mp.new_zeros(batch + (0, p_dim)))
        return torch.cat(rows_l, dim=-1), torch.cat(jjp_l, dim=-2), torch.cat(jm_l, dim=-2)

    def supports_normal_contrib(self, character) -> bool:
        """The direct path covers the model-parameter record types (MinMax,
        Linear, HalfPlane: at most two nonzero Jacobian entries a row);
        joint-space and ellipsoid records need dense rows."""
        c = character.limits.counts
        return (c["minmax_joint"] + c["linear_joint"] + c["ellipsoid"]) == 0

    def accumulate_normal(self, character, ctx: EvalContext, jc, pt_mat, acc):
        """Scatter-add JᵀJ/Jᵀr directly: a model-space limit row has at most
        two nonzero entries, v1 in column i1 and v2 in column i2, so its
        rank-1 update touches at most four JᵀJ cells (limit_error_function.cpp's
        sparse rank update) instead of dense rows through the Jacobian. Adds
        into acc's tensors in place and returns acc."""
        jtj, jtr, sq = acc
        lim = character.limits
        mp = ctx.model_params
        dtype = mp.dtype
        i1_l, v1_l, i2_l, v2_l, r_l = [], [], [], [], []
        if lim.minmax_index.shape[0]:
            r = _minmax_residual(mp.index_select(-1, lim.minmax_index), lim.minmax_bounds)
            s = self._scale(lim.minmax_weight, r * r)
            i1_l.append(lim.minmax_index)
            v1_l.append(-s * (r != 0).to(dtype))
            i2_l.append(lim.minmax_index)
            v2_l.append(torch.zeros_like(r))
            r_l.append(s * r)
        if lim.linear_ref.shape[0]:
            tgt = mp.index_select(-1, lim.linear_tgt)
            r = _linear_residual(mp.index_select(-1, lim.linear_ref), tgt, lim.linear_scale,
                                 lim.linear_offset, lim.linear_range)
            in_r = _in_range(tgt, lim.linear_range).to(dtype)
            s = self._scale(lim.linear_weight, r * r)
            i1_l.append(lim.linear_tgt)
            v1_l.append(s * in_r * lim.linear_scale)
            i2_l.append(lim.linear_ref)
            v2_l.append(-s * in_r)
            r_l.append(s * r)
        if lim.halfplane_idx1.shape[0]:
            d = (mp.index_select(-1, lim.halfplane_idx1) * lim.halfplane_normal[..., 0]
                 + mp.index_select(-1, lim.halfplane_idx2) * lim.halfplane_normal[..., 1]
                 - lim.halfplane_offset)
            r = torch.clamp(d, max=0.0)
            act = (d < 0).to(dtype)
            s = self._scale(lim.halfplane_weight, r * r)
            i1_l.append(lim.halfplane_idx1)
            v1_l.append(s * act * lim.halfplane_normal[..., 0])
            i2_l.append(lim.halfplane_idx2)
            v2_l.append(s * act * lim.halfplane_normal[..., 1])
            r_l.append(s * r)
        if not r_l:
            return acc
        i1, i2 = torch.cat(i1_l).long(), torch.cat(i2_l).long()
        v1, v2, r = (torch.cat(x, dim=-1) for x in (v1_l, v2_l, r_l))
        p = jtj.shape[-1]
        cells = jtj.view(jtj.shape[:-2] + (p * p,))
        jtr.index_add_(-1, i1, v1 * r)
        jtr.index_add_(-1, i2, v2 * r)
        cells.index_add_(-1, i1 * p + i1, v1 * v1)
        cells.index_add_(-1, i2 * p + i2, v2 * v2)
        cells.index_add_(-1, i1 * p + i2, v1 * v2)
        cells.index_add_(-1, i2 * p + i1, v1 * v2)
        sq.add_(torch.sum(r * r, dim=-1))
        return acc

    def num_rows_for(self, character) -> int:
        c = character.limits.counts
        return (c["minmax"] + c["minmax_joint"] + c["linear"] + c["linear_joint"]
                + c["halfplane"] + 3 * c["ellipsoid"])

    @classmethod
    def create(cls, weight=1.0, loss=None, device="cuda"):
        device = resolve(device, "LimitErrorFunction.create")
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())
