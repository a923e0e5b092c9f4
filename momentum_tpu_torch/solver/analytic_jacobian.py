"""Analytic model-space Jacobians of rigidly attached points
(skeleton_derivative.{h,cpp}:24-445), after momentum_tpu/solver/
analytic_jacobian.py. Per constraint point p attached below joint j:

    translation DOF :  d = translationAxis.col(i)
    rotation DOF    :  d = rotationAxis.col(i) × (p − jointPos)
    scale           :  d = (p − jointPos) · ln2

The chain walk is a dense product with the static ancestor-or-self mask, and
the parameter-transform chain rule is folded into per-joint factors before
that product, so no joint-space Jacobian is materialized.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.character import fk

__all__ = ["JacobianContext", "make_jacobian_context",
           "fused_point_jacobian_model_merged", "fused_rotation_factor",
           "fused_vector_jacobian_model"]

_LN2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True, eq=False)
class JacobianContext:
    """Per-evaluation derivative state: joint axes + static ancestor mask."""

    anc_mask: torch.Tensor  # (nJ, nJ) float 0/1, [a, j] = a ancestor-or-self of j
    joint_pos: torch.Tensor  # (..., nJ, 3)
    trans_axis: torch.Tensor  # (..., nJ, 3, 3) columns = axes
    rot_axis: torch.Tensor  # (..., nJ, 3, 3)


def make_jacobian_context(character, ctx) -> JacobianContext:
    trans_axis, rot_axis = fk.joint_axes(character.skeleton, ctx.joint_params,
                                         ctx.skel_states)
    return JacobianContext(character.skeleton.ancestor_mask,
                           ctx.skel_states[..., :3], trans_axis, rot_axis)


def _cross2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along axis -2 (the 3-vector axis of (..., 3, P) factors)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-2)


def fused_point_jacobian_model_merged(jc: JacobianContext, points: torch.Tensor,
                                      parents: torch.Tensor, pt_mat: torch.Tensor,
                                      scale=None) -> torch.Tensor:
    """d(world point)/d(MODEL parameters), (..., C, 3, P), with the
    translation / scale-position / rotation-position factors merged by
    linearity into one per-joint factor before the mask contraction:

        J = m@(a_t − ln2·w_s − q) + (m@d_r) × p_c + ln2·p_c ⊗ m@pt6

    points (..., C, 3) attached to `parents` (C,); pt_mat (nJ*7, P);
    optional row scale (..., C) folded into the mask."""
    nj = jc.anc_mask.shape[0]
    ptj = pt_mat.reshape(nj, 7, pt_mat.shape[1])
    mask = jc.anc_mask.index_select(1, parents).T  # (C, nJ)
    if scale is not None:
        mask = mask * scale[..., :, None]
    pt6 = ptj[:, 6]
    m_pt6 = mask @ pt6  # (..., C, P)

    a_t = torch.einsum("...nij,njp->...nip", jc.trans_axis, ptj[:, :3])
    w_s = torch.einsum("...nv,np->...nvp", jc.joint_pos, pt6)
    d_r = torch.einsum("...nwk,nkp->...nwp", jc.rot_axis, ptj[:, 3:6])
    q = _cross2(d_r, jc.joint_pos[..., :, :, None])
    g1 = a_t - _LN2 * w_s - q
    t1 = torch.einsum("...cn,...nvp->...cvp", mask, g1)
    h1 = torch.einsum("...cn,...nwp->...cwp", mask, d_r)
    term_r = _cross2(h1, points[..., :, :, None])
    return t1 + term_r + _LN2 * points[..., :, :, None] * m_pt6[..., :, None, :]


def fused_rotation_factor(jc: JacobianContext, parents: torch.Tensor,
                          pt_mat: torch.Tensor, scale=None) -> torch.Tensor:
    """h1 = Σ_j mask·(rotAxis_j·PT_rot), (..., C, 3, P): every world
    direction's model-space derivative is h1 × v. Optional row scale
    (..., C) folded into the mask."""
    nj = jc.anc_mask.shape[0]
    ptj = pt_mat.reshape(nj, 7, pt_mat.shape[1])
    mask = jc.anc_mask.index_select(1, parents).T  # (C, nJ)
    if scale is not None:
        mask = mask * scale[..., :, None]
    d_r = torch.einsum("...nwk,nkp->...nwp", jc.rot_axis, ptj[:, 3:6])
    return torch.einsum("...cn,...nwp->...cwp", mask, d_r)


def fused_vector_jacobian_model(jc: JacobianContext, vectors: torch.Tensor,
                                parents: torch.Tensor, pt_mat: torch.Tensor,
                                scale=None) -> torch.Tensor:
    """d(world direction)/d(MODEL parameters), (..., C, 3, P): only rotation
    DOFs contribute, and axis_j × v reassociates to h1 × v with h1 the
    fused rotation factor. vectors (..., C, 3)."""
    h1 = fused_rotation_factor(jc, parents, pt_mat, scale=scale)
    return _cross2(h1, vectors[..., :, :, None])
