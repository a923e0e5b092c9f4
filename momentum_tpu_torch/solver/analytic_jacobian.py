"""Analytic model-space Jacobians of rigidly attached points
(skeleton_derivative.{h,cpp}:24-445), after momentum_tpu/solver/
analytic_jacobian.py. Per constraint point p attached below joint j:

    translation DOF :  d = translationAxis.col(i)
    rotation DOF    :  d = rotationAxis.col(i) × (p − jointPos)
    scale           :  d = (p − jointPos) · ln2

The chain walk is a dense product with the static ancestor-or-self mask. The
fused forms fold the parameter-transform chain rule into per-joint factors
before that product, so no joint-space Jacobian is materialized; the
joint-space forms (point_jacobian, vector_jacobian and the skinned-vertex
walks built on them) return (..., C, 3, nJ·7) blocks that the solver
function multiplies by the parameter transform.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = ["JacobianContext", "make_jacobian_context", "fused_point_jacobian_model",
           "fused_point_jacobian_model_merged", "fused_rotation_factor",
           "fused_vector_jacobian_model", "point_jacobian", "vector_jacobian",
           "skinned_point_jacobian", "skinned_vector_jacobian", "skinned_blend_jacobian"]

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


def fused_point_jacobian_model(jc: JacobianContext, points: torch.Tensor,
                               parents: torch.Tensor, pt_mat: torch.Tensor,
                               scale=None) -> torch.Tensor:
    """d(world point)/d(MODEL parameters), (..., C, 3, P), the unmerged
    form: the chain rule J_jp · PT reassociated so that every contraction
    over joints is a mask product on small precontracted factors, the
    translation, scale and rotation terms each on their own,

        translation  mask @ (transAxis·PT_t)
        scale        ln2·(p_c ⊗ mask @ PT_s − mask @ (t_j ⊗ PT_s))
        rotation     (mask @ (rotAxis·PT_r)) × p_c − mask @ ((rotAxis·PT_r) × t_j)

    the diff = p_c − t_j of the joint-space form split so nothing of size
    (..., C, nJ, ...) is formed. The merged form's parity oracle."""
    nj = jc.anc_mask.shape[0]
    ptj = pt_mat.reshape(nj, 7, pt_mat.shape[1])
    mask = jc.anc_mask.index_select(1, parents).T  # (C, nJ)
    if scale is not None:
        mask = mask * scale[..., :, None]
    a_t = torch.einsum("...nij,njp->...nip", jc.trans_axis, ptj[:, :3])
    term_t = torch.einsum("...cn,...nip->...cip", mask, a_t)
    pt6 = ptj[:, 6]
    m_pt6 = mask @ pt6  # (..., C, P)
    w_s = torch.einsum("...nv,np->...nvp", jc.joint_pos, pt6)
    term_s = _LN2 * (points[..., :, :, None] * m_pt6[..., :, None, :]
                     - torch.einsum("...cn,...nvp->...cvp", mask, w_s))
    d_r = torch.einsum("...nwk,nkp->...nwp", jc.rot_axis, ptj[:, 3:6])
    h1 = torch.einsum("...cn,...nwp->...cwp", mask, d_r)
    h2 = torch.einsum("...cn,...nvp->...cvp", mask, _cross2(d_r, jc.joint_pos[..., :, :, None]))
    return term_t + term_s + _cross2(h1, points[..., :, :, None]) - h2


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


def _cross1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along the last axis, broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def point_jacobian(jc: JacobianContext, points: torch.Tensor,
                   parents: torch.Tensor) -> torch.Tensor:
    """d(world point)/d(joint parameters), (..., C, 3, nJ·7): points
    (..., C, 3) rigidly attached to `parents` (C,)."""
    mask = jc.anc_mask.index_select(1, parents).T  # (C, nJ)
    diff = points[..., :, None, :] - jc.joint_pos[..., None, :, :]  # (..., C, nJ, 3)
    jt = jc.trans_axis[..., None, :, :, :].expand(diff.shape + (3,))  # (..., C, nJ, 3, 3)
    axes = jc.rot_axis.transpose(-1, -2)  # (..., nJ, 3dof, 3)
    jr = _cross1(axes[..., None, :, :, :], diff[..., :, :, None, :]).transpose(-1, -2)
    js = (diff * _LN2)[..., None]  # (..., C, nJ, 3, 1)
    j = torch.cat([jt, jr, js], dim=-1) * mask[:, :, None, None]  # (..., C, nJ, 3, 7)
    j = j.transpose(-3, -2)  # (..., C, 3, nJ, 7)
    return j.reshape(j.shape[:-2] + (-1,))


def vector_jacobian(jc: JacobianContext, vectors: torch.Tensor,
                    parents: torch.Tensor) -> torch.Tensor:
    """d(world direction)/d(joint parameters), (..., C, 3, nJ·7): only the
    rotation DOFs contribute. vectors (..., C, 3) in world space."""
    mask = jc.anc_mask.index_select(1, parents).T
    axes = jc.rot_axis.transpose(-1, -2)  # (..., nJ, 3dof, 3)
    jr = _cross1(axes[..., None, :, :, :], vectors[..., :, None, None, :]).transpose(-1, -2)
    zeros3 = jr.new_zeros(jr.shape[:-1] + (3,))
    zeros1 = jr.new_zeros(jr.shape[:-1] + (1,))
    j = torch.cat([zeros3, jr, zeros1], dim=-1) * mask[:, :, None, None]
    j = j.transpose(-3, -2)
    return j.reshape(j.shape[:-2] + (-1,))


def _influences(character, vertex_index: torch.Tensor):
    """(character with its inverse bind pose, influence joints (C, K),
    weights (C, K)) of the constrained vertices."""
    char = character.with_inverse_bind_pose()
    skin = char.skin_weights
    return (char, skin.index.index_select(0, vertex_index),
            skin.weight.index_select(0, vertex_index))


def _influence_transform(char, ctx, joints: torch.Tensor) -> torch.Tensor:
    """(..., C, 8) skinning transforms world · inverseBindPose of one slot."""
    return ss.multiply(ctx.skel_states.index_select(-2, joints),
                       char.inverse_bind_pose.index_select(0, joints))


def skinned_point_jacobian(jc: JacobianContext, character, ctx,
                           vertex_index: torch.Tensor) -> torch.Tensor:
    """d(posed LBS vertex)/d(joint parameters), (..., C, 3, nJ·7): the posed
    vertex is Σ_k w_k·M_k(θ)·x_rest, so its Jacobian is the weighted sum of
    the rigid point Jacobians of each influence's own transformed point
    M_k·x (skeleton_derivative.cpp vertex paths). Every one of the K
    influence slots is walked, as in JAX, whatever its weight."""
    char, idx, w = _influences(character, vertex_index)
    rest = ctx.rest_vertices.index_select(-2, vertex_index)  # (..., C, 3)
    j = None
    for k in range(idx.shape[1]):
        pk = idx[:, k]
        ptk = ss.transform_points(_influence_transform(char, ctx, pk), rest)
        contrib = w[:, k][..., None, None] * point_jacobian(jc, ptk, pk)
        j = contrib if j is None else j + contrib
    return j


def skinned_vector_jacobian(jc: JacobianContext, character, ctx, vertex_index: torch.Tensor,
                            vectors: torch.Tensor) -> torch.Tensor:
    """d(posed vertex direction)/d(joint parameters), (..., C, 3, nJ·7),
    with the direction rotating rigidly with the blend of its skinning
    frames: each influence contributes w_k·(rotAxis × v) over its own
    ancestor chain (the normal-rotation correction of
    skeleton_derivative.h:233-235). vectors (..., C, 3) posed directions."""
    _, idx, w = _influences(character, vertex_index)
    j = None
    for k in range(idx.shape[1]):
        contrib = w[:, k][..., None, None] * vector_jacobian(jc, vectors, idx[:, k])
        j = contrib if j is None else j + contrib
    return j


def skinned_blend_jacobian(character, ctx, vertex_index: torch.Tensor, basis=None):
    """d(posed vertex)/d(shape coefficients), (..., C, 3, nB): the skinning
    linear map applied to each basis delta. `basis` defaults to the body
    blend shape; None when the rig has none."""
    if basis is None:
        basis = character.blend_shape
        if basis is None or not character.blend_shape_param_index:
            return None
    char, idx, w = _influences(character, vertex_index)
    deltas = basis.shape_vectors.index_select(1, vertex_index)  # (nB, C, 3)
    out = None
    for k in range(idx.shape[1]):
        _, q, s = ss.split(_influence_transform(char, ctx, idx[:, k]))
        rot = quat.to_rotation_matrix(q) * s[..., None]  # (..., C, 3, 3)
        term = w[:, k][..., None, None] * torch.einsum("...cij,bcj->...cib", rot, deltas)
        out = term if out is None else out + term
    return out
