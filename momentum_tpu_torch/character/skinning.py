"""Linear blend skinning (LBS) and skin weights.

Semantics of momentum_tpu/character/skinning.py (skin_weights.h,
linear_skinning.cpp applySSD): each vertex's skinning transform is
Σ_k w_k · (JointWorld_k · InverseBindPose_k) over at most 8 influences,
applied to the rest-pose vertices. Plain torch: an index gather of the joint
matrices and two einsums; no kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.math import skel_state as ss

__all__ = ["SkinWeights", "MAX_SKIN_JOINTS", "skinning_matrices", "apply_ssd",
           "skin_points", "update_normals"]

MAX_SKIN_JOINTS = 8  # reference kMaxSkinJoints (skin_weights.h:19)


@dataclasses.dataclass(frozen=True, eq=False)
class SkinWeights:
    """(V, 8) int32 joint indices + (V, 8) weights, zero-padded."""

    index: torch.Tensor
    weight: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.index.shape[0]


def skinning_matrices(global_states: torch.Tensor,
                      inverse_bind_pose: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 3, 4) per-joint skinning matrices: world · inverseBindPose
    (`inverse_bind_pose` as (nJ, 8) skel_states)."""
    return ss.to_matrix(ss.multiply(global_states, inverse_bind_pose))[..., :3, :4]


def apply_ssd(skin: SkinWeights, matrices: torch.Tensor,
              rest_points: torch.Tensor) -> torch.Tensor:
    """Blend the skinning matrices per vertex and transform the rest points:
    matrices (..., nJ, 3, 4), rest_points (V, 3) or (..., V, 3) →
    (..., V, 3)."""
    v, k = skin.index.shape
    gathered = matrices.index_select(-3, skin.index.reshape(-1).long())
    gathered = gathered.reshape(matrices.shape[:-3] + (v, k, 3, 4))
    blended = torch.einsum("...vk,...vkij->...vij", skin.weight, gathered)
    return (torch.einsum("...vij,...vj->...vi", blended[..., :3], rest_points)
            + blended[..., 3])


def skin_points(skin: SkinWeights, global_states: torch.Tensor,
                inverse_bind_pose: torch.Tensor, rest_points: torch.Tensor) -> torch.Tensor:
    """applySSD(inverseBindPose, state, points) (linear_skinning.h:40-50)."""
    return apply_ssd(skin, skinning_matrices(global_states, inverse_bind_pose),
                     rest_points)


def update_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: vertices (..., V, 3), faces (F, 3).
    JAX's scatter-add is `index_add_`, which sums with atomics on CUDA, so
    the order of the sum (and the last bits) varies from run to run there."""
    idx = [faces[:, k].long() for k in range(3)]
    v0, v1, v2 = (vertices.index_select(-2, i) for i in idx)
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    out = torch.zeros_like(vertices)
    for i in idx:
        out.index_add_(-2, i, fn)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
