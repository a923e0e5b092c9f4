"""Linear blend skinning (LBS) and skin weights.

Semantics of momentum_tpu/character/skinning.py (skin_weights.h,
linear_skinning.cpp applySSD): each vertex's skinning transform is
Σ_k w_k · (JointWorld_k · InverseBindPose_k) over at most 8 influences,
applied to the rest-pose vertices. Plain torch: an index gather of the joint
matrices and two einsums; no kernel. Also the flattened-COO form for
heterogeneous topologies, the inverse map from posed to rest points, and the
dense weight-matrix conversions.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.math import skel_state as ss

__all__ = ["SkinWeights", "MAX_SKIN_JOINTS", "skinning_matrices", "apply_ssd",
           "skin_points", "update_normals", "skin_points_coo", "blended_vertex_matrices",
           "apply_inverse_ssd", "unskin_points"]

MAX_SKIN_JOINTS = 8  # reference kMaxSkinJoints (skin_weights.h:19)


@dataclasses.dataclass(frozen=True, eq=False)
class SkinWeights:
    """(V, 8) int32 joint indices + (V, 8) weights, zero-padded."""

    index: torch.Tensor
    weight: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.index.shape[0]

    def to_dense(self, num_joints: int) -> torch.Tensor:
        """(V, num_joints) dense weight matrix (pybind to_dense)."""
        if num_joints <= 0:
            raise ValueError(f"num_joints must be positive, got {num_joints}")
        idx = self.index.long()
        used = idx[self.weight > 0]
        if used.numel() and int(used.max()) >= num_joints:
            raise ValueError("num_joints smaller than referenced joint index")
        v, k = idx.shape
        out = torch.zeros(v, num_joints, dtype=torch.float32, device=idx.device)
        rows = torch.arange(v, device=idx.device).repeat_interleave(k)
        out.index_put_((rows, idx.reshape(-1)), self.weight.reshape(-1).float(),
                       accumulate=True)
        return out

    @classmethod
    def from_dense(cls, dense_weights, weight_threshold: float = 1e-6,
                   max_influences: int = MAX_SKIN_JOINTS) -> "SkinWeights":
        """Each vertex's top `max_influences` weights at or above the
        threshold, renormalized, sorted descending, padded to
        `max_influences` columns (pybind from_dense). The result lies where
        `dense_weights` does."""
        if weight_threshold < 0:
            raise ValueError("weight_threshold must be non-negative")
        d = torch.as_tensor(dense_weights, dtype=torch.float32)
        if d.ndim != 2:
            raise ValueError(f"dense weights must be 2-D, got {d.ndim}-D")
        d = torch.where(d >= weight_threshold, d, 0.0)
        order = torch.argsort(-d, dim=1, stable=True)[:, :max_influences]
        w = torch.gather(d, 1, order)
        idx = torch.where(w > 0, order, 0).to(torch.int32)
        total = w.sum(dim=1, keepdim=True)
        w = torch.where(total > 0, w / torch.where(total == 0, 1.0, total), 0.0)
        if w.shape[1] < max_influences:  # pad to the kMaxSkinJoints width
            pad = (0, max_influences - w.shape[1])
            w = torch.nn.functional.pad(w, pad)
            idx = torch.nn.functional.pad(idx, pad)
        return cls(index=idx, weight=w)

    def normalize_weights(self) -> "SkinWeights":
        """Each vertex's weights rescaled to sum to 1 (pybind
        normalize_weights); all-zero rows stay zero."""
        total = self.weight.sum(dim=1, keepdim=True)
        w = torch.where(total > 0, self.weight / torch.where(total == 0, 1.0, total),
                        self.weight)
        return dataclasses.replace(self, weight=w)


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
    blended = blended_vertex_matrices(skin, matrices)
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


def skin_points_coo(rest_points: torch.Tensor, global_states: torch.Tensor,
                    inverse_bind_pose: torch.Tensor, skin_indices: torch.Tensor,
                    skin_weights: torch.Tensor, vert_indices: torch.Tensor) -> torch.Tensor:
    """Linear blend skinning with influences as three flat arrays of length
    N (pymomentum trs_backend.py multi_topology_skinning): vertex
    `vert_indices[n]` receives `skin_weights[n] · M[skin_indices[n]] · rest`.
    With a batch dimension, `skin_indices` flattens batch·joint (b·nJ + j)
    and `vert_indices` batch·vertex, so that one call skins a batch of
    characters of different topologies.

    rest_points (V, 3) or (B, V, 3); global_states (nJ, 8) or (B, nJ, 8);
    inverse_bind_pose (nJ, 8). Returns (V, 3) / (B, V, 3). JAX's
    segment_sum is `index_add_`, which sums with atomics on CUDA (the last
    bits vary from run to run there)."""
    mats = skinning_matrices(global_states, inverse_bind_pose)  # (..., nJ, 3, 4)
    batched = global_states.ndim == 3
    if batched:
        b, nj = mats.shape[0], mats.shape[1]
        v = rest_points.shape[-2]
        rest_flat = torch.broadcast_to(rest_points, (b, v, 3)).reshape(b * v, 3)
        mats_flat = mats.reshape(b * nj, 3, 4)
    else:
        rest_flat, mats_flat = rest_points, mats
    m = mats_flat.index_select(0, skin_indices.long())  # (N, 3, 4)
    p = rest_flat.index_select(0, vert_indices.long())  # (N, 3)
    contrib = (torch.einsum("nij,nj->ni", m[..., :3], p) + m[..., 3]) * skin_weights[:, None]
    out = torch.zeros(rest_flat.shape, dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, vert_indices.long(), contrib)
    return out.reshape(b, v, 3) if batched else out


def blended_vertex_matrices(skin: SkinWeights, matrices: torch.Tensor) -> torch.Tensor:
    """Per-vertex blended skinning matrices (..., V, 3, 4)."""
    v, k = skin.index.shape
    gathered = matrices.index_select(-3, skin.index.reshape(-1).long())
    gathered = gathered.reshape(matrices.shape[:-3] + (v, k, 3, 4))
    return torch.einsum("...vk,...vkij->...vij", skin.weight, gathered)


def apply_inverse_ssd(skin: SkinWeights, matrices: torch.Tensor,
                      posed_points: torch.Tensor) -> torch.Tensor:
    """Posed points back to rest space through the inverse of each vertex's
    blended skinning matrix (linear_skinning.h:200-240 applyInverseSSD):
    rest = B⁻¹·(p − t), B the blended 3 × 3 block and t its translation
    column, by a batched LU solve."""
    blended = blended_vertex_matrices(skin, matrices)  # (..., V, 3, 4)
    rhs = posed_points - blended[..., 3]
    return torch.linalg.solve(blended[..., :3], rhs[..., None])[..., 0]


def unskin_points(skin: SkinWeights, global_states: torch.Tensor,
                  inverse_bind_pose: torch.Tensor, posed_points: torch.Tensor) -> torch.Tensor:
    """The inverse of skin_points: posed world points → rest points."""
    return apply_inverse_ssd(skin, skinning_matrices(global_states, inverse_bind_pose),
                             posed_points)
