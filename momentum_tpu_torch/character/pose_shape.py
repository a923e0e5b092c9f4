"""PoseShape: pose-dependent corrective deformation driven by joint
rotations, after momentum_tpu/character/pose_shape.py (pose_shape.{h,cpp}:
15-45). The coefficients are the quaternion components of each driving
joint's rotation relative to a base joint:

    base = baseRot · R(baseJoint)⁻¹
    coeffs = concat_i (base · R(jointMap[i])).coeffs()   (x, y, z, w each)
    shape = baseShape + shapeVectors · coeffs
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.math import quaternion as quat

__all__ = ["PoseShape"]


@dataclasses.dataclass(frozen=True, eq=False)
class PoseShape:
    base_rot: torch.Tensor  # (4,) quaternion
    base_shape: torch.Tensor  # (V, 3)
    shape_vectors: torch.Tensor  # (V, 3, nDrivers*4)
    base_joint: int = 0
    joint_map: tuple = ()

    def compute(self, skel_states: torch.Tensor) -> torch.Tensor:
        """(..., nJ, 8) global states → (..., V, 3) deformed vertices."""
        q_all = skel_states[..., 3:7]
        base = quat.multiply(self.base_rot, quat.conjugate(q_all[..., self.base_joint, :]))
        drivers = q_all[..., list(self.joint_map), :]  # (..., D, 4)
        rel = quat.multiply(base[..., None, :], drivers)
        coeffs = rel.reshape(rel.shape[:-2] + (-1,))  # (..., D*4)
        return self.base_shape + torch.einsum("vik,...k->...vi", self.shape_vectors, coeffs)
