"""Inverse forward kinematics: skeleton states → joint parameters, after
momentum_tpu/character/inverse_fk.py.

Reference: momentum/character/skeleton_state.h:499-566
(`skeletonStateToJointParameters`): per joint, the global transform in the
parent's frame, and the local composition inverted:

    local.t = offset + (tx, ty, tz)        t_params = local.t − offset
    local.R = Rpre · Rz(rz)·Ry(ry)·Rx(rx)  (rz, ry, rx) = euler_zyx(Rpre⁻¹ · local.R)
    local.s = exp2(scale)                  scale = log2(local.s)

At ry = ±π/2 the decomposition is not unique, and the gimbal branch pins
rz = 0 (skeleton_state.h:509-511).
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.character.fk import parent_global_states
from momentum_tpu_torch.character.skeleton import Skeleton
from momentum_tpu_torch.math import euler, quaternion as quat, skel_state as ss

__all__ = ["joint_parameters_from_skeleton_states", "joint_parameters_from_local_skel_states",
           "local_from_global"]


def local_from_global(skeleton: Skeleton, global_states: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) global → (..., nJ, 8) local states."""
    return ss.multiply(ss.inverse(parent_global_states(skeleton, global_states)),
                       global_states)


def joint_parameters_from_skeleton_states(skeleton: Skeleton,
                                          global_states: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) global states → (..., nJ*7) joint parameters."""
    return joint_parameters_from_local_skel_states(
        skeleton, local_from_global(skeleton, global_states))


def joint_parameters_from_local_skel_states(skeleton: Skeleton,
                                            local: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) joint-local states → (..., nJ*7) joint parameters (the
    ZYX Euler extraction against the pre-rotation)."""
    t, q, s = ss.split(local)
    q_euler = quat.multiply(quat.conjugate(skeleton.pre_rotation), q)
    zyx = euler.rotation_matrix_to_euler_zyx(quat.to_rotation_matrix(q_euler))
    scale = torch.log2(torch.clamp(s, min=1e-20))
    jp = torch.cat([t - skeleton.translation_offset, zyx.flip(-1), scale], dim=-1)
    return jp.reshape(jp.shape[:-2] + (-1,))
