"""transform_pose: model parameters rigidly retargeted by a world
transform, after momentum_tpu/character/transform_pose.py.

Reference: character_solver/transform_pose.h:19-37: given model parameters
and a rigid transform, new parameters whose FK equals the transformed pose.
The change is in closed form: only the root joints' local transforms change
(their globals become xform · old global), their joint parameters come by
inverse FK, and the joint-parameter change maps to model parameters through
the parameter transform's pseudo-inverse (inverse_parameter_transform.h).

Euler continuity picks, of new + 2πk, the angle nearest the old one, on
each root joint's three rotation entries only (ROADMAP F25: momentum_tpu
takes that step on all seven of a root's entries, so a root translation
that moves by more than π comes back off by a multiple of 2π).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.inverse_fk import joint_parameters_from_skeleton_states
from momentum_tpu_torch.character.skeleton import INVALID_INDEX, PARAMS_PER_JOINT
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["transform_pose"]

_ROTATION = slice(3, 6)  # rx, ry, rz within a joint's seven parameters


def _euler_continuity(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """new + 2πk nearest old, per entry."""
    two_pi = 2.0 * math.pi
    return new + torch.round((old - new) / two_pi) * two_pi


def transform_pose(character, model_params: torch.Tensor, xform: torch.Tensor) -> torch.Tensor:
    """(..., P) model parameters and an (8,) skel_state transform → (..., P)
    parameters of the pose rigidly transformed (FK on K1 for CUDA tensors)."""
    skel = character.skeleton
    jp = character.limits.apply_passive(character.parameter_transform.apply(model_params))
    nj = skel.num_joints
    states = fk.global_skel_states(skel, jp)
    roots = np.nonzero(skel.parents_np == INVALID_INDEX)[0]
    root_index = torch.as_tensor(roots, dtype=torch.int64, device=states.device)
    moved = ss.multiply(xform, states.index_select(-2, root_index))
    new_states = states.index_copy(-2, root_index, moved)
    jp_new = joint_parameters_from_skeleton_states(skel, new_states)
    mask = np.zeros((nj, PARAMS_PER_JOINT), bool)
    mask[roots] = True
    rotation = np.zeros((nj, PARAMS_PER_JOINT), bool)
    rotation[roots, _ROTATION] = True
    mask_t = torch.as_tensor(mask.reshape(-1), device=jp.device)
    rot_t = torch.as_tensor(rotation.reshape(-1), device=jp.device)
    # only the roots' entries change; the others stay bit-exact
    jp_new = torch.where(rot_t, _euler_continuity(jp_new, jp), jp_new)
    jp_new = torch.where(mask_t, jp_new, jp)
    return model_params + (jp_new - jp) @ character.parameter_transform.pinv().T
