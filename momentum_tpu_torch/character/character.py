"""Character: skeleton + parameter transform + limits + locators, and an
optional skinned mesh with its inverse bind pose (character.h:33-283). Blend
shapes come with ROADMAP M4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.limits import ParameterLimits
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import Skeleton
from momentum_tpu_torch.character.skinning import SkinWeights
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["Mesh", "Locators", "Character"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Triangle mesh (math/mesh.h): vertices (V, 3), faces (F, 3) int32."""

    vertices: torch.Tensor
    faces: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class Locators:
    """Markers attached to joints: offset in the parent-joint frame
    (character/locator.h)."""

    parent: torch.Tensor  # (L,) int32
    offset: torch.Tensor  # (L, 3)
    weight: torch.Tensor  # (L,)
    names: tuple = ()

    @property
    def num_locators(self) -> int:
        return self.parent.shape[0]

    def world_positions(self, global_states: torch.Tensor) -> torch.Tensor:
        """(..., nJ, 8) global states → (..., L, 3) locator positions
        (locator_state.h)."""
        states = global_states.index_select(-2, self.parent)
        return ss.transform_points(states, self.offset)


@dataclasses.dataclass(frozen=True, eq=False)
class Character:
    skeleton: Skeleton
    parameter_transform: ParameterTransform
    limits: ParameterLimits
    locators: Optional[Locators] = None
    name: str = ""
    mesh: Optional[Mesh] = None
    skin_weights: Optional[SkinWeights] = None
    inverse_bind_pose: Optional[torch.Tensor] = None  # (nJ, 8) skel_states

    @property
    def num_joints(self) -> int:
        return self.skeleton.num_joints

    @property
    def num_model_parameters(self) -> int:
        return self.parameter_transform.num_model_parameters

    def joint_parameters(self, model_params: torch.Tensor) -> torch.Tensor:
        return self.parameter_transform.apply(model_params)

    def skeleton_states(self, model_params: torch.Tensor,
                        method: str = "lifted") -> torch.Tensor:
        """model params (..., P) → (..., nJ, 8) global skeleton states."""
        return fk.global_skel_states(self.skeleton,
                                     self.joint_parameters(model_params), method)

    def bind_pose(self) -> torch.Tensor:
        """Global states at zero joint parameters."""
        off = self.skeleton.translation_offset
        zeros = torch.zeros(self.skeleton.num_joint_parameters, dtype=off.dtype,
                            device=off.device)
        return fk.global_skel_states(self.skeleton, zeros)

    def with_inverse_bind_pose(self) -> "Character":
        """The character with its inverse bind pose computed from the rest
        skeleton, if it has none (character.h inverseBindPose)."""
        if self.inverse_bind_pose is not None:
            return self
        return dataclasses.replace(self, inverse_bind_pose=ss.inverse(self.bind_pose()))
