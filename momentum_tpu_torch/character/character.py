"""Character: skeleton + parameter transform + limits + locators
(character.h:33-283). Mesh, skinning and blend shapes come with ROADMAP M4.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.limits import ParameterLimits
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import Skeleton
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["Locators", "Character"]


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
