"""CharacterState: one fully posed character snapshot — the port of
momentum_tpu/character/character_state.py.

Reference: character/character_state.{h,cpp} CharacterStateT — the skeleton
state, locator positions, posed mesh and posed collision geometry of one
parameter vector, for viewers, exporters and anything that needs "the
character at this pose". Batch-native: model parameters (..., P) give
fields with the same leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from momentum_tpu_torch.character import fk

__all__ = ["CharacterState", "character_state"]


@dataclasses.dataclass(frozen=True, eq=False)
class CharacterState:
    """Posed snapshot (character_state.h), every field in world space; the
    collision fields in collision_geometry_state.h's SoA layout."""

    model_parameters: torch.Tensor  # (..., P)
    joint_parameters: torch.Tensor  # (..., nJ*7)
    skeleton_state: torch.Tensor  # (..., nJ, 8) global skel states
    locator_positions: Optional[torch.Tensor] = None  # (..., L, 3)
    mesh_vertices: Optional[torch.Tensor] = None  # (..., V, 3)
    mesh_normals: Optional[torch.Tensor] = None  # (..., V, 3)
    collision_origin: Optional[torch.Tensor] = None  # (..., C, 3)
    collision_direction: Optional[torch.Tensor] = None  # (..., C, 3)
    collision_radius: Optional[torch.Tensor] = None  # (..., C, 2)


def character_state(character, model_parameters: torch.Tensor, update_mesh: bool = True,
                    update_collision: bool = True) -> CharacterState:
    """Pose everything once (CharacterStateT's constructor,
    character_state.cpp): FK (kernel K1 on the card) → locators → LBS mesh
    (with the blend shapes when the parameters drive them) and its normals
    → collision capsules. The mesh needs the character's inverse bind pose
    (`Character.with_inverse_bind_pose`)."""
    jp = character.joint_parameters(model_parameters)
    states = fk.global_skel_states(character.skeleton, jp)
    locs = None
    if character.locators is not None:
        locs = character.locators.world_positions(states)

    mesh_v = mesh_n = None
    if update_mesh and character.mesh is not None and character.skin_weights is not None:
        from momentum_tpu_torch.character.skinning import skin_points, update_normals

        rest = character.mesh.vertices
        if character.blend_shape is not None and character.blend_shape_param_index:
            coeffs = model_parameters[..., list(character.blend_shape_param_index)]
            rest = character.blend_shape.apply(coeffs)
        mesh_v = skin_points(character.skin_weights, states, character.inverse_bind_pose, rest)
        mesh_n = update_normals(mesh_v, character.mesh.faces)

    co = cd = cr = None
    if update_collision and character.collision is not None:
        from momentum_tpu_torch.errors.collision import capsule_states

        co, cd, cr = capsule_states(character.collision, states)

    return CharacterState(model_parameters=model_parameters, joint_parameters=jp,
                          skeleton_state=states, locator_positions=locs, mesh_vertices=mesh_v,
                          mesh_normals=mesh_n, collision_origin=co, collision_direction=cd,
                          collision_radius=cr)
