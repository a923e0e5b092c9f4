"""Character surgery, after momentum_tpu/character/utility.py: for now the
two functions that extend a rig with shape coefficients. The rest comes with
ROADMAP M9.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.character.parameter_transform import ParameterTransform

__all__ = ["add_blend_shape_parameters", "add_face_expression_parameters"]


def _extend(character: Character, k: int, prefix: str):
    """(parameter transform with k zero columns named prefix_i appended,
    the new columns' indices)."""
    pt = character.parameter_transform
    old_p = pt.num_model_parameters
    tf = torch.cat([pt.transform, pt.transform.new_zeros(pt.transform.shape[0], k)], dim=1)
    names = pt.names + tuple(f"{prefix}_{i}" for i in range(k))
    return (ParameterTransform(transform=tf, offsets=pt.offsets, names=names),
            tuple(range(old_p, old_p + k)))


def add_blend_shape_parameters(character: Character, blend_shape, num_shapes=None) -> Character:
    """The rig with blend-shape coefficient parameters appended
    (ParameterTransform::addBlendShapeParameters, parameter_transform.h:
    189-227): the new columns drive no joint, and their indices are recorded
    in blend_shape_param_index for the mesh pipeline."""
    k = blend_shape.num_shapes if num_shapes is None else num_shapes
    pt, index = _extend(character, k, "blend")
    return dataclasses.replace(character, parameter_transform=pt, blend_shape=blend_shape,
                               blend_shape_param_index=index)


def add_face_expression_parameters(character: Character, blend_shape,
                                   num_shapes=None) -> Character:
    """As add_blend_shape_parameters, on the separate face-expression basis
    (parameter_transform.h:212-215 addFaceExpressionParameters), which is
    added as deltas to the (possibly shape-blended) rest mesh."""
    k = blend_shape.num_shapes if num_shapes is None else num_shapes
    pt, index = _extend(character, k, "face_expre")
    return dataclasses.replace(character, parameter_transform=pt,
                               face_expression_blend_shape=blend_shape,
                               face_expression_param_index=index)
