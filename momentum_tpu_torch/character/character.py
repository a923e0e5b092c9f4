"""Character: skeleton + parameter transform + limits + locators, and an
optional skinned mesh with its inverse bind pose, body blend shapes,
face-expression blend shapes and collision geometry (character.h:33-283).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.blend_shape import BlendShape
from momentum_tpu_torch.character.limits import ParameterLimits
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import Skeleton
from momentum_tpu_torch.character.skinning import SkinWeights
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["Mesh", "Locators", "CollisionGeometry", "Character"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Triangle mesh (math/mesh.h): vertices (V, 3), faces (F, 3) int32,
    and the optional per-vertex normals, texcoords (with per-face texcoord
    indices, or None when `faces` indexes them), colours, and polylines (a
    tuple of index tensors)."""

    vertices: torch.Tensor
    faces: torch.Tensor
    normals: Optional[torch.Tensor] = None
    texcoords: Optional[torch.Tensor] = None
    texcoord_faces: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    lines: tuple = ()

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    def with_updated_normals(self) -> "Mesh":
        """The mesh with area-weighted vertex normals recomputed (mesh.h
        updateNormals)."""
        from momentum_tpu_torch.character.skinning import update_normals

        return dataclasses.replace(self, normals=update_normals(self.vertices, self.faces))


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


# CollisionPrimitiveType (collision_geometry.h:22-26)
PRIMITIVE_TAPERED_CAPSULE = 0
PRIMITIVE_ELLIPSOID = 1
PRIMITIVE_BOX = 2


@dataclasses.dataclass(frozen=True, eq=False)
class CollisionGeometry:
    """Per-joint collision primitives in SoA form (collision_geometry.h:22-170
    TaperedCapsule / Ellipsoid / Box): the transform in the parent joint's
    frame (an (8,) skel_state) and each primitive type's shape fields.
    `ptype` selects the primitive kind of a row (None: all capsules); the
    unused shape fields of a row are zero."""

    parent: torch.Tensor  # (C,) int32
    transform: torch.Tensor  # (C, 8) local skel_state
    radius: torch.Tensor  # (C, 2) tapered-capsule endpoint radii
    length: torch.Tensor  # (C,) capsule length along local x
    ptype: Optional[torch.Tensor] = None  # (C,) int32: 0 capsule, 1 ellipsoid, 2 box
    ellipsoid_radii: Optional[torch.Tensor] = None  # (C, 3)
    box_half_extents: Optional[torch.Tensor] = None  # (C, 3)

    @property
    def num_capsules(self) -> int:
        return self.parent.shape[0]

    def primitive_types(self) -> torch.Tensor:
        if self.ptype is None:
            return torch.zeros_like(self.parent)
        return self.ptype

    def shape3(self, field: str) -> torch.Tensor:
        """The (C, 3) shape field `field`, zeros when the geometry has none."""
        arr = getattr(self, field)
        if arr is None:
            return self.radius.new_zeros(self.parent.shape + (3,))
        return arr


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
    blend_shape: Optional[BlendShape] = None
    # model-parameter indices of the blend-shape coefficients, in basis order
    # (ParameterTransform::blendShapeParameters, parameter_transform.h:189-227)
    blend_shape_param_index: Optional[tuple] = None
    # the separate face-expression basis and its coefficients' indices
    # (character.h faceExpressionBlendShape, parameter_transform.h:212-215)
    face_expression_blend_shape: Optional[BlendShape] = None
    face_expression_param_index: Optional[tuple] = None
    collision: Optional[CollisionGeometry] = None

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

    def with_collision_geometry(self, collision: CollisionGeometry) -> "Character":
        return dataclasses.replace(self, collision=collision)

    def with_blend_shape(self, blend_shape: BlendShape, num_shapes=None) -> "Character":
        """Attach a blend-shape basis and extend the rig with its coefficient
        parameters (character.h withBlendShape)."""
        from momentum_tpu_torch.character.utility import add_blend_shape_parameters

        return add_blend_shape_parameters(self, blend_shape, num_shapes)

    def with_face_expression_blend_shape(self, blend_shape: BlendShape,
                                         num_shapes=None) -> "Character":
        """Attach a face-expression basis and extend the rig with its
        coefficient parameters (character.h withFaceExpressionBlendShape)."""
        from momentum_tpu_torch.character.utility import add_face_expression_parameters

        return add_face_expression_parameters(self, blend_shape, num_shapes)

    @functools.cached_property
    def shape_bases(self) -> tuple:
        """((basis, index (K,) int64, sel (K, P) one-hot), ...) for the body
        and face-expression bases the rig drives: the coefficients' gather
        index and their scatter into model-parameter columns, built once on
        the character's device (the JAX package's trace-time numpy `sel`,
        errors/vertex.py:63-66)."""
        out = []
        p = self.num_model_parameters
        device = self.parameter_transform.transform.device
        for basis, pidx in ((self.blend_shape, self.blend_shape_param_index),
                            (self.face_expression_blend_shape,
                             self.face_expression_param_index)):
            if basis is None or not pidx:
                out.append(None)
                continue
            index = torch.as_tensor(pidx, dtype=torch.int64, device=device)
            sel = torch.zeros(len(pidx), p, dtype=basis.shape_vectors.dtype, device=device)
            sel[torch.arange(len(pidx), device=device), index] = 1.0
            out.append((basis, index, sel))
        return tuple(out)
