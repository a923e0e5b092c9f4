"""Character: skeleton + parameter transform + limits + locators, and an
optional skinned mesh with its inverse bind pose, body blend shapes,
face-expression blend shapes, skinned locators and collision geometry
(character.h:33-283).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.blend_shape import BlendShape
from momentum_tpu_torch.character.limits import ParameterLimits
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import Skeleton
from momentum_tpu_torch.character.skinning import SkinWeights
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["Mesh", "Locators", "SkinnedLocators", "Character", "CollisionGeometry",
           "PhysicalProperties"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Triangle mesh (math/mesh.h): vertices (V, 3), faces (F, 3) int32,
    and the optional per-vertex normals, texcoords (with per-face texcoord
    indices, or None when `faces` indexes them), colours, per-vertex
    confidence, and polylines and their texcoord polylines (tuples of index
    tensors)."""

    vertices: torch.Tensor
    faces: torch.Tensor
    normals: Optional[torch.Tensor] = None
    texcoords: Optional[torch.Tensor] = None
    texcoord_faces: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    confidence: Optional[torch.Tensor] = None
    lines: tuple = ()
    texcoord_lines: tuple = ()

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    # pymomentum.geometry.Mesh's spellings (mesh_pybind.cpp)
    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def self_intersections(self, chunk: int = 256) -> np.ndarray:
        """(N, 2) index pairs of intersecting faces that share no vertex
        (mesh_pybind self_intersections → intersection.h)."""
        from momentum_tpu_torch.math.mesh_ops import intersect_mesh_brute_force

        return intersect_mesh_brute_force(self.vertices, self.faces, chunk=chunk)

    def with_updated_normals(self) -> "Mesh":
        """The mesh with area-weighted vertex normals recomputed (mesh.h
        updateNormals)."""
        from momentum_tpu_torch.character.skinning import update_normals

        return dataclasses.replace(self, normals=update_normals(self.vertices, self.faces))


@dataclasses.dataclass(frozen=True, eq=False)
class Locators:
    """Markers attached to joints: offset in the parent-joint frame
    (character/locator.h), with the optional per-axis lock flags, the
    calibration pull of limit_weight toward limit_origin, and the
    skin-derived flags and offsets (locator.h:21-46); None reads as zeros."""

    parent: torch.Tensor  # (L,) int32
    offset: torch.Tensor  # (L, 3)
    weight: torch.Tensor  # (L,)
    names: tuple = ()
    locked: Optional[torch.Tensor] = None  # (L, 3) 0/1
    limit_weight: Optional[torch.Tensor] = None  # (L, 3)
    limit_origin: Optional[torch.Tensor] = None  # (L, 3)
    attached_to_skin: Optional[torch.Tensor] = None  # (L,) 0/1
    skin_offset: Optional[torch.Tensor] = None  # (L,)

    @property
    def num_locators(self) -> int:
        return self.parent.shape[0]

    def world_positions(self, global_states: torch.Tensor) -> torch.Tensor:
        """(..., nJ, 8) global states → (..., L, 3) locator positions
        (locator_state.h)."""
        states = global_states.index_select(-2, self.parent)
        return ss.transform_points(states, self.offset)


@dataclasses.dataclass(frozen=True, eq=False)
class SkinnedLocators:
    """Locators skinned to up to K joints (character/skinned_locator.h:25-47):
    a rest-pose point moved by the blend of its joints' skinning matrices."""

    parents: torch.Tensor  # (L, K) int32
    skin_weights: torch.Tensor  # (L, K)
    rest_position: torch.Tensor  # (L, 3)
    names: tuple = ()

    @property
    def num_locators(self) -> int:
        return self.parents.shape[0]

    def world_positions(self, character, global_states: torch.Tensor,
                        rest_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., nJ, 8) global states → (..., L, 3): Σ_k w_k·(T_k·invBind_k)·rest,
        the rest positions shifted by `rest_offset` (..., L, 3) if given."""
        ibp = character.with_inverse_bind_pose().inverse_bind_pose
        flat = self.parents.reshape(-1)
        lead = global_states.shape[:-2]
        skin_t = ss.multiply(global_states.index_select(-2, flat),
                             ibp.index_select(0, flat)).reshape(lead + self.parents.shape + (8,))
        rest = self.rest_position if rest_offset is None else self.rest_position + rest_offset
        pts = ss.transform_points(skin_t, rest[..., :, None, :])
        return torch.sum(self.skin_weights[..., None] * pts, dim=-2)


@dataclasses.dataclass(frozen=True, eq=False)
class PhysicalProperties:
    """Per-joint mass bodies in SoA form (character/joint.h:88-114
    JointPhysicalProperties, character.h:66): mass (kg), the centre-of-mass
    offset in the joint's frame, the inertia about the body's centre of mass
    in its inertia frame, and that frame's rotation into the joint's
    (quaternion x, y, z, w). `joint_names` is what a remap goes by;
    `joint_index` resolves it (joint.h:92-98)."""

    joint_index: torch.Tensor  # (B,) int32
    mass: torch.Tensor  # (B,)
    center_of_mass_offset: torch.Tensor  # (B, 3)
    inertia: torch.Tensor  # (B, 3, 3)
    inertia_rotation: torch.Tensor  # (B, 4)
    joint_names: tuple = ()

    @property
    def num_bodies(self) -> int:
        return self.joint_index.shape[0]

    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.mass)

    def com_constraint(self, num_joints: int):
        """(masses (nJ,), local offsets (nJ, 3)): each joint's summed mass and
        the mass-weighted mean of its bodies' offsets, for the centre-of-mass
        error (center_of_mass_error_function.cpp:46); zero where a joint has
        no body."""
        idx = self.joint_index.long()
        masses = self.mass.new_zeros(num_joints).index_add(0, idx, self.mass)
        weighted = self.mass.new_zeros(num_joints, 3).index_add(
            0, idx, self.mass[:, None] * self.center_of_mass_offset)
        return masses, weighted / torch.clamp(masses, min=1e-12)[:, None]


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

    @property
    def num_primitives(self) -> int:
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
    skinned_locators: Optional[SkinnedLocators] = None
    # model-parameter indices of the skinned locators' rest offsets, the
    # (L, 3) table flattened, -1 where a locator has none
    # (parameter_transform.h:94-95 skinnedLocatorParameters)
    skinned_locator_param_index: Optional[tuple] = None
    # per-joint mass bodies (character.h:66)
    physical_properties: Optional[PhysicalProperties] = None
    # free-form metadata (character_pybind with_metadata)
    metadata: str = ""

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

    # functional with_* updates (character_pybind with_mesh_and_skin_weights
    # etc.): each returns a new Character
    def with_mesh_and_skin_weights(self, mesh: Mesh, skin_weights: SkinWeights) -> "Character":
        return dataclasses.replace(self, mesh=mesh, skin_weights=skin_weights,
                                   inverse_bind_pose=None).with_inverse_bind_pose()

    def with_locators(self, locators: Locators) -> "Character":
        return dataclasses.replace(self, locators=locators)

    def with_collision_geometry(self, collision: CollisionGeometry) -> "Character":
        return dataclasses.replace(self, collision=collision)

    def with_parameter_limits(self, limits: ParameterLimits) -> "Character":
        return dataclasses.replace(self, limits=limits)

    def with_name(self, name: str) -> "Character":
        return dataclasses.replace(self, name=name)

    def with_metadata(self, metadata: str) -> "Character":
        """The character with a free-form metadata string (character_pybind
        with_metadata)."""
        return dataclasses.replace(self, metadata=metadata)

    def clone(self) -> "Character":
        """A copy (the fields are shared: every operation returns a new
        Character)."""
        return dataclasses.replace(self)

    @property
    def has_mesh(self) -> bool:
        """Both a mesh and skin weights (character_pybind.cpp:431-435)."""
        return self.mesh is not None and self.skin_weights is not None

    def skel_states(self, model_params: torch.Tensor) -> torch.Tensor:
        """The pybind spelling of skeleton_states: (..., P) → (..., nJ, 8)."""
        return self.skeleton_states(model_params)

    def rebind_skin(self) -> "Character":
        """The inverse bind pose from the rest skeleton, if the character has
        none (character_pybind rebind_skin → initInverseBindPose)."""
        return self.with_inverse_bind_pose()

    def pose_mesh(self, model_params: torch.Tensor) -> torch.Tensor:
        """Posed mesh vertices (..., V, 3): linear blend skinning, after the
        blend shapes where the rig drives them (Character.pose_mesh)."""
        from momentum_tpu_torch.compat import skin_points_from_model_parameters

        return skin_points_from_model_parameters(self, model_params)

    skin_points = pose_mesh

    def apply_model_param_limits(self, model_params: torch.Tensor) -> torch.Tensor:
        """Model parameters clamped into their MinMax ranges (character_pybind
        apply_model_param_limits; with duplicate records the write order is
        unspecified)."""
        lim = self.limits
        if lim is None or lim.minmax_index.shape[0] == 0:
            return model_params
        idx = lim.minmax_index.long()
        vals = model_params.index_select(-1, idx)
        clamped = torch.minimum(torch.maximum(vals, lim.minmax_bounds[:, 0]),
                                lim.minmax_bounds[:, 1])
        out = model_params.clone()
        out[..., idx] = clamped
        return out

    def find_locators(self, names) -> torch.Tensor:
        """int32 indices of the named locators (character_pybind
        find_locators); KeyError on a name it lacks."""
        if self.locators is None:
            raise KeyError("character has no locators")
        lookup = {n: i for i, n in enumerate(self.locators.names)}
        try:
            idx = [lookup[n] for n in names]
        except KeyError as e:
            raise KeyError(f"unknown locator {e.args[0]!r}") from None
        return torch.as_tensor(idx, dtype=torch.int32, device=self.locators.parent.device)

    def scaled(self, scale: float, mass_scale: str = "preserve_mass") -> "Character":
        from momentum_tpu_torch.character.utility import scale_character

        return scale_character(self, scale, mass_scale)

    def transformed(self, xform: torch.Tensor) -> "Character":
        from momentum_tpu_torch.character.utility import transform_character

        return transform_character(self, xform)

    def simplify(self, enabled_params=None) -> "Character":
        from momentum_tpu_torch.character.utility import simplify

        return simplify(self, enabled_params)

    def bake_blend_shape(self, coefficients: torch.Tensor) -> "Character":
        """Blend-shape coefficients baked into the rest mesh, the basis and
        its parameter index dropped (character.h bake)."""
        from momentum_tpu_torch.character.utility import bake_blend_shape

        return bake_blend_shape(self, coefficients)

    def simplify_skeleton(self, enabled_joint_indices) -> "Character":
        """Only the listed joints and their ancestors kept
        (character_pybind simplify_skeleton)."""
        from momentum_tpu_torch.character.utility import simplify_skeleton

        mask = np.zeros(self.num_joints, bool)
        mask[np.asarray(enabled_joint_indices, np.int64)] = True
        return simplify_skeleton(self, mask)

    def simplify_parameter_transform(self, enabled_parameters) -> "Character":
        """The rig reduced to the enabled model parameters (a boolean mask;
        character_pybind simplify_parameter_transform)."""
        from momentum_tpu_torch.character.utility import simplify_parameter_transform

        return simplify_parameter_transform(self, np.asarray(enabled_parameters, bool))

    def joints_for_parameters(self, active_parameters) -> list:
        """Joint indices driven by the given parameters (a boolean mask or
        an index list; character_pybind joints_for_parameters)."""
        from momentum_tpu_torch.character.utility import parameters_to_active_joints

        arr = np.asarray(active_parameters)
        if arr.dtype != bool:
            mask = np.zeros(self.num_model_parameters, bool)
            mask[arr.astype(np.int64)] = True
        else:
            mask = arr
        active = parameters_to_active_joints(self.parameter_transform, mask)
        return [int(j) for j in np.nonzero(active)[0]]

    def parameters_for_joints(self, joint_indices) -> np.ndarray:
        """Boolean mask of the parameters that drive the given joints
        (character_pybind parameters_for_joints)."""
        return self.parameter_transform.parameters_for_joints(joint_indices)

    def with_skinned_locators(self, skinned_locators: SkinnedLocators) -> "Character":
        return dataclasses.replace(self, skinned_locators=skinned_locators)

    def skin_skinned_locators(self, skel_state: torch.Tensor,
                              rest_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """World positions of the skinned locators under global states
        (..., nJ, 8), their rest positions replaced by `rest_positions` if
        given (character_pybind skin_skinned_locators)."""
        if self.skinned_locators is None:
            raise ValueError("character has no skinned locators")
        sl = self.skinned_locators
        if rest_positions is not None:
            sl = dataclasses.replace(sl, rest_position=torch.as_tensor(
                rest_positions, dtype=torch.float32, device=sl.rest_position.device))
        return sl.world_positions(self, skel_state.float())

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

    # ---- the file members (character_pybind.cpp:139-260, 719-1100): thin
    # delegations to momentum_tpu_torch.io; the loaders build on `device`,
    # the card unless the caller asks for the CPU ----

    @classmethod
    def load_gltf(cls, path, device="cuda") -> "Character":
        from momentum_tpu_torch.io.gltf import load_character_glb

        return load_character_glb(str(path), device=device)[0]

    @classmethod
    def load_gltf_with_motion(cls, path, device="cuda"):
        """→ (Character, motion (F, P) or None, fps)."""
        from momentum_tpu_torch.io.gltf import load_character_glb

        return load_character_glb(str(path), device=device)

    @classmethod
    def load_gltf_from_bytes(cls, gltf_bytes, device="cuda") -> "Character":
        from momentum_tpu_torch.io.gltf import load_character_glb

        return load_character_glb(bytes(gltf_bytes), device=device)[0]

    @classmethod
    def load_gltf_with_motion_from_bytes(cls, gltf_bytes, device="cuda"):
        from momentum_tpu_torch.io.gltf import load_character_glb

        return load_character_glb(bytes(gltf_bytes), device=device)

    @classmethod
    def load_gltf_with_skel_states(cls, path, fps: float = None, device="cuda"):
        """→ (Character, skel_states (F, nJ, 8) or None, fps), the states by
        FK on `device`. fps=None samples at the file's own keyframe rate."""
        from momentum_tpu_torch.io.gltf import load_character_glb_with_skel_states

        return load_character_glb_with_skel_states(path, fps, device=device)

    @classmethod
    def load_gltf_with_skel_states_from_bytes(cls, gltf_bytes, fps: float = None,
                                              device="cuda"):
        from momentum_tpu_torch.io.gltf import load_character_glb_with_skel_states

        return load_character_glb_with_skel_states(bytes(gltf_bytes), fps, device=device)

    @classmethod
    def load_fbx(cls, path, device="cuda") -> "Character":
        from momentum_tpu_torch.io.fbx import load_fbx

        return load_fbx(str(path), device=device)

    @classmethod
    def load_fbx_with_motion(cls, path, fps: float = 120.0, device="cuda"):
        """→ (Character, motion (F, nJ·7), fps) on `device`."""
        from momentum_tpu_torch.io.fbx import load_fbx_with_motion

        return load_fbx_with_motion(str(path), fps, device=device)

    @classmethod
    def load_fbx_from_bytes(cls, fbx_bytes, device="cuda", **kwargs) -> "Character":
        from momentum_tpu_torch.io.fbx import load_fbx

        return load_fbx(bytes(fbx_bytes), device=device, **kwargs)

    @classmethod
    def load_fbx_with_motion_from_bytes(cls, fbx_bytes, fps: float = 120.0, device="cuda"):
        from momentum_tpu_torch.io.fbx import load_fbx_with_motion

        return load_fbx_with_motion(bytes(fbx_bytes), fps, device=device)

    @classmethod
    def load_urdf(cls, path, device="cuda") -> "Character":
        from momentum_tpu_torch.io.urdf import load_urdf

        return load_urdf(str(path), device=device)

    @classmethod
    def load_legacy_json(cls, path, device="cuda") -> "Character":
        from momentum_tpu_torch.io.legacy_json import load_legacy_json

        return load_legacy_json(str(path), device=device)

    @classmethod
    def load_legacy_json_from_bytes(cls, json_bytes, device="cuda") -> "Character":
        from momentum_tpu_torch.io.legacy_json import load_legacy_json

        return load_legacy_json(bytes(json_bytes).decode("utf-8"), device=device)

    @classmethod
    def load_legacy_json_from_string(cls, json_string: str, device="cuda") -> "Character":
        from momentum_tpu_torch.io.legacy_json import load_legacy_json

        return load_legacy_json(json_string, device=device)

    @staticmethod
    def load_motion_timestamps(gltf_filename):
        """Per-frame timestamps stored alongside GLB motion (gltf_io.h:57)."""
        from momentum_tpu_torch.io.gltf import load_motion_timestamps

        return load_motion_timestamps(gltf_filename)

    def save_gltf(self, path, motion=None, fps: float = 120.0, markers=None) -> None:
        from momentum_tpu_torch.io.gltf import save_character_glb

        save_character_glb(str(path), self, motion=motion, fps=fps, markers=markers)

    def save_fbx(self, path, motion=None, fps: float = 120.0) -> None:
        from momentum_tpu_torch.io.fbx_writer import save_fbx

        save_fbx(str(path), self, motion=motion, fps=fps)

    def save_fbx_with_joint_params(self, path, joint_params=None, fps: float = 120.0) -> None:
        from momentum_tpu_torch.io.fbx_writer import save_fbx_with_joint_params

        save_fbx_with_joint_params(str(path), self, joint_params, fps=fps)

    def save_legacy_json(self, path) -> None:
        from momentum_tpu_torch.io.legacy_json import save_legacy_json

        save_legacy_json(str(path), self)

    def save(self, path, motion=None, fps: float = 120.0) -> None:
        """Save in the format implied by the extension (character_pybind
        save → character_io.h saveCharacter dispatch)."""
        from momentum_tpu_torch.io.character_io import save_character

        save_character(str(path), self, motion=motion, fps=fps)

    def save_gltf_from_skel_states(self, path, skel_states, fps: float = 120.0) -> None:
        """Save with motion given as GLOBAL skeleton states, exported as
        standard glTF animation channels (character_pybind
        save_gltf_from_skel_states → GltfBuilder)."""
        from momentum_tpu_torch.io.gltf_builder import GltfBuilder

        GltfBuilder().add_character(self).add_skeleton_states(skel_states).set_fps(
            fps).save(str(path))

    def save_with_skel_states(self, path, skel_states, fps: float = 120.0) -> None:
        """Extension-dispatched save with skeleton-state motion: .glb/.gltf
        via animation channels, .usd* via UsdSkel, .fbx via inverse FK to
        joint curves (character_pybind save_with_skel_states). The inverse FK
        runs on the character's device."""
        import os as _os

        ext = _os.path.splitext(str(path))[1].lower()
        if ext in (".glb", ".gltf"):
            self.save_gltf_from_skel_states(path, skel_states, fps)
        elif ext in (".usd", ".usda", ".usdc"):
            from momentum_tpu_torch.io.usd import save_character_from_skel_states

            save_character_from_skel_states(path, self, skel_states, fps)
        elif ext == ".fbx":
            from momentum_tpu_torch.character.inverse_fk import (
                joint_parameters_from_skeleton_states)
            from momentum_tpu_torch.io.fbx_writer import save_fbx_with_joint_params

            states = torch.as_tensor(skel_states, dtype=torch.float32).to(
                self.skeleton.translation_offset.device)
            if states.ndim == 2:
                states = states[None]
            save_fbx_with_joint_params(str(path), self, joint_parameters_from_skeleton_states(
                self.skeleton, states), fps)
        else:
            raise ValueError(f"unsupported extension {ext!r}")

    def to_gltf(self, fps: float = 120.0, motion=None) -> dict:
        """The character as a glTF document dictionary (character_pybind
        to_gltf 'dictionary form')."""
        import json as _json
        import struct as _struct

        from momentum_tpu_torch.io.gltf import _character_glb_bytes

        data = _character_glb_bytes(self, motion=motion, fps=fps)
        json_len = _struct.unpack_from("<I", data, 12)[0]
        return _json.loads(data[20:20 + json_len])

    def to_legacy_json_string(self) -> str:
        """The legacy full-character JSON as a string (character_pybind
        to_legacy_json_string)."""
        from momentum_tpu_torch.io.legacy_json import legacy_json_text

        return legacy_json_text(self)

    def load_locators(self, source) -> "Character":
        """The character with locators from a .locators file (path, bytes
        or JSON text) on its device (character_pybind load_locators)."""
        from momentum_tpu_torch.io.locators import load_locators

        return dataclasses.replace(self, locators=load_locators(source, self))

    def save_locators(self, path, space: str = "local") -> None:
        from momentum_tpu_torch.io.locators import save_locators

        save_locators(str(path), self, space)

    def load_model_definition(self, source) -> "Character":
        """The character with its parameter transform and limits replaced from
        a .model/.cfg definition (path or text), on its device."""
        from momentum_tpu_torch.io.model_definition import load_model_definition

        pt, limits = load_model_definition(source, self.skeleton)
        return dataclasses.replace(self, parameter_transform=pt, limits=limits)
