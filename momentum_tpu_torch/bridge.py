"""Build port objects from plain numpy arrays, so the port and the JAX
package can compute on identical inputs.

The dicts hold exactly the arrays of a `momentum_tpu` Character or
PositionErrorFunction (as `np.asarray` gives them); the side that extracts
them from JAX objects lives with the tests, since this package imports no
jax.

character_from_numpy keys (shapes as in momentum_tpu):
    joint_parent (nJ,) int32, pre_rotation (nJ, 4), translation_offset (nJ, 3),
    transform (nJ*7, P), offsets (nJ*7,), optional parameter_names (P,) str,
    optional parameter_sets (a dict of name -> index array),
    optional pose_constraints (a dict of name -> ((parameter index, value), ...)),
    the limit tables of ParameterLimits under their field names
    (minmax_index (M,), minmax_bounds (M, 2), ..., ellipsoid_weight (E,)),
    a record type whose tables are absent having no records,
    optional locator_parent (L,), locator_offset (L, 3), locator_weight (L,),
    and with them optional locator_names (L,) str, locator_locked (L, 3),
    locator_limit_weight (L, 3), locator_limit_origin (L, 3),
    locator_attached_to_skin (L,), locator_skin_offset (L,); optional
    joint_names (nJ,) str; optional name and metadata (str);
    optional mesh_vertices (V, 3), mesh_faces (F, 3) int32, and with them
    optional mesh_normals (V, 3), mesh_texcoords (T, 2),
    mesh_texcoord_faces (F, 3), mesh_colors (V, 3), mesh_confidence (V,),
    mesh_lines and mesh_texcoord_lines (sequences of index arrays);
    skin_index (V, 8), skin_weight (V, 8),
    inverse_bind_pose (nJ, 8);
    optional blend_shape_base (V, 3), blend_shape_vectors (K, V, 3),
    blend_shape_param_index (K,) and the same three for
    face_expression_{base,vectors,param_index};
    optional collision_parent (C,), collision_transform (C, 8),
    collision_radius (C, 2), collision_length (C,), and with them optional
    collision_ptype (C,), collision_ellipsoid_radii (C, 3),
    collision_box_half_extents (C, 3);
    optional skinned_locator_parents (S, K), skinned_locator_skin_weights
    (S, K), skinned_locator_rest_position (S, 3), and with them optional
    skinned_locator_names (S,) str and skinned_locator_param_index (3S,)
    (−1: no parameter);
    optional body_joint_index (B,), body_mass (B,),
    body_center_of_mass_offset (B, 3), body_inertia (B, 3, 3),
    body_inertia_rotation (B, 4), and with them optional body_joint_names
    (B,) str (a PhysicalProperties)
covariance_from_numpy keys:
    a (k, n), sigma () (a LowRankCovarianceMatrix)
camera_from_numpy keys:
    fx, fy, cx, cy (), image_width, image_height (), eye_from_world (8,),
    and for a distorted model k and p: k (6,) with p (4,) an OpenCV camera,
    k (4,) alone a fisheye one
position_error_from_numpy keys:
    parent (C,), offset (C, 3), target (..., C, 3), cweight (C,), weight (),
    optional loss_alpha, loss_c
orientation_error_from_numpy keys:
    parent (C,), offset (C, 4), target (..., C, 4), cweight (C,), weight (),
    optional loss_alpha, loss_c
limit_error_from_numpy keys:
    weight (), optional loss_alpha, loss_c
pose_prior_from_numpy keys:
    mu (K, d), cinv (K, d, d), l (K, d, d), rpre (K,), param_index (d,) int
    (−1: unmapped), weight (), optional sub_jtj (K, P, P)
vertex_{position,plane,normal,projection}_error_from_numpy keys:
    vertex_index (C,), cweight (C,), weight (), optional loss_alpha, loss_c,
    and the module's own fields: target (..., C, 3) for position; point,
    normal (C, 3) and above () for plane; target_position, target_normal
    (C, 3), source_normal_weight, target_normal_weight () for normal;
    projection (C, 3, 4), target (C, 2), near_clip () for projection
sdf_from_numpy keys:
    origin (3,), spacing (3,), values (nx, ny, nz) (a SignedDistanceField)
triangle_grid_from_numpy keys:
    cells (R, R, R, K) int32, origin (3,), cell_size (), resolution ()
vertex_sdf_error_from_numpy keys:
    the field under sdf_origin, sdf_spacing, sdf_values; vertex_index (C,),
    target_distance (..., C), cweight (C,), weight (), sdf_parent (),
    optional loss_alpha, loss_c
sdf_collision_error_from_numpy keys:
    sdf_origin, sdf_spacing, sdf_values, vertex_index (C,), cweight (C,),
    weight (), optional loss_alpha, loss_c
sdf_collision_sequence_error_from_numpy keys:
    sdf_origin, sdf_spacing, sdf_values, vertex_index (C,), cweight (C,),
    weight ()
phong_material_from_numpy keys:
    diffuse_color, specular_color, emissive_color (3,), specular_exponent (),
    optional diffuse_texture, emissive_texture (Th, Tw, 3)
lights_from_numpy: a sequence of dicts with keys
    position (3,), color (3,), type () int (0 point, 1 directional, 2 ambient)

Every function builds on `device`, the card unless the caller asks for the
CPU, and raises on a machine without one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.camera import (
    Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)
from momentum_tpu_torch.character import (
    BlendShape, Character, CollisionGeometry, Locators, Mesh, ParameterLimits,
    ParameterTransform, PhysicalProperties, Skeleton, SkinnedLocators, SkinWeights,
    make_limits)
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors import (
    LimitErrorFunction, Mppca, OrientationErrorFunction, PosePriorErrorFunction,
    PositionErrorFunction, VertexNormalErrorFunction, VertexPlaneErrorFunction,
    VertexPositionErrorFunction, VertexProjectionErrorFunction)
from momentum_tpu_torch.math.covariance import LowRankCovarianceMatrix
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["character_from_numpy", "covariance_from_numpy", "camera_from_numpy", "position_error_from_numpy",
           "orientation_error_from_numpy", "limit_error_from_numpy",
           "pose_prior_from_numpy", "vertex_position_error_from_numpy",
           "vertex_plane_error_from_numpy", "vertex_normal_error_from_numpy",
           "vertex_projection_error_from_numpy", "phong_material_from_numpy",
           "lights_from_numpy", "sdf_from_numpy", "triangle_grid_from_numpy",
           "vertex_sdf_error_from_numpy", "sdf_collision_error_from_numpy",
           "sdf_collision_sequence_error_from_numpy"]

_LIMIT_KEYS = tuple(f.name for f in dataclasses.fields(ParameterLimits))
_COLLISION_KEYS = tuple(f.name for f in dataclasses.fields(CollisionGeometry))


def _t(d, key, device):
    return torch.as_tensor(np.array(d[key]), device=device)  # a writable copy


def _loss(d) -> GeneralizedLoss:
    return GeneralizedLoss(alpha=float(d.get("loss_alpha", 2.0)),
                           c=float(d.get("loss_c", 1.0)))


def _opt(d, key, device):
    return _t(d, key, device) if key in d else None


def _basis(d, prefix, device):
    """(BlendShape, parameter index tuple) of `prefix`_{base,vectors,
    param_index}, or (None, None)."""
    if f"{prefix}_vectors" not in d:
        return None, None
    basis = BlendShape(base_shape=_t(d, f"{prefix}_base", device),
                       shape_vectors=_t(d, f"{prefix}_vectors", device))
    return basis, tuple(int(i) for i in np.asarray(d[f"{prefix}_param_index"]))


def _limits(d, device) -> ParameterLimits:
    """The limit tables of d, an absent table empty."""
    empty = make_limits(device=device)
    tables = {}
    for k in _LIMIT_KEYS:
        default = getattr(empty, k)
        tables[k] = _t(d, k, device).to(default.dtype) if k in d else default
    return ParameterLimits(**tables)


def _collision(d, device):
    if "collision_parent" not in d:
        return None
    return CollisionGeometry(**{
        k: (_t(d, f"collision_{k}", device).to(torch.int32) if k in ("parent", "ptype")
            else _t(d, f"collision_{k}", device))
        for k in _COLLISION_KEYS if f"collision_{k}" in d})


def _names(d, key) -> tuple:
    return tuple(str(n) for n in d.get(key, ()))


def _skinned_locators(d, device):
    """(SkinnedLocators, parameter index tuple or None), or (None, None)."""
    if "skinned_locator_parents" not in d:
        return None, None
    sl = SkinnedLocators(
        parents=_t(d, "skinned_locator_parents", device).to(torch.int32),
        skin_weights=_t(d, "skinned_locator_skin_weights", device),
        rest_position=_t(d, "skinned_locator_rest_position", device),
        names=_names(d, "skinned_locator_names"))
    index = d.get("skinned_locator_param_index")
    return sl, None if index is None else tuple(int(i) for i in np.asarray(index))


def _bodies(d, device):
    if "body_joint_index" not in d:
        return None
    return PhysicalProperties(
        joint_index=_t(d, "body_joint_index", device).to(torch.int32),
        **{k: _t(d, f"body_{k}", device) for k in ("mass", "center_of_mass_offset", "inertia",
                                                   "inertia_rotation")},
        joint_names=_names(d, "body_joint_names"))


def _lines(d, key, device) -> tuple:
    return tuple(torch.as_tensor(np.array(line), device=device) for line in d.get(key, ()))


def character_from_numpy(d: dict, device="cuda") -> Character:
    device = resolve(device, "character_from_numpy")
    skeleton = Skeleton(joint_parent=_t(d, "joint_parent", device).to(torch.int32),
                        pre_rotation=_t(d, "pre_rotation", device),
                        translation_offset=_t(d, "translation_offset", device),
                        joint_names=_names(d, "joint_names"))
    pt = ParameterTransform(
        transform=_t(d, "transform", device), offsets=_t(d, "offsets", device),
        names=tuple(str(n) for n in d.get("parameter_names", ())),
        parameter_sets={k: tuple(int(i) for i in np.asarray(v))
                        for k, v in d.get("parameter_sets", {}).items()},
        pose_constraints={k: tuple((int(i), float(x)) for i, x in v)
                          for k, v in d.get("pose_constraints", {}).items()})
    limits = _limits(d, device)
    locators = None
    if "locator_parent" in d:
        locators = Locators(parent=_t(d, "locator_parent", device).to(torch.int32),
                            offset=_t(d, "locator_offset", device),
                            weight=_t(d, "locator_weight", device),
                            names=_names(d, "locator_names"),
                            **{k: _opt(d, f"locator_{k}", device) for k in (
                                "locked", "limit_weight", "limit_origin", "attached_to_skin",
                                "skin_offset")})
    mesh = skin = inverse_bind_pose = None
    if "mesh_vertices" in d:
        mesh = Mesh(vertices=_t(d, "mesh_vertices", device),
                    faces=_t(d, "mesh_faces", device).to(torch.int32),
                    normals=_opt(d, "mesh_normals", device),
                    texcoords=_opt(d, "mesh_texcoords", device),
                    texcoord_faces=_opt(d, "mesh_texcoord_faces", device),
                    colors=_opt(d, "mesh_colors", device),
                    confidence=_opt(d, "mesh_confidence", device),
                    lines=_lines(d, "mesh_lines", device),
                    texcoord_lines=_lines(d, "mesh_texcoord_lines", device))
    if "skin_index" in d:
        skin = SkinWeights(index=_t(d, "skin_index", device).to(torch.int32),
                           weight=_t(d, "skin_weight", device))
    if "inverse_bind_pose" in d:
        inverse_bind_pose = _t(d, "inverse_bind_pose", device)
    blend, blend_index = _basis(d, "blend_shape", device)
    face, face_index = _basis(d, "face_expression", device)
    skinned, skinned_index = _skinned_locators(d, device)
    return Character(skeleton=skeleton, parameter_transform=pt, limits=limits,
                     locators=locators, mesh=mesh, skin_weights=skin,
                     inverse_bind_pose=inverse_bind_pose, blend_shape=blend,
                     blend_shape_param_index=blend_index,
                     face_expression_blend_shape=face,
                     face_expression_param_index=face_index,
                     collision=_collision(d, device), skinned_locators=skinned,
                     skinned_locator_param_index=skinned_index,
                     physical_properties=_bodies(d, device), name=str(d.get("name", "")),
                     metadata=str(d.get("metadata", "")))


def covariance_from_numpy(d: dict, device="cuda") -> LowRankCovarianceMatrix:
    return LowRankCovarianceMatrix.create(np.float32(d["sigma"]), np.asarray(d["a"]),
                                          device=resolve(device, "covariance_from_numpy"))


def camera_from_numpy(d: dict, device="cuda") -> Camera:
    device = resolve(device, "camera_from_numpy")
    args = [np.float32(d[k]) for k in ("fx", "fy", "cx", "cy")]
    size = (int(d["image_width"]), int(d["image_height"]))
    if "p" in d:
        intr = OpenCVIntrinsics.create(*args, k=np.asarray(d["k"]), p=np.asarray(d["p"]),
                                       image_size=size, device=device)
    elif "k" in d:
        intr = OpenCVFisheyeIntrinsics.create(*args, k=np.asarray(d["k"]), image_size=size,
                                              device=device)
    else:
        intr = PinholeIntrinsics.create(*args, image_size=size, device=device)
    return Camera.create(intr, _t(d, "eye_from_world", device))


def position_error_from_numpy(d: dict, device="cuda") -> PositionErrorFunction:
    device = resolve(device, "position_error_from_numpy")
    return PositionErrorFunction(
        parent=_t(d, "parent", device).to(torch.int32), offset=_t(d, "offset", device),
        target=_t(d, "target", device), cweight=_t(d, "cweight", device),
        weight=_t(d, "weight", device), loss=_loss(d))


def orientation_error_from_numpy(d: dict, device="cuda") -> OrientationErrorFunction:
    device = resolve(device, "orientation_error_from_numpy")
    return OrientationErrorFunction(
        parent=_t(d, "parent", device).to(torch.int32), offset=_t(d, "offset", device),
        target=_t(d, "target", device), cweight=_t(d, "cweight", device),
        weight=_t(d, "weight", device), loss=_loss(d))


def limit_error_from_numpy(d: dict, device="cuda") -> LimitErrorFunction:
    device = resolve(device, "limit_error_from_numpy")
    return LimitErrorFunction(weight=_t(d, "weight", device), loss=_loss(d))


def pose_prior_from_numpy(d: dict, device="cuda") -> PosePriorErrorFunction:
    device = resolve(device, "pose_prior_from_numpy")
    prior = Mppca(mu=_t(d, "mu", device), cinv=_t(d, "cinv", device), l=_t(d, "l", device),
                  rpre=_t(d, "rpre", device))
    return PosePriorErrorFunction(
        prior=prior, weight=_t(d, "weight", device),
        param_index=tuple(int(i) for i in np.asarray(d["param_index"])),
        sub_jtj=_t(d, "sub_jtj", device) if "sub_jtj" in d else None)


def _vertex_error(cls, d, device, entry, tables, statics):
    device = resolve(device, entry)
    return cls(vertex_index=_t(d, "vertex_index", device).to(torch.int32),
               cweight=_t(d, "cweight", device), weight=_t(d, "weight", device),
               loss=_loss(d), **{k: _t(d, k, device) for k in tables},
               **{k: v(d[k]) for k, v in statics.items() if k in d})


def vertex_position_error_from_numpy(d: dict, device="cuda") -> VertexPositionErrorFunction:
    return _vertex_error(VertexPositionErrorFunction, d, device,
                         "vertex_position_error_from_numpy", ("target",), {})


def vertex_plane_error_from_numpy(d: dict, device="cuda") -> VertexPlaneErrorFunction:
    return _vertex_error(VertexPlaneErrorFunction, d, device, "vertex_plane_error_from_numpy",
                         ("point", "normal"), {"above": bool})


def vertex_normal_error_from_numpy(d: dict, device="cuda") -> VertexNormalErrorFunction:
    return _vertex_error(VertexNormalErrorFunction, d, device,
                         "vertex_normal_error_from_numpy", ("target_position", "target_normal"),
                         {"source_normal_weight": float, "target_normal_weight": float})


def vertex_projection_error_from_numpy(d: dict, device="cuda") -> VertexProjectionErrorFunction:
    return _vertex_error(VertexProjectionErrorFunction, d, device,
                         "vertex_projection_error_from_numpy", ("projection", "target"),
                         {"near_clip": float})


def phong_material_from_numpy(d: dict, device="cuda"):
    from momentum_tpu_torch.rasterizer.materials import PhongMaterial

    device = resolve(device, "phong_material_from_numpy")
    return PhongMaterial.create(**{k: np.asarray(d[k]) for k in (
        "diffuse_color", "specular_color", "specular_exponent", "emissive_color")},
        diffuse_texture=d.get("diffuse_texture"), emissive_texture=d.get("emissive_texture"),
        device=device)


def lights_from_numpy(lights, device="cuda") -> tuple:
    from momentum_tpu_torch.rasterizer.materials import Light

    device = resolve(device, "lights_from_numpy")
    return tuple(Light(_t(d, "position", device).float(), _t(d, "color", device).float(),
                       int(d["type"]))
                 for d in lights)


def sdf_from_numpy(d: dict, device="cuda", prefix: str = ""):
    """A SignedDistanceField from origin, spacing and values (under
    `prefix`, "sdf_" inside a module's dict)."""
    from momentum_tpu_torch.axel.sdf import SignedDistanceField

    device = resolve(device, "sdf_from_numpy")
    return SignedDistanceField(**{k: _t(d, prefix + k, device).float()
                                  for k in ("origin", "spacing", "values")})


def triangle_grid_from_numpy(d: dict, device="cuda"):
    from momentum_tpu_torch.axel.grid import TriangleGrid

    device = resolve(device, "triangle_grid_from_numpy")
    return TriangleGrid(cells=_t(d, "cells", device).to(torch.int32),
                        origin=_t(d, "origin", device).float(),
                        cell_size=_t(d, "cell_size", device).float(),
                        resolution=int(d["resolution"]))


def _sdf_error(cls, d, device, entry, **extra):
    device = resolve(device, entry)
    return cls(sdf=sdf_from_numpy(d, device, "sdf_"),
               vertex_index=_t(d, "vertex_index", device).to(torch.int32),
               cweight=_t(d, "cweight", device).float(), weight=_t(d, "weight", device).float(),
               **{k: f(d, device) for k, f in extra.items()})


def vertex_sdf_error_from_numpy(d: dict, device="cuda"):
    from momentum_tpu_torch.errors.sdf import VertexSdfErrorFunction

    return _sdf_error(VertexSdfErrorFunction, d, device, "vertex_sdf_error_from_numpy",
                      target_distance=lambda d, dev: _t(d, "target_distance", dev).float(),
                      sdf_parent=lambda d, dev: int(d["sdf_parent"]),
                      loss=lambda d, dev: _loss(d))


def sdf_collision_error_from_numpy(d: dict, device="cuda"):
    from momentum_tpu_torch.errors.sdf import SdfCollisionErrorFunction

    return _sdf_error(SdfCollisionErrorFunction, d, device, "sdf_collision_error_from_numpy",
                      loss=lambda d, dev: _loss(d))


def sdf_collision_sequence_error_from_numpy(d: dict, device="cuda"):
    from momentum_tpu_torch.sequence.errors import SdfCollisionSequenceErrorFunction

    return _sdf_error(SdfCollisionSequenceErrorFunction, d, device,
                      "sdf_collision_sequence_error_from_numpy")
