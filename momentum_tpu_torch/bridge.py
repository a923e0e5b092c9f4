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
    minmax_index (M,), minmax_bounds (M, 2), minmax_weight (M,),
    minmax_joint_index (MJ,), minmax_joint_bounds (MJ, 2),
    minmax_joint_weight (MJ,), minmax_joint_passive (MJ,),
    optional linear_count, linear_joint_count, halfplane_count,
    ellipsoid_count (): the character's records of the limit types the port
    does not hold; any count above 0 raises NotImplementedError,
    optional locator_parent (L,), locator_offset (L, 3), locator_weight (L,);
    optional mesh_vertices (V, 3), mesh_faces (F, 3) int32, and with them
    optional mesh_normals (V, 3), mesh_texcoords (T, 2),
    mesh_texcoord_faces (F, 3), mesh_colors (V, 3), mesh_lines (a sequence
    of index arrays); skin_index (V, 8), skin_weight (V, 8),
    inverse_bind_pose (nJ, 8);
    optional blend_shape_base (V, 3), blend_shape_vectors (K, V, 3),
    blend_shape_param_index (K,) and the same three for
    face_expression_{base,vectors,param_index}
camera_from_numpy keys (a pinhole Camera):
    fx, fy, cx, cy (), image_width, image_height (), eye_from_world (8,)
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

Every function builds on `device`, the card unless the caller asks for the
CPU, and raises on a machine without one.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.camera import Camera, PinholeIntrinsics
from momentum_tpu_torch.character import (
    BlendShape, Character, Locators, Mesh, ParameterLimits, ParameterTransform, Skeleton,
    SkinWeights)
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors import (
    LimitErrorFunction, Mppca, OrientationErrorFunction, PosePriorErrorFunction,
    PositionErrorFunction, VertexNormalErrorFunction, VertexPlaneErrorFunction,
    VertexPositionErrorFunction, VertexProjectionErrorFunction)
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["character_from_numpy", "camera_from_numpy", "position_error_from_numpy",
           "orientation_error_from_numpy", "limit_error_from_numpy",
           "pose_prior_from_numpy", "vertex_position_error_from_numpy",
           "vertex_plane_error_from_numpy", "vertex_normal_error_from_numpy",
           "vertex_projection_error_from_numpy"]

_LIMIT_KEYS = ("minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
               "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive")
# limit record types the port's ParameterLimits does not hold (ROADMAP M3)
_UNPORTED_LIMITS = ("linear", "linear_joint", "halfplane", "ellipsoid")


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


def character_from_numpy(d: dict, device="cuda") -> Character:
    held = {k: int(d.get(f"{k}_count", 0)) for k in _UNPORTED_LIMITS}
    if any(held.values()):
        raise NotImplementedError(
            f"the character holds limit records the port does not carry yet: {held}")
    device = resolve(device, "character_from_numpy")
    skeleton = Skeleton(joint_parent=_t(d, "joint_parent", device).to(torch.int32),
                        pre_rotation=_t(d, "pre_rotation", device),
                        translation_offset=_t(d, "translation_offset", device))
    pt = ParameterTransform(
        transform=_t(d, "transform", device), offsets=_t(d, "offsets", device),
        names=tuple(str(n) for n in d.get("parameter_names", ())),
        parameter_sets={k: tuple(int(i) for i in np.asarray(v))
                        for k, v in d.get("parameter_sets", {}).items()})
    limits = ParameterLimits(**{k: _t(d, k, device) for k in _LIMIT_KEYS})
    locators = None
    if "locator_parent" in d:
        locators = Locators(parent=_t(d, "locator_parent", device).to(torch.int32),
                            offset=_t(d, "locator_offset", device),
                            weight=_t(d, "locator_weight", device))
    mesh = skin = inverse_bind_pose = None
    if "mesh_vertices" in d:
        mesh = Mesh(vertices=_t(d, "mesh_vertices", device),
                    faces=_t(d, "mesh_faces", device).to(torch.int32),
                    normals=_opt(d, "mesh_normals", device),
                    texcoords=_opt(d, "mesh_texcoords", device),
                    texcoord_faces=_opt(d, "mesh_texcoord_faces", device),
                    colors=_opt(d, "mesh_colors", device),
                    lines=tuple(torch.as_tensor(np.array(line), device=device)
                                for line in d.get("mesh_lines", ())))
    if "skin_index" in d:
        skin = SkinWeights(index=_t(d, "skin_index", device).to(torch.int32),
                           weight=_t(d, "skin_weight", device))
    if "inverse_bind_pose" in d:
        inverse_bind_pose = _t(d, "inverse_bind_pose", device)
    blend, blend_index = _basis(d, "blend_shape", device)
    face, face_index = _basis(d, "face_expression", device)
    return Character(skeleton=skeleton, parameter_transform=pt, limits=limits,
                     locators=locators, mesh=mesh, skin_weights=skin,
                     inverse_bind_pose=inverse_bind_pose, blend_shape=blend,
                     blend_shape_param_index=blend_index,
                     face_expression_blend_shape=face,
                     face_expression_param_index=face_index)


def camera_from_numpy(d: dict, device="cuda") -> Camera:
    device = resolve(device, "camera_from_numpy")
    intr = PinholeIntrinsics.create(
        *(np.float32(d[k]) for k in ("fx", "fy", "cx", "cy")),
        image_size=(int(d["image_width"]), int(d["image_height"])), device=device)
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
