"""Character surgery, after momentum_tpu/character/utility.py
(character_utility.{h,cpp}, character.h's member operations,
skeleton_utility.h): operations done once at load time on the host, in
numpy as in JAX. Each returns a new Character whose tensors lie on the
device of the character it was given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character.blend_shape import BlendShape
from momentum_tpu_torch.character.character import (
    Character, CollisionGeometry, Locators, Mesh, PhysicalProperties)
from momentum_tpu_torch.character.limits import (
    concat_limits, map_limits, remap_limits_model_parameters)
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT, make_skeleton
from momentum_tpu_torch.character.skinning import SkinWeights
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = ["simplify", "simplify_skeleton", "simplify_parameter_transform", "scale_character",
           "reduce_mesh_by_vertices", "reduce_mesh_by_faces", "transform_character",
           "remove_joints", "parameters_to_active_joints", "active_joints_to_parameters",
           "subset_parameter_transform", "map_parameter_transform_joints", "split_parameters",
           "bake_blend_shape", "add_blend_shape_parameters", "add_face_expression_parameters",
           "add_skinned_locator_parameters", "skinned_locator_rest_offsets",
           "resample_motion", "extrapolate_model_parameters", "add_rigid_transform_node",
           "replace_skeleton_hierarchy", "vertices_to_faces", "faces_to_vertices",
           "scale_physical_properties"]

INVALID_INDEX = -1


def _extend(character: Character, k: int, prefix: str):
    """(parameter transform with k zero columns named prefix_i appended,
    the new columns' indices)."""
    pt = character.parameter_transform
    old_p = pt.num_model_parameters
    tf = torch.cat([pt.transform, pt.transform.new_zeros(pt.transform.shape[0], k)], dim=1)
    names = pt.names + tuple(f"{prefix}_{i}" for i in range(k))
    return (ParameterTransform(transform=tf, offsets=pt.offsets, names=names,
                               parameter_sets=pt.parameter_sets),
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


def add_skinned_locator_parameters(character: Character, active_locators=None) -> Character:
    """The rig with 3 model parameters (the x/y/z rest offset) appended per
    active skinned locator (parameter_transform.h:222-226
    addSkinnedLocatorParameters), named `<locator>_t{x,y,z}`; the (L, 3)
    parameter table, flattened, goes to skinned_locator_param_index (-1
    where a locator is inactive)."""
    sl = character.skinned_locators
    if sl is None:
        raise ValueError("character has no skinned locators")
    n = sl.num_locators
    active = np.ones(n, bool) if active_locators is None else np.asarray(active_locators, bool)
    pt = character.parameter_transform
    old_p = pt.num_model_parameters
    k = int(active.sum()) * 3
    tf = torch.cat([pt.transform, pt.transform.new_zeros(pt.transform.shape[0], k)], dim=1)
    names = list(pt.names)
    index = np.full(n * 3, -1, np.int64)
    nxt = old_p
    for i in np.nonzero(active)[0]:
        nm = sl.names[i] if i < len(sl.names) else f"skinned_locator_{i}"
        for a, ax in enumerate("xyz"):
            names.append(f"{nm}_t{ax}")
            index[i * 3 + a] = nxt
            nxt += 1
    pt2 = ParameterTransform(transform=tf, offsets=pt.offsets, names=tuple(names),
                             parameter_sets=pt.parameter_sets)
    return dataclasses.replace(character, parameter_transform=pt2,
                               skinned_locator_param_index=tuple(int(x) for x in index))


def skinned_locator_rest_offsets(character: Character, model_params: torch.Tensor) -> torch.Tensor:
    """(..., L, 3) rest offsets read from the model parameters (..., P),
    zero where a locator has none."""
    idx = torch.as_tensor(character.skinned_locator_param_index, dtype=torch.int64,
                          device=model_params.device)
    gathered = model_params.index_select(-1, torch.clamp(idx, min=0))
    offsets = torch.where(idx >= 0, gathered, 0.0)
    return offsets.reshape(model_params.shape[:-1] + (character.skinned_locators.num_locators, 3))



def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(arr, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """numpy `arr` as a tensor on `like`'s device, in `dtype` (like's by default)."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=like.dtype if dtype is None else dtype,
                           device=like.device)


def _rows(t, keep):
    """The rows `keep` (a bool or index array) of an optional tensor."""
    return None if t is None else _on(_np(t)[keep], t)


def scale_physical_properties(physical_properties, length_scale: float,
                              mass_scale: str = "preserve_mass"):
    """Bodies scaled by a length scale (character_utility.cpp:105-130):
    centre-of-mass offsets × s; "preserve_mass": mass × 1, inertia × s²;
    "preserve_density": mass × s³, inertia × s⁵ (character_utility.h:41-42)."""
    if physical_properties is None:
        return None
    if mass_scale == "preserve_mass":
        m = 1.0
    elif mass_scale == "preserve_density":
        m = length_scale ** 3
    else:
        raise ValueError(f"unknown mass-scale policy: {mass_scale!r}")
    pp = physical_properties
    return dataclasses.replace(pp, center_of_mass_offset=pp.center_of_mass_offset * length_scale,
                               mass=pp.mass * m,
                               inertia=pp.inertia * (m * length_scale * length_scale))


def scale_character(character: Character, scale: float,
                    mass_scale: str = "preserve_mass") -> Character:
    """A uniformly scaled character (character_utility.cpp scaleCharacter):
    translation offsets, locator offsets (with their limit origins and skin
    offsets), the mesh, the collision geometry, the bodies by `mass_scale`,
    and of the limits only the ellipsoid records (their frames'
    translations and point offsets, character_utility.cpp:69-80; MinMax and
    linear records are on model parameters and stay, as in the reference)."""
    skel = character.skeleton
    out = dataclasses.replace(character, skeleton=dataclasses.replace(
        skel, translation_offset=skel.translation_offset * scale))
    if character.mesh is not None:
        out = dataclasses.replace(out, mesh=dataclasses.replace(
            character.mesh, vertices=character.mesh.vertices * scale))
    if character.locators is not None:
        loc = character.locators
        out = dataclasses.replace(out, locators=dataclasses.replace(
            loc, offset=loc.offset * scale,
            limit_origin=None if loc.limit_origin is None else loc.limit_origin * scale,
            skin_offset=None if loc.skin_offset is None else loc.skin_offset * scale))
    if character.collision is not None:
        col = character.collision
        tf = col.transform.clone()
        tf[..., 0:3] *= scale
        out = dataclasses.replace(out, collision=dataclasses.replace(
            col, transform=tf, radius=col.radius * scale, length=col.length * scale))
    if character.physical_properties is not None:
        out = dataclasses.replace(out, physical_properties=scale_physical_properties(
            character.physical_properties, scale, mass_scale))
    lim = character.limits
    if lim is not None and lim.ellipsoid_parent.shape[0] > 0:
        e_mat, e_inv = lim.ellipsoid_mat.clone(), lim.ellipsoid_inv.clone()
        e_mat[:, :3, 3] *= scale
        e_inv[:, :3, 3] *= scale
        out = dataclasses.replace(out, limits=dataclasses.replace(
            lim, ellipsoid_mat=e_mat, ellipsoid_inv=e_inv,
            ellipsoid_point_offset=lim.ellipsoid_point_offset * scale))
    return dataclasses.replace(out, inverse_bind_pose=None).with_inverse_bind_pose()


def transform_character(character: Character, xform: torch.Tensor) -> Character:
    """The rest configuration moved by an (8,) skel_state (character_utility.cpp
    transformCharacter): only the root joints' offsets and pre-rotations
    change."""
    skel = character.skeleton
    roots = torch.as_tensor(np.nonzero(skel.parents_np == INVALID_INDEX)[0],
                            device=skel.translation_offset.device)
    xform = xform.to(skel.translation_offset.device)
    offs = skel.translation_offset.clone()
    pre = skel.pre_rotation.clone()
    offs[roots] = ss.transform_points(xform, offs[roots])
    pre[roots] = quat.multiply(xform[3:7], pre[roots])
    out = dataclasses.replace(character, skeleton=dataclasses.replace(
        skel, translation_offset=offs, pre_rotation=pre), inverse_bind_pose=None)
    return out.with_inverse_bind_pose()


def parameters_to_active_joints(pt: ParameterTransform, enabled) -> np.ndarray:
    """bool (nJ,): the joints driven by any enabled model parameter
    (character.h parametersToActiveJoints)."""
    pattern = np.abs(_np(pt.transform)) > 0
    active_jp = pattern[:, np.asarray(enabled, bool)].any(axis=1)
    return active_jp.reshape(-1, PARAMS_PER_JOINT).any(axis=1)


def active_joints_to_parameters(pt: ParameterTransform, active_joints) -> np.ndarray:
    """bool (P,): the model parameters that touch any active joint
    (character.h activeJointsToParameters)."""
    pattern = np.abs(_np(pt.transform)) > 0
    return pattern[np.repeat(np.asarray(active_joints, bool), PARAMS_PER_JOINT), :].any(axis=0)


def subset_parameter_transform(pt: ParameterTransform, keep) -> ParameterTransform:
    """The transform with only the `keep` model parameters, its parameter
    sets renumbered (parameter_transform.h subsetParameterTransform); the
    pose constraints are dropped, as momentum_tpu's are."""
    idx = np.nonzero(np.asarray(keep, bool))[0]
    kept = set(idx.tolist())
    return ParameterTransform(
        transform=pt.transform.index_select(1, torch.as_tensor(idx, device=pt.transform.device)),
        offsets=pt.offsets, names=tuple(pt.names[i] for i in idx),
        parameter_sets={k: tuple(int(np.searchsorted(idx, i)) for i in v if i in kept)
                        for k, v in pt.parameter_sets.items()})


def _bodies(pp: PhysicalProperties, keep: np.ndarray, joint_index: np.ndarray):
    """The bodies `keep`, re-pointed at `joint_index` (of the kept ones)."""
    return PhysicalProperties(
        joint_index=_on(joint_index, pp.joint_index, torch.int32),
        mass=_rows(pp.mass, keep), center_of_mass_offset=_rows(pp.center_of_mass_offset, keep),
        inertia=_rows(pp.inertia, keep), inertia_rotation=_rows(pp.inertia_rotation, keep),
        joint_names=tuple(n for n, k in zip(pp.joint_names, keep) if k) if pp.joint_names
        else ())


def _filter_locators(loc: Locators, keep: np.ndarray, parent=None) -> Locators:
    """The locators `keep` (bool), their parents replaced by `parent` (of the
    kept ones) if given."""
    parent = _np(loc.parent)[keep] if parent is None else parent
    return Locators(parent=_on(parent, loc.parent, torch.int32),
                    offset=_rows(loc.offset, keep), weight=_rows(loc.weight, keep),
                    names=tuple(n for n, k in zip(loc.names, keep) if k),
                    locked=_rows(loc.locked, keep), limit_weight=_rows(loc.limit_weight, keep),
                    limit_origin=_rows(loc.limit_origin, keep),
                    attached_to_skin=_rows(loc.attached_to_skin, keep),
                    skin_offset=_rows(loc.skin_offset, keep))


def _map_locators(loc, joint_map: np.ndarray):
    """The locators with their parents sent through an old → new joint map,
    those whose parent maps to INVALID_INDEX dropped
    (character_utility.cpp:173-191 mapParents)."""
    if loc is None:
        return None
    mapped = joint_map[_np(loc.parent)]
    keep = mapped != INVALID_INDEX
    return _filter_locators(loc, keep, mapped[keep])


def remove_joints(character: Character, joints_to_remove) -> Character:
    """The rig without the given joints (names or indices) and their
    subtrees (character_utility.cpp removeJoints): the parameter transform
    loses the removed joints' rows and the parameters that then drive
    nothing (its parameter sets are dropped, as JAX's are), bodies and
    locators on removed joints go and the rest are re-pointed
    (mapPhysicalProperties, character_utility.cpp:143-170), the mesh stays
    with each skin influence re-pointed at its nearest kept ancestor, and
    the inverse bind pose is recomputed; the skinned locators and the
    limits stay as they are, as in JAX."""
    skel = character.skeleton
    device = skel.joint_parent.device
    parents = skel.parents_np
    n = len(parents)
    remove = np.zeros(n, bool)
    remove[[skel.joint_names.index(j) if isinstance(j, str) else int(j)
            for j in joints_to_remove]] = True
    for j in range(n):  # parents come before their children
        if parents[j] != INVALID_INDEX and remove[parents[j]]:
            remove[j] = True
    keep_idx = np.nonzero(~remove)[0]
    old_to_new = np.full(n, INVALID_INDEX, np.int64)
    old_to_new[keep_idx] = np.arange(len(keep_idx))
    new_parents = [int(old_to_new[parents[j]]) if parents[j] != INVALID_INDEX else INVALID_INDEX
                   for j in keep_idx]
    new_skel = make_skeleton(new_parents, pre_rotations=_np(skel.pre_rotation)[keep_idx],
                             translation_offsets=_np(skel.translation_offset)[keep_idx],
                             names=[skel.joint_names[i] for i in keep_idx],
                             dtype=skel.pre_rotation.dtype, device=device)

    pt = character.parameter_transform
    rows = torch.as_tensor(np.nonzero(np.repeat(~remove, PARAMS_PER_JOINT))[0], device=device)
    tf2 = pt.transform.index_select(0, rows)
    col_keep = np.nonzero((tf2.abs() > 0).any(dim=0).cpu().numpy())[0]
    pt2 = ParameterTransform(transform=tf2.index_select(1, torch.as_tensor(col_keep,
                                                                          device=device)),
                             offsets=pt.offsets.index_select(0, rows),
                             names=tuple(pt.names[i] for i in col_keep))
    out = dataclasses.replace(character, skeleton=new_skel, parameter_transform=pt2,
                              inverse_bind_pose=None, mesh=None, skin_weights=None,
                              blend_shape=None, collision=None,
                              locators=_map_locators(character.locators, old_to_new))
    if character.physical_properties is not None:
        pp = character.physical_properties
        pj = _np(pp.joint_index)
        pkeep = ~remove[pj]
        out = dataclasses.replace(out, physical_properties=_bodies(
            pp, pkeep, old_to_new[pj[pkeep]]) if pkeep.any() else None)
    if character.mesh is not None and character.skin_weights is not None:
        remap = np.empty(n, np.int64)
        for j in range(n):
            a = j
            while a != INVALID_INDEX and remove[a]:
                a = parents[a]
            remap[j] = old_to_new[a] if a != INVALID_INDEX else 0
        si = _np(character.skin_weights.index)
        out = dataclasses.replace(out, mesh=character.mesh, skin_weights=SkinWeights(
            index=_on(remap[si], character.skin_weights.index, torch.int32),
            weight=character.skin_weights.weight.clone()))
    return out.with_inverse_bind_pose()


def split_parameters(pt: ParameterTransform, params: torch.Tensor, mask) -> torch.Tensor:
    """The parameters outside `mask` zeroed (character.h splitParameters)."""
    return params * torch.as_tensor(np.asarray(mask, np.float32), device=params.device)


def bake_blend_shape(character: Character, coefficients: torch.Tensor) -> Character:
    """The blend shape at `coefficients` baked into the rest mesh, the basis
    and its parameter index dropped (character.h bake)."""
    if character.blend_shape is None or character.mesh is None:
        return character
    baked = character.blend_shape.apply(coefficients)
    return dataclasses.replace(character,
                               mesh=dataclasses.replace(character.mesh, vertices=baked),
                               blend_shape=None, blend_shape_param_index=None)


def resample_motion(poses, src_fps: float, dst_fps: float) -> np.ndarray:
    """A (F, P) pose track resampled linearly from src_fps to dst_fps (numpy;
    skeleton_utility.h's MotionParameters resampling)."""
    poses = _np(poses)
    f = poses.shape[0]
    if f < 2 or src_fps == dst_fps:
        return poses.copy()
    n_out = int(np.floor((f - 1) / src_fps * dst_fps)) + 1
    t_out = np.arange(n_out) / dst_fps * src_fps
    i0 = np.clip(np.floor(t_out).astype(np.int64), 0, f - 2)
    frac = (t_out - i0)[:, None]
    return poses[i0] * (1 - frac) + poses[i0 + 1] * frac


def extrapolate_model_parameters(previous, current, active=None, factor: float = 0.8,
                                 max_delta: float = 0.4):
    """The next pose predicted from two (skeleton_utility.h:22-38
    extrapolateModelParameters): current + factor · clamp(current − previous,
    ±max_delta); inactive parameters (an `active` mask) stay at current, and
    a size mismatch returns current. Batched over leading dims."""
    previous = torch.as_tensor(previous)
    current = torch.as_tensor(current)
    if previous.shape != current.shape:
        return current
    out = current + factor * torch.clamp(current - previous, -max_delta, max_delta)
    if active is not None:
        out = torch.where(torch.as_tensor(np.asarray(active, bool), device=current.device),
                          out, current)
    return out


def simplify_parameter_transform(character: Character, keep) -> Character:
    """Only the model parameters `keep` (P,) bool kept, the limits remapped
    (character.h:149 simplifyParameterTransform)."""
    keep = np.asarray(keep, bool)
    if not keep.any():
        raise ValueError("no active parameters to keep")
    return dataclasses.replace(
        character, parameter_transform=subset_parameter_transform(
            character.parameter_transform, keep),
        limits=remap_limits_model_parameters(character.limits, keep))


def simplify_skeleton(character: Character, active_joints) -> Character:
    """The inactive joints dropped and everything on them remapped
    (character.h:143 simplifySkeleton); an inactive joint with an active
    descendant stays."""
    active = np.asarray(active_joints, bool).copy()
    parents = character.skeleton.parents_np
    for j in range(len(parents) - 1, -1, -1):  # close over ancestors
        if active[j] and parents[j] >= 0:
            active[parents[j]] = True
    remove = [character.skeleton.joint_names[j] for j in range(len(parents)) if not active[j]]
    if not remove:
        return character
    return remove_joints(character, remove)


def simplify(character: Character, enabled_params=None) -> Character:
    """parametersToActiveJoints, then simplifySkeleton, the root always kept
    (character.cpp:553-563 Character::simplify)."""
    p = character.num_model_parameters
    enabled = np.ones(p, bool) if enabled_params is None else np.asarray(enabled_params, bool)
    active = parameters_to_active_joints(character.parameter_transform, enabled)
    active[0] = True
    return simplify_skeleton(character, active)


def reduce_mesh_by_vertices(character: Character, active_vertices) -> Character:
    """Only the selected vertices kept, with the faces wholly inside the
    selection (character_utility.h:104-125 reduceMeshByVertices): faces,
    skin weights, blend shapes and per-vertex attributes remapped."""
    mesh = character.mesh
    if mesh is None:
        return character
    active = np.asarray(active_vertices, bool)
    v = mesh.num_vertices
    if active.shape[0] != v:
        raise ValueError(f"active_vertices has {active.shape[0]} entries for a {v}-vertex mesh")
    keep_idx = np.nonzero(active)[0]
    old_to_new = np.full(v, -1, np.int64)
    old_to_new[keep_idx] = np.arange(len(keep_idx))
    faces = _np(mesh.faces)
    fkeep = active[faces].all(axis=1)
    per_face_uv = mesh.texcoord_faces is not None
    new_mesh = dataclasses.replace(
        mesh, vertices=_rows(mesh.vertices, keep_idx),
        faces=_on(old_to_new[faces[fkeep]], mesh.faces, torch.int32),
        normals=_rows(mesh.normals, keep_idx), colors=_rows(mesh.colors, keep_idx),
        confidence=_rows(mesh.confidence, keep_idx),
        texcoords=mesh.texcoords if per_face_uv else _rows(mesh.texcoords, keep_idx),
        texcoord_faces=_rows(mesh.texcoord_faces, fkeep) if per_face_uv else None)
    out = dataclasses.replace(character, mesh=new_mesh)
    if character.skin_weights is not None:
        sw = character.skin_weights
        out = dataclasses.replace(out, skin_weights=SkinWeights(
            index=_rows(sw.index, keep_idx), weight=_rows(sw.weight, keep_idx)))
    if character.blend_shape is not None:
        bs = character.blend_shape
        out = dataclasses.replace(out, blend_shape=BlendShape(
            base_shape=_rows(bs.base_shape, keep_idx),
            shape_vectors=_on(_np(bs.shape_vectors)[:, keep_idx], bs.shape_vectors)))
    return out


def reduce_mesh_by_faces(character: Character, active_faces) -> Character:
    """Only the selected faces kept, with the vertices they use
    (character_utility.h:108-113 reduceMeshByFaces)."""
    mesh = character.mesh
    if mesh is None:
        return character
    active = np.asarray(active_faces, bool)
    faces = _np(mesh.faces)
    if active.shape[0] != faces.shape[0]:
        raise ValueError("active_faces size mismatch")
    used = np.zeros(mesh.num_vertices, bool)
    used[faces[active].ravel()] = True
    # the faces masked first: the vertex reducer keeps every face whose three
    # vertices survive, a superset of `active` where faces share vertices
    masked = dataclasses.replace(character, mesh=dataclasses.replace(
        mesh, faces=_rows(mesh.faces, active),
        texcoord_faces=_rows(mesh.texcoord_faces, active)))
    return reduce_mesh_by_vertices(masked, used)


def map_parameter_transform_joints(pt: ParameterTransform, num_target_joints: int,
                                   joint_mapping) -> ParameterTransform:
    """The transform re-targeted onto another joint order
    (parameter_transform.h:202-205 mapParameterTransformJoints):
    joint_mapping[src joint] = target joint, or -1 to drop its rows. The
    columns stay."""
    mapping = np.asarray(joint_mapping, np.int64)
    tf, offs = _np(pt.transform), _np(pt.offsets)
    if tf.shape[0] != mapping.shape[0] * PARAMS_PER_JOINT:
        raise ValueError("joint_mapping does not match the transform rows")
    out_tf = np.zeros((num_target_joints * PARAMS_PER_JOINT, tf.shape[1]), tf.dtype)
    out_off = np.zeros(num_target_joints * PARAMS_PER_JOINT, offs.dtype)
    for sj, tj in enumerate(mapping):
        if tj < 0:
            continue
        if tj >= num_target_joints:
            raise ValueError(f"mapping[{sj}]={tj} out of range")
        s0, t0 = sj * PARAMS_PER_JOINT, tj * PARAMS_PER_JOINT
        out_tf[t0:t0 + PARAMS_PER_JOINT] = tf[s0:s0 + PARAMS_PER_JOINT]
        out_off[t0:t0 + PARAMS_PER_JOINT] = offs[s0:s0 + PARAMS_PER_JOINT]
    return ParameterTransform(transform=_on(out_tf, pt.transform),
                              offsets=_on(out_off, pt.offsets), names=pt.names,
                              parameter_sets=pt.parameter_sets)


def add_rigid_transform_node(character: Character, name: str,
                             translation_offset=(0.0, 0.0, 0.0),
                             pre_rotation=(0.0, 0.0, 0.0, 1.0)):
    """A new root joint with six rigid parameters {name}_tx … {name}_rz
    mapped one to one onto its translation and rotation
    (character_utility.cpp:862-940 addRigidTransformNode) →
    (character, the joint's index, the first parameter's index)."""
    skel = character.skeleton
    bone = skel.num_joints
    new_skel = make_skeleton(
        skel.parents_np.tolist() + [INVALID_INDEX],
        np.concatenate([_np(skel.pre_rotation), np.asarray(pre_rotation, np.float32)[None]]),
        np.concatenate([_np(skel.translation_offset),
                        np.asarray(translation_offset, np.float32)[None]]),
        tuple(skel.joint_names) + (name,), dtype=skel.pre_rotation.dtype,
        device=skel.joint_parent.device)
    pt = character.parameter_transform
    rows, cols = pt.transform.shape
    mat = np.zeros((rows + PARAMS_PER_JOINT, cols + 6), np.float32)
    mat[:rows, :cols] = _np(pt.transform)
    for k in range(6):
        mat[bone * PARAMS_PER_JOINT + k, cols + k] = 1.0
    offsets = np.zeros(rows + PARAMS_PER_JOINT, np.float32)
    offsets[:rows] = _np(pt.offsets)
    new_pt = ParameterTransform(
        transform=_on(mat, pt.transform), offsets=_on(offsets, pt.offsets),
        names=pt.names + tuple(f"{name}_{s}" for s in ("tx", "ty", "tz", "rx", "ry", "rz")),
        parameter_sets=pt.parameter_sets, pose_constraints=pt.pose_constraints)
    out = dataclasses.replace(character, skeleton=new_skel, parameter_transform=new_pt,
                              inverse_bind_pose=None)
    return out.with_inverse_bind_pose(), bone, cols


def _concat_optional(a, b, na: int, nb: int, tail: tuple, like: torch.Tensor, dtype):
    """Two optional per-row tensors concatenated, a missing side zeros."""
    if a is None and b is None:
        return None
    xa = np.zeros((na,) + tail, np.float32) if a is None else _np(a)
    xb = np.zeros((nb,) + tail, np.float32) if b is None else _np(b)
    return _on(np.concatenate([xa, xb], axis=0), like, dtype)


def _concat_locators(a, b):
    if a is None or a.num_locators == 0:
        return b
    if b is None or b.num_locators == 0:
        return a
    na, nb = a.num_locators, b.num_locators
    f32 = a.offset.dtype

    def opt(field, tail):
        return _concat_optional(getattr(a, field), getattr(b, field), na, nb, tail,
                                a.offset, f32)

    return Locators(parent=torch.cat([a.parent, b.parent]), offset=torch.cat([a.offset, b.offset]),
                    weight=torch.cat([a.weight, b.weight]), names=tuple(a.names) + tuple(b.names),
                    locked=opt("locked", (3,)), limit_weight=opt("limit_weight", (3,)),
                    limit_origin=opt("limit_origin", (3,)),
                    attached_to_skin=opt("attached_to_skin", ()),
                    skin_offset=opt("skin_offset", (3,)))


def _map_collision(col, jmap: np.ndarray):
    if col is None:
        return None
    mapped = jmap[_np(col.parent)]
    keep = mapped >= 0
    if not keep.any():
        return None
    return CollisionGeometry(parent=_on(mapped[keep], col.parent, torch.int32),
                             transform=_rows(col.transform, keep), radius=_rows(col.radius, keep),
                             length=_rows(col.length, keep), ptype=_rows(col.ptype, keep),
                             ellipsoid_radii=_rows(col.ellipsoid_radii, keep),
                             box_half_extents=_rows(col.box_half_extents, keep))


def _concat_collision(a, b):
    if a is None:
        return b
    if b is None:
        return a
    na, nb = a.num_capsules, b.num_capsules
    return CollisionGeometry(
        parent=torch.cat([a.parent, b.parent]), transform=torch.cat([a.transform, b.transform]),
        radius=torch.cat([a.radius, b.radius]), length=torch.cat([a.length, b.length]),
        ptype=_concat_optional(a.ptype, b.ptype, na, nb, (), a.parent, torch.int32),
        ellipsoid_radii=_concat_optional(a.ellipsoid_radii, b.ellipsoid_radii, na, nb, (3,),
                                         a.radius, a.radius.dtype),
        box_half_extents=_concat_optional(a.box_half_extents, b.box_half_extents, na, nb, (3,),
                                          a.radius, a.radius.dtype))


def _strict_descendants(parents: np.ndarray, root: int) -> np.ndarray:
    d = np.zeros(len(parents), bool)
    d[root] = True
    for j in range(len(parents)):  # parents come before their children
        if parents[j] != INVALID_INDEX and d[parents[j]]:
            d[j] = True
    d[root] = False
    return d


def replace_skeleton_hierarchy(src_character: Character, tgt_character: Character,
                               src_root: str, tgt_root: str) -> Character:
    """`tgt_character` with the part of its skeleton under `tgt_root`
    replaced by the part of `src_character`'s under `src_root`
    (character_utility.cpp:572-758 replaceSkeletonHierarchy), as
    momentum_tpu's:

      * the joints: the target's outside tgt_root's subtree, with the
        source's strictly under src_root spliced in right after tgt_root
        (their parents by name; src_root's children hang from tgt_root);
      * the model parameters that drive a surviving joint, merged by name
        (a duplicate raises), offsets zero; the limits remapped per record
        type and concatenated;
      * locators, collision geometry and bodies remapped through the joint
        maps, a duplicate locator (by name) or body (by joint) taken from
        the source;
      * the target's mesh and blend shapes, each skin influence re-pointed
        at its joint if it survived, else its nearest ancestor whose name
        did.
    The result lies on the target's device."""
    src_skel, tgt_skel = src_character.skeleton, tgt_character.skeleton
    device = tgt_skel.joint_parent.device
    s_names, t_names = list(src_skel.joint_names), list(tgt_skel.joint_names)
    if src_root not in s_names:
        raise ValueError(f"source root joint '{src_root}' not found")
    if tgt_root not in t_names:
        raise ValueError(f"target root joint '{tgt_root}' not found")
    src_root_i, tgt_root_i = s_names.index(src_root), t_names.index(tgt_root)
    s_par, t_par = src_skel.parents_np, tgt_skel.parents_np
    s_desc = _strict_descendants(s_par, src_root_i)
    t_desc = _strict_descendants(t_par, tgt_root_i)
    s_pre, s_off = _np(src_skel.pre_rotation), _np(src_skel.translation_offset)
    t_pre, t_off = _np(tgt_skel.pre_rotation), _np(tgt_skel.translation_offset)

    comb_names, comb_parent, comb_pre, comb_off = [], [], [], []
    name_to_comb: dict = {}
    src_to_comb = np.full(len(s_par), INVALID_INDEX, np.int64)
    tgt_to_comb = np.full(len(t_par), INVALID_INDEX, np.int64)

    def add(names, parents, pre, off, j, mapping, fallback_parent=None):
        nm = names[j]
        if nm in name_to_comb:
            raise ValueError(f"duplicate joint '{nm}' while reparenting")
        mapping[j] = name_to_comb[nm] = len(comb_names)
        p = parents[j]
        if p == INVALID_INDEX:
            cp = INVALID_INDEX
        elif names[p] in name_to_comb:
            cp = name_to_comb[names[p]]
        elif fallback_parent is not None:
            cp = fallback_parent  # src_root's children hang from tgt_root
        else:
            raise ValueError(f"parent '{names[p]}' of joint '{nm}' not in combined skeleton")
        comb_names.append(nm)
        comb_parent.append(cp)
        comb_pre.append(pre[j])
        comb_off.append(off[j])

    for i in range(len(t_par)):
        if i == tgt_root_i:
            add(t_names, t_par, t_pre, t_off, i, tgt_to_comb)
            root_ci = name_to_comb[tgt_root]
            for k in range(src_root_i + 1, len(s_par)):
                if s_desc[k]:
                    add(s_names, s_par, s_pre, s_off, k, src_to_comb, fallback_parent=root_ci)
        elif not t_desc[i]:
            add(t_names, t_par, t_pre, t_off, i, tgt_to_comb)
    comb_skel = make_skeleton(comb_parent, pre_rotations=np.asarray(comb_pre),
                              translation_offsets=np.asarray(comb_off), names=comb_names,
                              device=device)
    n_comb = len(comb_names)

    # the merged parameter transform (character_utility.cpp:293-360 addMappedParameters)
    cols, names = [], []

    def add_mapped(pt: ParameterTransform, jmap: np.ndarray) -> np.ndarray:
        tf = _np(pt.transform)
        valid = np.zeros(tf.shape[1], bool)
        for j, cj in enumerate(jmap):
            if cj >= 0:
                valid |= (np.abs(tf[j * PARAMS_PER_JOINT:(j + 1) * PARAMS_PER_JOINT]) > 0).any(0)
        pmap = np.full(tf.shape[1], INVALID_INDEX, np.int64)
        existing = set(names)
        for p in np.nonzero(valid)[0]:
            nm = pt.names[p]
            if nm in existing:
                raise ValueError(f"duplicate parameter '{nm}' while merging transforms")
            col = np.zeros(n_comb * PARAMS_PER_JOINT, np.float32)
            for j, cj in enumerate(jmap):
                if cj >= 0:
                    col[cj * PARAMS_PER_JOINT:(cj + 1) * PARAMS_PER_JOINT] = \
                        tf[j * PARAMS_PER_JOINT:(j + 1) * PARAMS_PER_JOINT, p]
            pmap[p] = len(names)
            names.append(nm)
            cols.append(col)
        return pmap

    tgt_pmap = add_mapped(tgt_character.parameter_transform, tgt_to_comb)
    src_pmap = add_mapped(src_character.parameter_transform, src_to_comb)
    tf = np.stack(cols, axis=1) if cols else np.zeros((n_comb * PARAMS_PER_JOINT, 0), np.float32)
    comb_pt = ParameterTransform(
        transform=torch.as_tensor(tf, dtype=torch.float32, device=device),
        offsets=torch.zeros(n_comb * PARAMS_PER_JOINT, dtype=torch.float32, device=device),
        names=tuple(names))
    comb_limits = concat_limits(map_limits(tgt_character.limits, tgt_to_comb, tgt_pmap),
                                map_limits(src_character.limits, src_to_comb, src_pmap))

    # locators: duplicates by name taken from the source (character_utility.cpp:644-655)
    src_loc = _map_locators(src_character.locators, src_to_comb)
    tgt_loc = _map_locators(tgt_character.locators, tgt_to_comb)
    if tgt_loc is not None and src_loc is not None:
        src_set = set(src_loc.names)
        tgt_loc = _filter_locators(tgt_loc, np.asarray([nm not in src_set
                                                        for nm in tgt_loc.names], bool))
    comb_loc = _concat_locators(tgt_loc, src_loc)
    comb_col = _concat_collision(_map_collision(tgt_character.collision, tgt_to_comb),
                                 _map_collision(src_character.collision, src_to_comb))

    # skinning (character_utility.cpp:691-717 tgtToCombinedWithParents)
    comb_skin = None
    if tgt_character.mesh is not None and tgt_character.skin_weights is not None:
        walk = np.zeros(len(t_par), np.int64)
        for j in range(len(t_par)):
            a = j
            while a != INVALID_INDEX and t_names[a] not in name_to_comb:
                a = t_par[a]
            if a == INVALID_INDEX:
                raise ValueError(f"no surviving ancestor for target joint '{t_names[j]}'")
            walk[j] = name_to_comb[t_names[a]]
        sw = tgt_character.skin_weights
        comb_skin = SkinWeights(index=_on(walk[_np(sw.index)], sw.index, torch.int32),
                                weight=sw.weight)

    # bodies: duplicates on one combined joint taken from the source
    # (character_utility.cpp:720-738)
    pieces = []
    for char_, jmap in ((tgt_character, tgt_to_comb), (src_character, src_to_comb)):
        pp = char_.physical_properties
        if pp is None:
            continue
        mapped = jmap[_np(pp.joint_index)]
        keep = mapped >= 0
        if keep.any():
            pieces.append((mapped[keep], pp, keep))
    comb_pp = None
    if pieces:
        if len(pieces) == 2:
            src_joints = set(pieces[1][0].tolist())
            tj, tpp, tkeep = pieces[0]
            extra = np.asarray([j not in src_joints for j in tj], bool)
            tkeep2 = np.zeros_like(tkeep)
            tkeep2[np.nonzero(tkeep)[0][extra]] = True
            pieces[0] = (tj[extra], tpp, tkeep2)
        ji = np.concatenate([pc[0] for pc in pieces])

        def cat(field):
            return torch.as_tensor(np.concatenate(
                [_np(getattr(pc[1], field))[pc[2]] for pc in pieces]), device=device)

        comb_pp = PhysicalProperties(
            joint_index=torch.as_tensor(ji.astype(np.int32), device=device), mass=cat("mass"),
            center_of_mass_offset=cat("center_of_mass_offset"), inertia=cat("inertia"),
            inertia_rotation=cat("inertia_rotation"),
            joint_names=tuple(comb_names[int(j)] for j in ji))

    out = Character(skeleton=comb_skel, parameter_transform=comb_pt, limits=comb_limits,
                    mesh=tgt_character.mesh, skin_weights=comb_skin,
                    blend_shape=tgt_character.blend_shape, locators=comb_loc,
                    collision=comb_col, physical_properties=comb_pp)
    return out.with_inverse_bind_pose() if comb_skin is not None else out


def vertices_to_faces(mesh: Mesh, active_vertices) -> np.ndarray:
    """A face selection from a vertex selection: a face is active when all
    its vertices are (character_utility.h:142 verticesToFaces)."""
    return np.asarray(active_vertices, bool)[_np(mesh.faces)].all(axis=1)


def faces_to_vertices(mesh: Mesh, active_faces) -> np.ndarray:
    """A vertex selection from a face selection: a vertex is active when any
    active face uses it (character_utility.h:149 facesToVertices)."""
    out = np.zeros(mesh.num_vertices, bool)
    out[_np(mesh.faces)[np.asarray(active_faces, bool)].reshape(-1)] = True
    return out
