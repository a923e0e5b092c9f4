"""Character surgery, after momentum_tpu/character/utility.py (host numpy,
done once at load time): the functions that extend a rig with shape
coefficients and skinned-locator offsets, and `remove_joints`. The rest
comes with ROADMAP M9.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character.character import Character, Locators
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT, make_skeleton
from momentum_tpu_torch.character.skinning import SkinWeights

__all__ = ["add_blend_shape_parameters", "add_face_expression_parameters",
           "add_skinned_locator_parameters", "skinned_locator_rest_offsets", "remove_joints"]

INVALID_INDEX = -1


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


def _map_locators(loc, joint_map: np.ndarray):
    """The locators with their parents sent through an old → new joint map,
    those whose parent maps to INVALID_INDEX dropped
    (character_utility.cpp:173-191 mapParents)."""
    if loc is None:
        return None
    mapped = joint_map[loc.parent.cpu().numpy()]
    keep = mapped != INVALID_INDEX
    keep_t = torch.as_tensor(np.nonzero(keep)[0], device=loc.parent.device)
    return Locators(parent=torch.as_tensor(mapped[keep].astype(np.int32), device=loc.parent.device),
                    offset=loc.offset.index_select(0, keep_t),
                    weight=loc.weight.index_select(0, keep_t),
                    names=tuple(n for n, k in zip(loc.names, keep) if k))


def remove_joints(character: Character, joints_to_remove) -> Character:
    """The rig without the given joints (names or indices) and their
    subtrees (character_utility.cpp removeJoints): the parameter transform
    loses the removed joints' rows and the parameters that then drive
    nothing (its parameter sets are dropped, as JAX's are), locators on
    removed joints go, the mesh stays with each skin influence re-pointed at
    its nearest kept ancestor, and the inverse bind pose is recomputed. The
    port's Character has no physical properties (ROADMAP M9), so it carries
    the fields it has; the skinned locators and the limits stay as they are,
    as in JAX."""
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
    keep_t = torch.as_tensor(keep_idx, device=device)
    new_skel = make_skeleton(new_parents,
                             pre_rotations=skel.pre_rotation.index_select(0, keep_t).cpu().numpy(),
                             translation_offsets=skel.translation_offset.index_select(
                                 0, keep_t).cpu().numpy(),
                             names=[skel.joint_names[i] for i in keep_idx],
                             dtype=skel.pre_rotation.dtype, device=device)

    pt = character.parameter_transform
    rows = torch.as_tensor(np.nonzero(np.repeat(~remove, PARAMS_PER_JOINT))[0], device=device)
    tf2 = pt.transform.index_select(0, rows)
    col_keep = np.nonzero((tf2.abs() > 0).any(dim=0).cpu().numpy())[0]
    cols = torch.as_tensor(col_keep, device=device)
    pt2 = ParameterTransform(transform=tf2.index_select(1, cols),
                             offsets=pt.offsets.index_select(0, rows),
                             names=tuple(pt.names[i] for i in col_keep))
    out = dataclasses.replace(character, skeleton=new_skel, parameter_transform=pt2,
                              inverse_bind_pose=None, mesh=None, skin_weights=None,
                              blend_shape=None, collision=None,
                              locators=_map_locators(character.locators, old_to_new))
    if character.mesh is not None and character.skin_weights is not None:
        remap = np.empty(n, np.int64)
        for j in range(n):
            a = j
            while a != INVALID_INDEX and remove[a]:
                a = parents[a]
            remap[j] = old_to_new[a] if a != INVALID_INDEX else 0
        si = character.skin_weights.index.cpu().numpy()
        out = dataclasses.replace(out, mesh=character.mesh, skin_weights=SkinWeights(
            index=torch.as_tensor(remap[si].astype(np.int32), device=device),
            weight=character.skin_weights.weight.clone()))
    return out.with_inverse_bind_pose()
