"""Tracker utilities, after momentum_tpu/tracking/tracker_utils.py
(tracker_utils.cpp): locator-character surgery, identity plumbing, marker
synthesis, skinned-locator conversion, floor contacts.

  createLocatorCharacter (:636), extractLocatorsFromCharacter (:730),
  extractParameters / extractIdAndLocatorsFromParams (:809-838),
  fillIdentity / removeIdentity (:848-884), extractMarkersFromMotion (:905),
  averageTriangleSkinWeights (:113), isRelatedJoint (:172),
  closestPointOnMeshMatchingParent (:187), locatorsToSkinnedLocators (:243),
  skinnedLocatorsToLocators (:340), computeFloorContactConstraints (:944).

Character surgery is host numpy; the per-frame math (FK) is one batched
call. The closest-point search over every triangle runs on host tensors in
float32, as JAX's does on its CPU, whatever the character's device: it is
load-time surgery, and its argmin picks the triangle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character import (
    Character, Locators, ParameterTransform, SkinnedLocators, make_skeleton)
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.geometry import point_triangle_closest_point

__all__ = [
    "create_locator_character",
    "extract_locators_from_character",
    "extract_parameters",
    "extract_id_and_locators_from_params",
    "fill_identity",
    "remove_identity",
    "extract_markers_from_motion",
    "is_related_joint",
    "average_triangle_skin_weights",
    "closest_point_on_mesh_matching_parent",
    "locators_to_skinned_locators",
    "skinned_locators_to_locators",
    "compute_floor_contact_constraints",
]

_MAX_SKIN = 8  # kMaxSkinJoints


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def create_locator_character(character: Character, prefix: str = "locator_"):
    """Turn every locator into a joint of its own with 3 translation
    parameters, so locator offsets calibrate as ordinary model parameters
    (tracker_utils.cpp:636-728). Returns (locator_character,
    locator_param_mask), the mask selecting the added parameters, which are
    also registered as the parameter set "locators"."""
    skel = character.skeleton
    loc = character.locators
    device = skel.joint_parent.device
    nj = skel.num_joints
    nl = loc.num_locators

    parents = np.concatenate([skel.parents_np, _np(loc.parent)]).astype(np.int64)
    pre = np.concatenate([_np(skel.pre_rotation), np.tile([0.0, 0.0, 0.0, 1.0], (nl, 1))])
    offs = np.concatenate([_np(skel.translation_offset), _np(loc.offset)])
    names = list(skel.joint_names) + [
        prefix + (loc.names[i] if loc.names else f"l{i}") for i in range(nl)]
    new_skel = make_skeleton(parents, pre, offs, names, dtype=skel.pre_rotation.dtype,
                             device=device)

    pt = character.parameter_transform
    p_old = pt.num_model_parameters
    old_mat = _np(pt.transform)
    new_rows = (nj + nl) * PARAMS_PER_JOINT
    mat = np.zeros((new_rows, p_old + 3 * nl), old_mat.dtype)
    mat[: old_mat.shape[0], :p_old] = old_mat
    pnames = list(pt.names)
    for i in range(nl):
        jid = nj + i
        for a, suffix in enumerate(("_tx", "_ty", "_tz")):
            mat[jid * PARAMS_PER_JOINT + a, p_old + 3 * i + a] = 1.0
            pnames.append(names[jid] + suffix)
    offsets = np.zeros(new_rows, old_mat.dtype)
    offsets[: old_mat.shape[0]] = _np(pt.offsets)
    loc_set = tuple(range(p_old, p_old + 3 * nl))
    sets = dict(pt.parameter_sets)
    sets["locators"] = loc_set
    new_pt = ParameterTransform(transform=torch.as_tensor(mat, device=device),
                                offsets=torch.as_tensor(offsets, device=device),
                                names=tuple(pnames), parameter_sets=sets)
    new_loc = Locators(parent=torch.arange(nj, nj + nl, dtype=torch.int32, device=device),
                       offset=torch.zeros((nl, 3), dtype=torch.float32, device=device),
                       weight=loc.weight, names=loc.names)
    mask = np.zeros(p_old + 3 * nl, bool)
    mask[list(loc_set)] = True
    char = dataclasses.replace(character, skeleton=new_skel, parameter_transform=new_pt,
                               locators=new_loc)
    return char.with_inverse_bind_pose(), mask


def extract_locators_from_character(locator_character: Character, calib_params) -> Locators:
    """The calibrated locator joints' positions mapped back into their
    ORIGINAL parent frames (tracker_utils.cpp:730-785)."""
    char = locator_character
    states = char.skeleton_states(torch.as_tensor(calib_params, dtype=torch.float32,
                                                  device=char.skeleton.joint_parent.device))
    loc = char.locators
    world = ss.transform_points(states.index_select(-2, loc.parent.long()), loc.offset)
    orig_parent = char.skeleton.joint_parent.index_select(0, loc.parent.long())
    parent_states = states.index_select(-2, orig_parent.long())
    offset = ss.transform_points(ss.inverse(parent_states), world)
    return Locators(parent=orig_parent.to(torch.int32), offset=offset, weight=loc.weight,
                    names=loc.names)


def extract_parameters(params: torch.Tensor, parameter_mask) -> torch.Tensor:
    """Every parameter outside the mask zeroed (tracker_utils.cpp:809)."""
    mask = torch.as_tensor(np.asarray(parameter_mask, bool), device=params.device)
    return torch.where(mask, params, torch.zeros_like(params))


def _scaling_mask(character, scaling_set: str = "scaling") -> np.ndarray:
    """The parameter set `scaling_set`, else every parameter named like a scale."""
    pt = character.parameter_transform
    mask = np.zeros(pt.num_model_parameters, bool)
    if scaling_set in pt.parameter_sets:
        mask[list(pt.parameter_sets[scaling_set])] = True
    else:
        mask[[i for i, n in enumerate(pt.names) if "scale" in n.lower()]] = True
    return mask


def extract_id_and_locators_from_params(params: torch.Tensor, source_character,
                                        target_character):
    """(identity params, calibrated Locators) from a locator-character solve
    (tracker_utils.cpp:820-838)."""
    n = target_character.parameter_transform.num_model_parameters
    id_params = extract_parameters(params[..., :n], _scaling_mask(target_character))
    return id_params, extract_locators_from_character(source_character, params)


def fill_identity(motion: torch.Tensor, identity: torch.Tensor, scaling_mask=None,
                  character=None) -> torch.Tensor:
    """The scaling columns of a (F, P) motion overwritten by the shared
    identity (tracker_utils.cpp:848-866)."""
    if scaling_mask is None:
        scaling_mask = _scaling_mask(character)
    mask = torch.as_tensor(np.asarray(scaling_mask, bool), device=motion.device)
    return torch.where(mask, identity, motion)


def remove_identity(motion: torch.Tensor, scaling_mask=None, character=None) -> torch.Tensor:
    """The scaling columns of a (F, P) motion zeroed (tracker_utils.cpp:867-883)."""
    if scaling_mask is None:
        scaling_mask = _scaling_mask(character)
    return extract_parameters(motion, ~np.asarray(scaling_mask, bool))


def extract_markers_from_motion(character: Character, motion: torch.Tensor) -> torch.Tensor:
    """(F, L, 3) world locator positions of a motion (tracker_utils.cpp:905-922)."""
    return character.locators.world_positions(character.skeleton_states(motion.float()))


def is_related_joint(skeleton, joint_a: int, joint_b: int) -> bool:
    """Same joint, or one the other's parent (tracker_utils.cpp:172-186)."""
    if joint_a == joint_b:
        return True
    parent = skeleton.parents_np
    return bool(parent[joint_a] == joint_b or parent[joint_b] == joint_a)


def average_triangle_skin_weights(character: Character, triangle_index: int, barycentric):
    """The barycentric blend of the triangle's vertex skin weights, the 8
    largest kept and renormalized (tracker_utils.cpp:113-154) →
    (indices (8,) int32, weights (8,) float32), zero-padded."""
    skin = character.skin_weights
    tri = _np(character.mesh.faces)[triangle_index]
    bary = np.asarray(barycentric, np.float64)
    dense = np.zeros(character.skeleton.num_joints)
    idx, wgt = _np(skin.index), _np(skin.weight)
    for k in range(3):
        np.add.at(dense, idx[tri[k]], wgt[tri[k]] * bary[k])
    order = np.argsort(-dense)[:_MAX_SKIN]
    w = dense[order]
    total = w.sum()
    w = w / total if total > 0 else w
    idx8 = np.zeros(_MAX_SKIN, np.int32)
    w8 = np.zeros(_MAX_SKIN, np.float32)
    idx8[: len(order)] = order
    w8[: len(w)] = w
    return idx8, w8


def closest_point_on_mesh_matching_parent(character: Character, p_world, parent_idx: int,
                                          cutoff_weight: float = 0.02):
    """The closest point of the rest mesh to p_world among the triangles
    whose mean skin weight on {parent, its parent, its children} reaches the
    cutoff (tracker_utils.cpp:187-241), every triangle at once on host
    tensors → (triangle index, barycentric (3,), point (3,), distance), or
    None when no triangle passes the cutoff."""
    faces = _np(character.mesh.faces)
    idx, wgt = _np(character.skin_weights.index), _np(character.skin_weights.weight)
    parent = character.skeleton.parents_np
    related = np.zeros(character.skeleton.num_joints, bool)
    related[parent_idx] = True
    if parent[parent_idx] >= 0:
        related[parent[parent_idx]] = True
    related[np.nonzero(parent == parent_idx)[0]] = True
    tri_w = (related[idx[faces]] * wgt[faces]).sum((-1, -2)) / 3.0  # (F,)
    ok = tri_w >= cutoff_weight
    if not ok.any():
        return None
    tri = character.mesh.vertices.detach().cpu()[torch.as_tensor(faces, dtype=torch.int64)]
    p = torch.as_tensor(np.array(p_world, np.float32))
    q, bary = point_triangle_closest_point(p, tri[:, 0], tri[:, 1], tri[:, 2])
    dist = torch.linalg.vector_norm(q - p, dim=-1)
    dist = torch.where(torch.as_tensor(ok), dist, torch.inf)
    best = int(torch.argmin(dist))
    return best, bary[best].numpy(), q[best].numpy(), float(dist[best])


def locators_to_skinned_locators(character: Character, cutoff_weight: float = 0.02) -> Character:
    """Joint-attached locators turned into mesh-skinned ones: each snapped
    to the closest admissible point of the rest mesh, with that triangle's
    blended skin weights (tracker_utils.cpp:243-338); a locator with no
    admissible triangle stays on its joint. The new skinned locators follow
    any the character already has."""
    loc = character.locators
    if loc is None or loc.num_locators == 0:
        return character
    device = loc.parent.device
    parents_np = _np(loc.parent)
    world = _np(ss.transform_points(character.bind_pose().detach().cpu()[parents_np],
                                    loc.offset.detach().cpu()))
    kept_rows, skinned = [], []
    for i in range(loc.num_locators):
        hit = closest_point_on_mesh_matching_parent(character, world[i], int(parents_np[i]),
                                                    cutoff_weight)
        if hit is None:
            kept_rows.append(i)
            continue
        tri_idx, bary, point, _ = hit
        sidx, sw = average_triangle_skin_weights(character, tri_idx, bary)
        skinned.append((loc.names[i] if loc.names else f"l{i}", sidx, sw, point))
    if not skinned:
        return character

    def t(rows, dtype=None):
        return torch.as_tensor(np.stack(rows), dtype=dtype, device=device)

    new_sl = SkinnedLocators(parents=t([s[1] for s in skinned]),
                             skin_weights=t([s[2] for s in skinned]),
                             rest_position=t([s[3] for s in skinned], torch.float32),
                             names=tuple(s[0] for s in skinned))
    old = character.skinned_locators
    if old is not None and old.num_locators:
        new_sl = SkinnedLocators(
            parents=torch.cat([old.parents, new_sl.parents]),
            skin_weights=torch.cat([old.skin_weights, new_sl.skin_weights]),
            rest_position=torch.cat([old.rest_position, new_sl.rest_position]),
            names=old.names + new_sl.names)
    kept_t = torch.as_tensor(kept_rows, dtype=torch.int64, device=device)
    kept = Locators(parent=loc.parent.index_select(0, kept_t),
                    offset=loc.offset.index_select(0, kept_t),
                    weight=loc.weight.index_select(0, kept_t),
                    names=tuple(loc.names[i] for i in kept_rows) if loc.names else ())
    return dataclasses.replace(character, locators=kept, skinned_locators=new_sl)


def skinned_locators_to_locators(character: Character) -> Character:
    """Each skinned locator reattached to its strongest-weight joint as a
    plain locator, its offset the rest position in that joint's bind frame
    (tracker_utils.cpp:340-405), weight 1, after the existing locators."""
    sl = character.skinned_locators
    if sl is None or sl.num_locators == 0:
        return character
    best_k = torch.argmax(sl.skin_weights, dim=1)
    parents = sl.parents.gather(1, best_k[:, None])[:, 0]
    parent_states = character.bind_pose().index_select(0, parents)
    new_loc = Locators(parent=parents.to(torch.int32),
                       offset=ss.transform_points(ss.inverse(parent_states), sl.rest_position),
                       weight=torch.ones(sl.num_locators, device=sl.parents.device),
                       names=sl.names)
    loc = character.locators
    if loc is not None and loc.num_locators:
        new_loc = Locators(parent=torch.cat([loc.parent, new_loc.parent]),
                           offset=torch.cat([loc.offset, new_loc.offset]),
                           weight=torch.cat([loc.weight, new_loc.weight]),
                           names=loc.names + new_loc.names)
    return dataclasses.replace(character, locators=new_loc, skinned_locators=None)


def compute_floor_contact_constraints(character: Character, motion: torch.Tensor,
                                      floor_parents, floor_offsets,
                                      floor_normal=(0.0, 1.0, 0.0), floor_d: float = 0.0,
                                      percentile: float = 0.15):
    """Per-locator contact detection over a motion (tracker_utils.cpp:944-1002):
    each floor locator's signed height per frame, a per-locator percentile
    threshold, contact where the height is at or below it. Returns
    (contact (F, L) bool, heights (F, L)); one batched FK for all frames."""
    device = motion.device
    states = character.skeleton_states(motion.float())
    fp = torch.as_tensor(np.asarray(floor_parents, np.int64), device=device)
    fo = torch.as_tensor(np.asarray(floor_offsets, np.float32), device=device)
    pts = ss.transform_points(states.index_select(-2, fp), fo)  # (F, L, 3)
    n = torch.as_tensor(np.asarray(floor_normal, np.float32), device=device)
    heights = pts @ n - floor_d
    f = heights.shape[0]
    k = min(int(percentile * f), f - 1)
    thresh = torch.sort(heights, dim=0).values[k]
    return heights <= thresh, heights
