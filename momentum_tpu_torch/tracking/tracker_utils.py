"""Tracker utilities, after momentum_tpu/tracking/tracker_utils.py
(tracker_utils.cpp): locator-character surgery, identity plumbing, marker
synthesis, floor contacts.

  createLocatorCharacter (:636), extractLocatorsFromCharacter (:730),
  extractParameters / extractIdAndLocatorsFromParams (:809-838),
  fillIdentity / removeIdentity (:848-884), extractMarkersFromMotion (:905),
  isRelatedJoint (:172), computeFloorContactConstraints (:944).

Character surgery is host numpy; the per-frame math (FK) is one batched
call. The skinned-locator conversions (averageTriangleSkinWeights,
closestPointOnMeshMatchingParent, locatorsToSkinnedLocators and back) wait
for errors/skinned_locator.py (ROADMAP M5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character import Character, Locators, ParameterTransform, make_skeleton
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT
from momentum_tpu_torch.math import skel_state as ss

__all__ = [
    "create_locator_character",
    "extract_locators_from_character",
    "extract_parameters",
    "extract_id_and_locators_from_params",
    "fill_identity",
    "remove_identity",
    "extract_markers_from_motion",
    "is_related_joint",
    "compute_floor_contact_constraints",
]


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
