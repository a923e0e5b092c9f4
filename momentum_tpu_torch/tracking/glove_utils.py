"""Glove calibration and tracking utilities, after
momentum_tpu/tracking/glove_utils.py (marker_tracking/glove_utils.{h,cpp}).

Data-glove sensor streams join the marker-tracking solves in three steps:
(1) one "glove bone" is added under each wrist; (2) its 6 DOF may become
model parameters (the "gloves" parameter set) for calibration; (3) each
frame's sensor observations become JointToJoint position and orientation
constraints between each finger joint and the glove bone.

A sensor stream is a dense padded array with a validity mask
(GloveSequence): an invalid sample gets constraint weight 0, so every frame
has the same shapes and one stacked module covers a whole hand's sequence.
Character surgery is host numpy, on the character's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT, make_skeleton
from momentum_tpu_torch.errors.joint_pair import (
    JointToJointOrientationErrorFunction, JointToJointPositionErrorFunction)
from momentum_tpu_torch.math import euler, quaternion as quat

__all__ = [
    "GloveConfig",
    "GloveOffset",
    "GloveSequence",
    "add_glove_bones",
    "add_glove_calibration_parameters",
    "create_glove_character",
    "extract_glove_offsets_from_character",
    "bake_glove_offsets_from_params",
    "make_glove_error_functions",
]

_GLOVE_DOFS = ("tx", "ty", "tz", "rx", "ry", "rz")


@dataclasses.dataclass(frozen=True)
class GloveConfig:
    """glove_utils.h:55-70 GloveConfig."""

    position_weight: float = 1.0
    orientation_weight: float = 1.0
    wrist_joint_names: Tuple[str, str] = ("l_wrist", "r_wrist")


@dataclasses.dataclass(frozen=True)
class GloveOffset:
    """A calibrated glove-to-wrist offset (glove_utils.h:73-82)."""

    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation_euler_xyz: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))


@dataclasses.dataclass(frozen=True)
class GloveSequence:
    """One hand's glove stream, padded per frame (GloveFrameData,
    glove_utils.h:30-50, in dense form):

    joint_index:  (S,) the finger joints' skeleton indices;
    positions:    (F, S, 3) sensor positions in the glove bone's frame;
    orientations: (F, S, 4) sensor orientations (x, y, z, w) in it;
    valid:        (F, S) bool, False rows get constraint weight 0."""

    joint_index: np.ndarray
    positions: np.ndarray
    orientations: np.ndarray
    valid: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.positions.shape[0]


def _glove_bone_name(cfg: GloveConfig, hand: int, prefix: str) -> str:
    return prefix + cfg.wrist_joint_names[hand]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def add_glove_bones(character: Character, cfg: GloveConfig = GloveConfig(),
                    offsets: Sequence[GloveOffset] = (GloveOffset(), GloveOffset()),
                    prefix: str = "glove_") -> Character:
    """One glove bone appended under each configured wrist
    (glove_utils.h addGloveBones): its translation offset and pre-rotation
    from the calibrated offset, no model parameters. A wrist missing from
    the skeleton, or one that has its bone already, is skipped."""
    skel = character.skeleton
    device = skel.joint_parent.device
    parents = list(skel.parents_np)
    pre = list(_np(skel.pre_rotation))
    toff = list(_np(skel.translation_offset))
    names = list(skel.joint_names)
    for hand, wrist in enumerate(cfg.wrist_joint_names):
        bone = _glove_bone_name(cfg, hand, prefix)
        if wrist not in names or bone in names:
            continue
        off = offsets[hand] if hand < len(offsets) else GloveOffset()
        m = euler.euler_xyz_to_matrix(torch.as_tensor(
            np.asarray(off.rotation_euler_xyz, np.float32)))
        parents.append(names.index(wrist))
        pre.append(_np(quat.from_rotation_matrix(m)))
        toff.append(np.asarray(off.translation, np.float32))
        names.append(bone)
    new_skel = make_skeleton(parents, np.asarray(pre), np.asarray(toff), names,
                             dtype=skel.pre_rotation.dtype, device=device)
    # the transform's rows widened to the new joints, which nothing drives
    pt = character.parameter_transform
    rows_new = new_skel.num_joints * PARAMS_PER_JOINT
    extra = rows_new - pt.transform.shape[0]
    pt2 = ParameterTransform(
        transform=torch.cat([pt.transform, pt.transform.new_zeros(extra, pt.transform.shape[1])]),
        offsets=torch.cat([pt.offsets, pt.offsets.new_zeros(extra)]),
        names=pt.names, parameter_sets=pt.parameter_sets)
    return dataclasses.replace(character, skeleton=new_skel, parameter_transform=pt2)


def add_glove_calibration_parameters(character: Character, cfg: GloveConfig = GloveConfig(),
                                     prefix: str = "glove_") -> Character:
    """Each glove bone's 6 DOF (tx ty tz rx ry rz) appended as model
    parameters, registered as the parameter set "gloves"
    (glove_utils.h addGloveCalibrationParameters)."""
    pt = character.parameter_transform
    names = character.skeleton.joint_names
    rows, new_names = [], []
    for hand in range(len(cfg.wrist_joint_names)):
        bone = _glove_bone_name(cfg, hand, prefix)
        if bone not in names:
            continue
        j = names.index(bone)
        for d, dof in enumerate(_GLOVE_DOFS):
            rows.append(j * PARAMS_PER_JOINT + d)
            new_names.append(f"{bone}_{dof}")
    if not rows:
        return character
    p0 = pt.num_model_parameters
    cols = pt.transform.new_zeros(pt.transform.shape[0], len(rows))
    cols[rows, list(range(len(rows)))] = 1.0
    sets = dict(pt.parameter_sets)
    sets["gloves"] = tuple(range(p0, p0 + len(rows)))
    pt2 = ParameterTransform(transform=torch.cat([pt.transform, cols], dim=1),
                             offsets=pt.offsets, names=pt.names + tuple(new_names),
                             parameter_sets=sets)
    return dataclasses.replace(character, parameter_transform=pt2)


def create_glove_character(character: Character, cfg: GloveConfig = GloveConfig(),
                           prefix: str = "glove_") -> Character:
    """add_glove_bones, then add_glove_calibration_parameters
    (glove_utils.h createGloveCharacter)."""
    return add_glove_calibration_parameters(add_glove_bones(character, cfg, prefix=prefix),
                                            cfg, prefix)


def extract_glove_offsets_from_character(character: Character, params,
                                         cfg: GloveConfig = GloveConfig(),
                                         prefix: str = "glove_"):
    """The solved per-hand glove offsets read from the calibration
    parameters (glove_utils.h extractGloveOffsetsFromCharacter); a hand
    without them gets the zero offset."""
    pnames = character.parameter_transform.names
    params = _np(params) if isinstance(params, torch.Tensor) else np.asarray(params)
    out = []
    for hand in range(len(cfg.wrist_joint_names)):
        bone = _glove_bone_name(cfg, hand, prefix)
        try:
            vals = np.asarray([params[pnames.index(f"{bone}_{d}")] for d in _GLOVE_DOFS],
                              np.float32)
        except ValueError:
            out.append(GloveOffset())
            continue
        out.append(GloveOffset(translation=vals[:3], rotation_euler_xyz=vals[3:]))
    return out


def bake_glove_offsets_from_params(character: Character, solved_params,
                                   solving_character: Character,
                                   cfg: Optional[GloveConfig] = GloveConfig(),
                                   prefix: str = "glove_") -> Character:
    """The calibrated glove offsets baked into a character without glove
    parameters (glove_utils.h bakeGloveOffsetsFromParams): its glove bones,
    if any, removed, then added again at the solved offsets."""
    if cfg is None:
        return character
    offsets = extract_glove_offsets_from_character(solving_character, solved_params, cfg,
                                                   prefix)
    names = character.skeleton.joint_names
    existing = [_glove_bone_name(cfg, h, prefix) for h in range(len(cfg.wrist_joint_names))
                if _glove_bone_name(cfg, h, prefix) in names]
    if existing:
        from momentum_tpu_torch.character.utility import remove_joints

        character = remove_joints(character, existing)
    return add_glove_bones(character, cfg, offsets, prefix)


def make_glove_error_functions(character: Character, glove: GloveSequence, frame: int,
                               cfg: GloveConfig = GloveConfig(), hand: int = 0,
                               prefix: str = "glove_"):
    """One hand's JointToJoint position and orientation modules at one frame
    (glove_utils.h setupGloveErrorFunctions /
    createGlove{Position,Orientation}ConstraintData): source the finger
    joint, reference the glove bone, target the sensor observation in the
    glove's frame; invalid samples get weight 0."""
    names = character.skeleton.joint_names
    bone = _glove_bone_name(cfg, hand, prefix)
    if bone not in names:
        raise ValueError(f"glove bone {bone!r} not in skeleton; run create_glove_character "
                         "first")
    device = character.skeleton.joint_parent.device
    src = np.asarray(glove.joint_index, np.int32)
    s = src.shape[0]
    ref = np.full(s, names.index(bone), np.int32)
    valid = np.asarray(glove.valid[frame], np.float32)
    zeros3 = np.zeros((s, 3), np.float32)
    pos_ef = JointToJointPositionErrorFunction.create(
        src, ref, zeros3, zeros3, np.asarray(glove.positions[frame], np.float32),
        cweight=valid, weight=cfg.position_weight, device=device)
    ori_ef = JointToJointOrientationErrorFunction.create(
        src, ref, np.asarray(glove.orientations[frame], np.float32), cweight=valid,
        weight=cfg.orientation_weight, device=device)
    return pos_ef, ori_ef
