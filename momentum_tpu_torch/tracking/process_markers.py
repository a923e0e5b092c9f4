"""Top-level marker-pipeline API, after
momentum_tpu/tracking/process_markers.py (marker_tracking/process_markers.h):
`calibrate_markers` (process_markers.cpp:132), `process_markers` (:202) and
`process_marker_file` (:292) — the library-level entry points the
process-markers CLI (tracking/process_markers_app.py) wraps — and
`save_motion` (marker_tracking_pybind.cpp:921-955)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.tracking.config import CalibrationConfig, TrackingConfig
from momentum_tpu_torch.tracking.tracker import (
    MarkerSequence, TrackingResult, calibrate_model, get_locator_error, track_poses_per_frame)

__all__ = ["calibrate_markers", "process_markers", "process_marker_file", "save_motion"]


def _slice_frames(markers: MarkerSequence, first_frame: int, max_frames: int) -> MarkerSequence:
    """The window [first_frame, first_frame + max_frames) (max_frames 0: the
    rest), process_markers.cpp:150-153."""
    f = markers.num_frames
    if first_frame > f:
        raise ValueError(f"first frame {first_frame} can't exceed total frames {f}")
    last = min(first_frame + max_frames, f) if max_frames > 0 else f
    if first_frame == 0 and last == f:
        return markers
    return MarkerSequence(positions=markers.positions[first_frame:last],
                          occluded=markers.occluded[first_frame:last], names=markers.names)


def calibrate_markers(character: Character, identity: torch.Tensor, markers: MarkerSequence,
                      calibration_config: CalibrationConfig = CalibrationConfig(),
                      first_frame: int = 0, max_frames: int = 0):
    """Calibrate the identity (with `locators_only`, the locator offsets)
    on a clip window (calibrateMarkers, process_markers.cpp:132-199) →
    (character, identity) with the calibrated quantity replaced."""
    data = _slice_frames(markers, first_frame, max_frames)
    if data.num_frames < 2:
        raise ValueError(f"calibration requires at least 2 frames, got {data.num_frames}")
    if calibration_config.global_scale_only and calibration_config.locators_only:
        raise ValueError("global_scale_only and locators_only are exclusive")
    if calibration_config.locators_only:
        identity_out, _, character = calibrate_model(character, data, calibration_config,
                                                     initial=identity)
        return character, identity_out
    identity_out, _ = calibrate_model(character, data, calibration_config, initial=identity)
    return character, identity_out


def process_markers(character: Character, identity: torch.Tensor, markers: MarkerSequence,
                    tracking_config: TrackingConfig = TrackingConfig(),
                    calibration_config: CalibrationConfig = CalibrationConfig(),
                    calibrate: bool = True, first_frame: int = 0, max_frames: int = 0,
                    debug: bool = False):
    """Calibration (optional), then per-frame tracking from the identity,
    on a clip window (processMarkers, process_markers.cpp:202-290) →
    (TrackingResult over the window, character, identity). `debug` prints
    the average and maximum marker errors as the reference logs them."""
    data = _slice_frames(markers, first_frame, max_frames)
    if data.num_frames == 0:
        raise ValueError("input marker data is empty")
    if calibrate:
        character, identity = calibrate_markers(character, identity, data, calibration_config)
    result = track_poses_per_frame(character, data, tracking_config, initial=identity)
    if debug:
        avg, mx = get_locator_error(character, data, result.motion)
        print(f"Average marker error: {avg}")
        print(f"Max marker error: {mx}")
    return result, character, identity


def process_marker_file(input_marker_file: str, output_file: str,
                        tracking_config: TrackingConfig = TrackingConfig(),
                        calibration_config: CalibrationConfig = CalibrationConfig(),
                        character_path: Optional[str] = None, model_path: Optional[str] = None,
                        identity_path: Optional[str] = None, calibrate: bool = True,
                        first_frame: int = 0, max_frames: int = 0,
                        device="cuda") -> TrackingResult:
    """Track a marker file end to end and save the solved motion
    (processMarkerFile, process_markers.cpp:292-380): load the character
    (+ optional .model definition and identity) and the markers onto
    `device` (the card unless the caller asks for the CPU), run
    `process_markers`, save. Output formats: .glb/.gltf (FB_momentum
    motion), .fbx (the package's writer — the reference gates this on the
    Autodesk SDK), .bvh, .mmo."""
    import momentum_tpu_torch.io as mio
    from momentum_tpu_torch.tracking.app_utils import load_character_with_identity

    ext = os.path.splitext(output_file)[1].lower()
    if ext not in (".glb", ".gltf", ".fbx", ".bvh", ".mmo"):
        raise ValueError(f"invalid output file type {ext}; supported: glb/gltf/fbx/bvh/mmo")

    character, identity = load_character_with_identity(character_path, model_path,
                                                       identity_path, device=device)
    if input_marker_file.lower().endswith(".trc"):
        raw = mio.load_trc(input_marker_file)
    else:
        raw = mio.load_c3d(input_marker_file)
    markers = raw.to_marker_sequence(device=identity.device)

    result, character, identity = process_markers(
        character, identity, markers, tracking_config, calibration_config, calibrate,
        first_frame, max_frames)

    if ext in (".glb", ".gltf"):
        mio.save_character_glb(output_file, character, motion=result.motion, fps=raw.fps)
    elif ext == ".fbx":
        mio.save_fbx(output_file, character, motion=result.motion, fps=raw.fps)
    elif ext == ".bvh":
        mio.save_bvh(output_file, character, character.parameter_transform.apply(result.motion),
                     fps=raw.fps)
    else:
        mio.save_mmo(output_file, result.motion, np.zeros(character.num_joints, np.float32),
                     list(character.parameter_transform.names),
                     list(character.skeleton.joint_names))
    return result


def save_motion(out_file, character, identity, motion, marker_data=None, fps: float = 120.0,
                save_marker_mesh: bool = True) -> None:
    """Save tracked motion with the identity split out — the pymomentum
    marker_tracking.save_motion surface (marker_tracking_pybind.cpp:921-955 →
    marker_tracker saveMotion): the scaling (identity) parameters are removed
    from the per-frame motion and stored once as the GLB identity section
    (joint parameters); markers ride along when save_marker_mesh.

    out_file: .glb/.gltf (identity-aware), or any extension
    io.save_character supports (identity then baked into the motion).
    motion: (F, P) model parameters; identity: (P,) model parameters or None;
    both on any device.
    """
    import momentum_tpu_torch.io as mio
    from momentum_tpu_torch.device import to_host

    motion = to_host(motion).astype(np.float32)
    pt = character.parameter_transform
    p = pt.num_model_parameters
    if motion.shape[-1] != p:
        raise ValueError(f"motion has {motion.shape[-1]} parameters, character has {p}")
    if identity is None or to_host(identity).size == 0:
        identity = np.zeros(p, np.float32)
    identity = to_host(identity).astype(np.float32).reshape(p)

    ext = os.path.splitext(str(out_file))[1].lower()
    markers = marker_data if save_marker_mesh else None
    scaling = np.asarray(pt.scaling_parameters)
    if ext in (".glb", ".gltf"):
        # strip the scaling fields from per-frame motion; store the identity
        # as joint parameters (the reference's saveMotion split)
        stripped = motion.copy()
        stripped[:, scaling] = 0.0
        identity_jp = pt.apply(torch.as_tensor(identity).to(pt.transform.device))
        mio.save_character_glb(str(out_file), character, motion=stripped, fps=fps,
                               markers=markers, identity=identity_jp)
    else:
        # bake identity into the motion for formats without an identity slot
        full = motion.copy()
        full[:, scaling] += identity[None, scaling]
        mio.save_character(str(out_file), character, motion=full, fps=fps)
