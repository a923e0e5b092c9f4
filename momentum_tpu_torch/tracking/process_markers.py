"""The marker pipeline's array API, after
momentum_tpu/tracking/process_markers.py (marker_tracking/process_markers.h):
`calibrate_markers` (process_markers.cpp:132) and `process_markers` (:202).
`process_marker_file` and `save_motion` read and write C3D, FBX and GLB
files and come with the FBX part of the port's IO (ROADMAP M10 part 2)."""

from __future__ import annotations

import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.tracking.config import CalibrationConfig, TrackingConfig
from momentum_tpu_torch.tracking.tracker import (
    MarkerSequence, calibrate_model, get_locator_error, track_poses_per_frame)

__all__ = ["calibrate_markers", "process_markers"]


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
