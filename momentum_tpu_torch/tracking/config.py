"""Marker-tracking configuration structs, after
momentum_tpu/tracking/config.py (marker_tracker.h:42-135: BaseConfig /
CalibrationConfig / TrackingConfig / RefineConfig). Frozen dataclasses of
plain values: they select the pipelines' behaviour.
"""

from __future__ import annotations

import dataclasses

__all__ = ["BaseConfig", "CalibrationConfig", "TrackingConfig", "RefineConfig"]


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """marker_tracker.h:42-60."""

    loss_alpha: float = 2.0  # generalized-loss alpha for marker residuals
    loss_c: float = 1.0
    max_iter: int = 30
    min_vis_percent: float = 0.0  # skip frames with fewer visible markers
    regularization: float = 0.05
    debug: bool = False
    # "gauss_newton" (reference trackPosesPerframe GN-QR) or
    # "levenberg_marquardt" — LM is the robust choice for cold starts on
    # uncalibrated rigs (mm-scale data can overshoot the log2 scale in GN)
    method: str = "gauss_newton"
    # lock identity/scaling parameters during pose tracking, matching the
    # reference which solves pose params only while tracking
    # (marker_tracker.cpp trackPosesPerframe); calibration estimates scale
    freeze_scaling: bool = True
    # Armijo backtracking in the sequence solve (the reference SequenceSolver
    # option, sequence_solver.cpp:531-555); calibration turns it on so the
    # universal log2-scale step cannot overshoot
    line_search: bool = False


@dataclasses.dataclass(frozen=True)
class CalibrationConfig(BaseConfig):
    """marker_tracker.h:62-92."""

    calib_frames: int = 100  # number of sampled frames used for calibration
    # Base weight for 2D keypoint projection constraints; 0 disables
    # (marker_tracker.h:87 projectionWeight)
    projection_weight: float = 0.0
    major_iter: int = 3  # alternating tracking/calibration rounds
    global_scale_only: bool = False  # solve only uniform scale
    locators_only: bool = False  # solve only locator offsets
    greedy_sampling: int = 0  # stride-based frame sampling when > 0
    calib_shape: bool = False  # calibrate blendshape params too
    # Force Floor_-prefixed locators to the ground plane on the first sampled
    # frame with high weight (marker_tracker.h enforceFloorInFirstFrame);
    # exclusive with adaptive_floor_contact
    enforce_floor_in_first_frame: bool = False
    # Detect per-locator contact frames (heights at or below the percentile)
    # and apply soft equality floor constraints on those frames
    # (marker_tracker.h adaptiveFloorContact / floorContactPercentile)
    adaptive_floor_contact: bool = False
    floor_contact_percentile: float = 1.0 / 3.0
    # Name of a pose-constraint set applied as first-frame minmax limits
    # (marker_tracker.h firstFramePoseConstraintSet →
    # getPoseConstraintParameterLimits, parameter_limits.cpp:66-84)
    first_frame_pose_constraint_set: str = ""
    # Target character height in cm; 0 disables the height constraint
    # (marker_tracker.h targetHeightCm → HeightErrorFunction on frame 0)
    target_height_cm: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrackingConfig(BaseConfig):
    """marker_tracker.h:94-110."""

    smoothing: float = 0.0  # model-parameter smoothness weight
    collision_error_weight: float = 0.0
    smoothing_weights: tuple = ()  # optional per-parameter smoothness
    # Multiplier on the marker position constraint weight; 0 disables marker
    # constraints (marker_tracker.h markerWeight)
    marker_weight: float = 1.0
    # Half-plane floor (non-penetration) constraints on Floor_-prefixed
    # locators during tracking (trackPosesForFrames adds them
    # unconditionally, marker_tracker.cpp:932-943); rigs without Floor_
    # locators are unaffected, matching the reference's empty constraint list
    floor_constraints: bool = True
    # Base weight for 2D keypoint projection constraints; 0 disables
    # (marker_tracker.h:115 projectionWeight)
    projection_weight: float = 0.0
    # Compacted tail refinement for the batched tracker (solver/compaction
    # economics): (k_full, r_refine, capacity) — run k_full iterations on
    # every frame, then r_refine more on only the `capacity` worst frames
    # (λ state carried, so refined frames reproduce the uncompacted
    # (k_full + r_refine)-iteration sequence exactly). None = off.
    refine: tuple | None = None


@dataclasses.dataclass(frozen=True)
class RefineConfig(TrackingConfig):
    """marker_tracker.h:112-135."""

    regularizer: float = 0.0  # pull toward the input motion
    calib_id: bool = False  # re-calibrate identity during refine
    calib_locators: bool = False
    # Double-precision normal equations + factorization for the refine
    # solve (the reference's answer to this exact system,
    # sequence_cholesky_solver.h:31-33): the smoothing-dominated refine
    # Hessian is near-singular at float32 resolution. False falls back to
    # float32 with a 1e-5 equilibrated jitter (LM-style damping).
    f64: bool = True
