"""Marker tracking: calibration, per-frame, batched and hierarchical
tracking, the sequence refine and the array API of the marker pipeline."""

from momentum_tpu_torch.tracking.cmu import CMU_MARKER_MAP, create_cmu_character  # noqa: F401
from momentum_tpu_torch.tracking.config import (  # noqa: F401
    BaseConfig, CalibrationConfig, RefineConfig, TrackingConfig)
from momentum_tpu_torch.tracking.gap_fill import fill_marker_gaps  # noqa: F401
from momentum_tpu_torch.tracking.process_markers import (  # noqa: F401
    calibrate_markers, process_markers)
from momentum_tpu_torch.tracking.tracker import (  # noqa: F401
    CameraKeypointData, MarkerSequence, TrackingResult, calibrate_locators, calibrate_model, get_locator_error,
    refine_motion, track_poses_batched, track_poses_for_frames, track_poses_hierarchical,
    track_poses_per_frame, track_sequence)
from momentum_tpu_torch.tracking.tracker_utils import (  # noqa: F401
    compute_floor_contact_constraints, create_locator_character,
    extract_id_and_locators_from_params, extract_locators_from_character,
    extract_markers_from_motion, extract_parameters, fill_identity, is_related_joint,
    remove_identity)
