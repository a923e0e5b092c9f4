"""Marker tracking: calibration, per-frame, batched and hierarchical
tracking, the sequence refine, glove fusion, skinned-locator conversion and
the marker pipeline, from arrays or from files (`process_marker_file`, the
process-markers CLI in tracking/process_markers_app.py)."""

from momentum_tpu_torch.tracking.cmu import CMU_MARKER_MAP, create_cmu_character  # noqa: F401
from momentum_tpu_torch.tracking.config import (  # noqa: F401
    BaseConfig, CalibrationConfig, RefineConfig, TrackingConfig)
from momentum_tpu_torch.tracking.gap_fill import fill_marker_gaps  # noqa: F401
from momentum_tpu_torch.tracking.process_markers import (  # noqa: F401
    calibrate_markers, process_marker_file, process_markers, save_motion)
from momentum_tpu_torch.tracking.tracker import (  # noqa: F401
    CameraKeypointData, MarkerSequence, TrackingResult, calibrate_locators, calibrate_model, get_locator_error,
    refine_motion, track_poses_batched, track_poses_for_frames, track_poses_hierarchical,
    track_poses_per_frame, track_sequence)
from momentum_tpu_torch.tracking.tracker_utils import (  # noqa: F401
    average_triangle_skin_weights, closest_point_on_mesh_matching_parent,
    compute_floor_contact_constraints, create_locator_character,
    extract_id_and_locators_from_params, extract_locators_from_character,
    extract_markers_from_motion, extract_parameters, fill_identity, is_related_joint,
    locators_to_skinned_locators, remove_identity, skinned_locators_to_locators)
from momentum_tpu_torch.tracking.app_utils import (  # noqa: F401
    load_character, load_character_with_identity)
from momentum_tpu_torch.tracking import glove_utils  # noqa: F401

# pymomentum's marker_tracking spellings of the locator converters
# (marker_tracking_pybind.cpp:996-1050)
from momentum_tpu_torch.tracking.tracker_utils import (  # noqa: F401,E402
    locators_to_skinned_locators as convert_locators_to_skinned_locators,
    skinned_locators_to_locators as convert_skinned_locators_to_locators)
