"""Marker-based mocap tracking, after momentum_tpu/tracking/tracker.py
(momentum/marker_tracking/marker_tracker.cpp):

  trackPosesPerframe (:754-930): frame-by-frame solves, each warm-started
    at the previous frame's result (JAX's lax.scan is a Python loop here,
    the warm start carried as a device tensor);
  trackSequence (:228-700): the whole-sequence solve with smoothness and
    optional universal (calibration) parameters (sequence/solver.py);
  calibrateModel (:1479-1720): alternating rounds of per-frame tracking on
    sampled frames and a universal-parameter sequence solve;
  calibrateLocators: Gauss-Newton on the locator offsets with the poses
    held fixed.

Markers are a (F, M, 3) tensor and a (F, M) occlusion mask; an occluded
marker's constraint has weight 0 (the reference drops it per frame,
marker_tracker.cpp:287-476). 2D keypoints seen by calibrated cameras
(CameraKeypointData, the reference's markerless multi-view input) add one
CameraProjectionErrorFunction per camera over the character's locators,
scaled by config.projection_weight (addKeypointProjectionConstraints,
marker_tracker.cpp:312-366). Every pose solve passes the residual alone,
as JAX's do, so its Jacobian comes by forward mode (solver/gauss_newton.py
`ad_jacobian`), with FK on kernel K1 and the damped solves on K2+K3.

Not ported yet: glove data (tracking/glove_utils.py, ROADMAP M7); a
non-empty `glove_data` raises NotImplementedError. The skinned-locator
branch of `get_locator_error` waits for errors/skinned_locator.py (ROADMAP
M5): the port's Character holds no skinned locators.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.errors import (
    CameraProjectionErrorFunction, CollisionErrorFunction, HeightErrorFunction,
    LimitErrorFunction, ModelParametersErrorFunction, PlaneErrorFunction,
    PositionErrorFunction)
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.sequence import (
    ModelParametersSequenceErrorFunction, SequenceSolverFunction, solve_sequence)
from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
from momentum_tpu_torch.solver.gauss_newton import (
    solve_gauss_newton, solve_levenberg_marquardt)
from momentum_tpu_torch.tracking.config import CalibrationConfig, TrackingConfig
from momentum_tpu_torch.tracking.tracker_utils import (
    _scaling_mask, compute_floor_contact_constraints)

__all__ = ["MarkerSequence", "CameraKeypointData", "TrackingResult", "track_poses_per_frame",
           "track_poses_batched", "track_poses_for_frames", "track_poses_hierarchical",
           "track_sequence", "calibrate_model", "calibrate_locators", "get_locator_error",
           "refine_motion"]

_log = logging.getLogger("momentum_tpu_torch.tracking")


@dataclasses.dataclass(frozen=True, eq=False)
class MarkerSequence:
    """(F, M, 3) marker positions and (F, M) bool occlusion flags, with the
    markers' names."""

    positions: torch.Tensor
    occluded: torch.Tensor
    names: tuple = ()

    @property
    def num_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def num_markers(self) -> int:
        return self.positions.shape[1]


@dataclasses.dataclass(frozen=True, eq=False)
class CameraKeypointData:
    """One camera's 2D keypoints (marker_tracker.h:36-40), in dense form: a
    slot per locator of the character, `targets` (F, L, 2) in pixels and
    `confidence` (F, L), 0 where the keypoint is not observed (the
    reference's per-observation locatorIndex / confidence list)."""

    camera: object  # momentum_tpu_torch.camera.Camera, world-space extrinsics
    targets: torch.Tensor  # (F, L, 2)
    confidence: torch.Tensor  # (F, L)


class TrackingResult(NamedTuple):
    motion: torch.Tensor  # (F, P) model parameters per frame
    errors: torch.Tensor  # (F,) final per-frame energy


def _device(character: Character) -> torch.device:
    return character.parameter_transform.transform.device


def _refuse_unported(glove_data=()):
    if glove_data:
        raise NotImplementedError("glove data needs tracking/glove_utils.py, which the port "
                                  "has not yet (ROADMAP M7)")


def _name_columns(markers: MarkerSequence) -> dict:
    """Marker column per name, "Subject:Marker" namespaces also stripped the
    way the reference's C3D loader does (io/marker/c3d_io.cpp:30-48,167)."""
    name_to_col = {n: i for i, n in enumerate(markers.names)}
    for i, n in enumerate(markers.names):
        if ":" in n:
            name_to_col.setdefault(n.rsplit(":", 1)[-1], i)
    return name_to_col


def _match_names(names, markers: MarkerSequence):
    """(item rows, marker columns) of the named items found among the markers."""
    name_to_col = _name_columns(markers)
    rows = [(i, name_to_col[n]) for i, n in enumerate(names) if n in name_to_col]
    return (np.asarray([r[0] for r in rows], np.int64),
            np.asarray([r[1] for r in rows], np.int64))


def _match_locators(character: Character, markers: MarkerSequence):
    """(locator index, marker column) per matched locator, by name. When no
    name matches and the counts agree, the markers bind to the locators by
    position, with a warning: markers of another rig would give garbage."""
    loc = character.locators
    li, mi = _match_names(loc.names, markers)
    if li.size == 0 and markers.num_markers == loc.num_locators:
        _log.warning(
            "No marker names matched any locator name; falling back to POSITIONAL "
            "marker↔locator binding because counts agree (%d). If markers and character "
            "come from different rigs this will produce garbage. Locator names: %s... "
            "Marker names: %s...", loc.num_locators, list(loc.names)[:5],
            list(markers.names)[:5])
        li = mi = np.arange(loc.num_locators, dtype=np.int64)
    return li, mi


def _marker_error_template(character: Character, markers: MarkerSequence, config):
    """(ef0, per_frame): the matched locators' PositionErrorFunction, and
    per_frame(ef, positions (..., M, 3), occluded (..., M)) giving it the
    frames' targets and the occlusion-zeroed weights (a leading frame axis
    makes it a stacked module)."""
    li, mi = _match_locators(character, markers)
    loc = character.locators
    device = _device(character)
    li_t = torch.as_tensor(li, device=device)
    mi_t = torch.as_tensor(mi, device=device)
    ef0 = PositionErrorFunction.create(
        loc.parent.cpu().numpy()[li], loc.offset.cpu().numpy()[li],
        np.zeros((len(li), 3), np.float32), cweight=loc.weight.cpu().numpy()[li],
        # markerWeight multiplier (marker_tracker.h; 0 disables markers)
        weight=getattr(config, "marker_weight", 1.0),
        loss=GeneralizedLoss(alpha=config.loss_alpha, c=config.loss_c), device=device)
    base_w = loc.weight.index_select(0, li_t)

    def per_frame(ef, positions, occluded):
        w = base_w * (1.0 - occluded.index_select(-1, mi_t).to(base_w.dtype))
        return dataclasses.replace(ef, target=positions.index_select(-2, mi_t), cweight=w)

    return ef0, per_frame


def _keypoint_error_template(character: Character, ckd: CameraKeypointData, config):
    """(ef0, per_frame): a CameraProjectionErrorFunction of ckd's camera over
    the character's locators, weight config.projection_weight, and
    per_frame(ef, targets (..., L, 2), confidence (..., L)) giving it the
    frames' keypoints as targets and their confidences as weights."""
    loc = character.locators
    n = loc.num_locators
    ef0 = CameraProjectionErrorFunction.create(
        ckd.camera, loc.parent.cpu().numpy(), loc.offset.cpu().numpy(),
        np.zeros((n, 2), np.float32), cweight=np.zeros(n, np.float32),
        weight=getattr(config, "projection_weight", 0.0), device=_device(character))

    def per_frame(ef, targets, confidence):
        return dataclasses.replace(ef, target=targets, cweight=confidence)

    return ef0, per_frame


def _keypoint_templates(character: Character, camera_keypoints, config) -> tuple:
    """One (ef0, per_frame) per camera, none when projection_weight is 0."""
    if not camera_keypoints or getattr(config, "projection_weight", 0.0) <= 0:
        return ()
    return tuple(_keypoint_error_template(character, ckd, config) for ckd in camera_keypoints)


def _keypoint_modules(character: Character, camera_keypoints, config) -> tuple:
    """The cameras' keypoint modules stacked over the frames of the
    keypoint data (the sequence solves' per-frame modules)."""
    return tuple(per_frame(ef0, ckd.targets, ckd.confidence)
                 for (ef0, per_frame), ckd in zip(
                     _keypoint_templates(character, camera_keypoints, config),
                     camera_keypoints))


def _floor_rows(character: Character, prefix: str = "Floor_"):
    """(parents, offsets, cweights) of the Floor_ locators, weighted
    loc.weight × 5 (plane_error_function.cpp:15 createFloorConstraints), or
    None when the rig has none."""
    loc = character.locators
    if loc is None:
        return None
    idx = [i for i, n in enumerate(loc.names) if n.startswith(prefix)]
    if not idx:
        return None
    return (loc.parent.cpu().numpy()[idx], loc.offset.cpu().numpy()[idx],
            loc.weight.cpu().numpy()[idx] * 5.0)


def _floor_error(character: Character, half_plane: bool = True, weight: float = 1.0):
    """PlaneErrorFunction over the Floor_ locators against the y-up plane at
    0, or None: half-plane for non-penetration (tracking), equality to pin
    them to the floor (the first-frame pin, adaptive contacts)."""
    rows = _floor_rows(character)
    if rows is None:
        return None
    parents, offsets, cw = rows
    n = len(parents)
    return PlaneErrorFunction.create(
        parents, offsets, np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1)),
        np.zeros(n, np.float32), cweight=cw, weight=weight, half_plane=half_plane,
        device=_device(character))


def _pose_mask(character: Character, config, enabled_mask):
    """The default tracking mask: pose parameters only, the identity
    (scaling) parameters frozen (the reference solves pose while tracking;
    calibration estimates the scale)."""
    if enabled_mask is not None or not config.freeze_scaling:
        return enabled_mask
    mask = (~_scaling_mask(character)).astype(np.float32)
    return torch.as_tensor(mask, device=_device(character))


def _solver_for(config):
    return (solve_levenberg_marquardt
            if config.method in ("levenberg_marquardt", "trust_region")
            else solve_gauss_newton)


class _FrameSolve(NamedTuple):
    """What every pose solve of one clip shares: the marker template, the
    modules beside it (limits and the floor), the keypoint templates, the
    keypoint data of every frame and the solver's settings."""

    character: Character
    ef0: PositionErrorFunction
    per_frame: object
    others: tuple
    kp: tuple  # one (ef0, per_frame) per camera
    kp_data: tuple  # one (targets (F, L, 2), confidence (F, L)) per camera
    opts: SolverOptions
    mask: Optional[torch.Tensor]
    solver: object

    def __call__(self, positions, occluded, x0, iters=None, lam0=None, rows=slice(None)):
        """One solve of the frames `positions` (..., M, 3) from x0 (..., P),
        their keypoints the frames `rows` of kp_data; lam0 resumes an LM
        solve's damping."""
        ef = self.per_frame(self.ef0, positions, occluded)
        kp_efs = tuple(pf(e0, t[rows], c[rows])
                       for (e0, pf), (t, c) in zip(self.kp, self.kp_data))
        fn = SkeletonSolverFunction(self.character, (ef,) + self.others + kp_efs)
        opts = self.opts if iters is None else dataclasses.replace(self.opts,
                                                                   max_iterations=iters)
        if lam0 is not None and self.solver is solve_levenberg_marquardt:
            return self.solver(fn.residual, fn.error, x0, self.mask, opts, lambda0=lam0)
        return self.solver(fn.residual, fn.error, x0, self.mask, opts)


def _frame_solve(character: Character, markers: MarkerSequence, config, enabled_mask,
                 camera_keypoints=()) -> _FrameSolve:
    ef0, per_frame = _marker_error_template(character, markers, config)
    limits = LimitErrorFunction.create(device=_device(character))
    fl = _floor_error(character) if getattr(config, "floor_constraints", True) else None
    kp = _keypoint_templates(character, camera_keypoints, config)
    kp_data = tuple((ckd.targets, ckd.confidence) for ckd in camera_keypoints) if kp else ()
    return _FrameSolve(
        character, ef0, per_frame, (limits,) + (() if fl is None else (fl,)), kp, kp_data,
        SolverOptions(max_iterations=config.max_iter, regularization=config.regularization),
        _pose_mask(character, config, enabled_mask), _solver_for(config))


def _initial(character: Character, initial) -> torch.Tensor:
    if initial is None:
        return torch.zeros(character.num_model_parameters, device=_device(character))
    return torch.as_tensor(initial, device=_device(character))


def _warm_started(solve: _FrameSolve, markers: MarkerSequence, x: torch.Tensor):
    """Solve the frames in order, each from the previous result; a result
    that is not finite reverts to its warm start (tensor_ik.cpp:168-175),
    on the device. → (motion (F, P), errors (F,))."""
    motion, errors = [], []
    for f in range(markers.num_frames):
        res = solve(markers.positions[f], markers.occluded[f], x, rows=f)
        x = torch.where(torch.isfinite(res.params).all(), res.params, x)
        motion.append(x)
        errors.append(res.error)
    return torch.stack(motion), torch.stack(errors)


def track_poses_per_frame(
    character: Character,
    markers: MarkerSequence,
    config: TrackingConfig = TrackingConfig(),
    initial: Optional[torch.Tensor] = None,
    enabled_mask: Optional[torch.Tensor] = None,
    frame_stride: int = 1,
    camera_keypoints: tuple = (),
    glove_data: tuple = (),
    glove_config=None,
) -> TrackingResult:
    """Frame-by-frame tracking with warm starts (trackPosesPerframe,
    marker_tracker.cpp:754-930). `frame_stride` > 1 solves every Nth frame
    and repeats each solved pose up to the next (:753-790; a stride under 5
    keeps the solved frames warm-starting each other), markers alone, as
    JAX's. `camera_keypoints`: CameraKeypointData of the same frames."""
    _refuse_unported(glove_data)
    if frame_stride > 1:
        f = markers.num_frames
        x_init = _initial(character, initial)
        init_motion = x_init.expand(f, -1) if x_init.ndim == 1 else x_init
        return track_poses_for_frames(
            character, markers, init_motion, config, np.arange(0, f, frame_stride),
            is_continuous=frame_stride < 5, enabled_mask=enabled_mask)
    markers = _mask_low_visibility(markers, config.min_vis_percent)
    solve = _frame_solve(character, markers, config, enabled_mask, camera_keypoints)
    motion, errors = _warm_started(solve, markers, _initial(character, initial))
    return TrackingResult(motion=motion, errors=errors)


def track_poses_batched(
    character: Character,
    markers: MarkerSequence,
    config: TrackingConfig = TrackingConfig(),
    initial: Optional[torch.Tensor] = None,
    enabled_mask: Optional[torch.Tensor] = None,
    camera_keypoints: tuple = (),
) -> TrackingResult:
    """All frames solved at once and independently (no warm start), one
    batched solve. With config.refine = (k_full, r_refine, capacity): k_full
    iterations on every frame, then r_refine more on the `capacity` frames
    of the highest energy, their LM damping carried (solver/compaction.py's
    economics). `camera_keypoints`: CameraKeypointData of the same frames."""
    markers = _mask_low_visibility(markers, config.min_vis_percent)
    solve = _frame_solve(character, markers, config, enabled_mask, camera_keypoints)
    f_cnt, p = markers.num_frames, character.num_model_parameters
    x0 = _initial(character, initial)
    x_b = x0.expand(f_cnt, p) if x0.ndim == 1 else x0
    if config.refine is None:
        res = solve(markers.positions, markers.occluded, x_b)
        return TrackingResult(motion=res.params, errors=res.error)

    k_full, r_refine, capacity = config.refine
    capacity = min(int(capacity), f_cnt)
    lam_init = torch.full((f_cnt,), solve.opts.lambda_init, device=x_b.device)
    res1 = solve(markers.positions, markers.occluded, x_b, k_full, lam_init)
    lam1 = res1.lambda_final if res1.lambda_final is not None else lam_init
    key = torch.nan_to_num(res1.error, nan=3e38, posinf=3e38)
    idx = torch.topk(key, capacity).indices
    res2 = solve(markers.positions[idx], markers.occluded[idx], res1.params[idx], r_refine,
                 lam1[idx], rows=idx)
    return TrackingResult(motion=res1.params.index_copy(0, idx, res2.params),
                          errors=res1.error.index_copy(0, idx, res2.error))


def track_poses_for_frames(
    character: Character,
    markers: MarkerSequence,
    initial_motion: torch.Tensor,
    config: TrackingConfig = TrackingConfig(),
    frame_indices=None,
    is_continuous: bool = False,
    enabled_mask: Optional[torch.Tensor] = None,
) -> TrackingResult:
    """Solve only the given frames (trackPosesForFrames,
    marker_tracker.cpp:848-1068): with `is_continuous` each solved frame
    warm-starts the next; otherwise each starts from its own
    `initial_motion` row. The motion spans ALL frames: an unsolved frame
    repeats the next solved frame at or after it, the tail the last solve
    (the reference's outputIndex fill, :1040-1049)."""
    f_all = markers.num_frames
    initial_motion = torch.as_tensor(initial_motion, device=_device(character))
    if frame_indices is None:
        frame_indices = np.arange(f_all)
    sorted_idx = np.unique(np.asarray(frame_indices, np.int64))
    markers = _mask_low_visibility(markers, config.min_vis_percent)
    sel = torch.as_tensor(sorted_idx, device=markers.positions.device)
    sub = MarkerSequence(positions=markers.positions[sel], occluded=markers.occluded[sel],
                         names=markers.names)
    solve = _frame_solve(character, sub, config, enabled_mask)
    inits = initial_motion[torch.as_tensor(sorted_idx, device=initial_motion.device)]
    if is_continuous:
        solved, errors = _warm_started(solve, sub, inits[0])
    else:
        res = solve(sub.positions, sub.occluded, inits)
        bad = ~torch.isfinite(res.params).all(dim=-1, keepdim=True)
        solved, errors = torch.where(bad, inits, res.params), res.error
    seg = np.minimum(np.searchsorted(sorted_idx, np.arange(f_all), "left"),
                     len(sorted_idx) - 1)
    seg_t = torch.as_tensor(seg, device=solved.device)
    return TrackingResult(motion=solved[seg_t], errors=errors[seg_t])


def track_poses_hierarchical(
    character: Character,
    markers: MarkerSequence,
    config: TrackingConfig = TrackingConfig(),
    initial: Optional[torch.Tensor] = None,
    enabled_mask: Optional[torch.Tensor] = None,
    stride: int = 8,
) -> TrackingResult:
    """Keyframe-warm-started batched tracking: every `stride`-th frame (and
    the last) by the warm-started chain (track_poses_for_frames with
    is_continuous), the keyframe solutions linearly interpolated into every
    frame's start, then all frames refined at once (track_poses_batched).
    O(F/stride) serial solves and one batched solve."""
    f, p = markers.num_frames, character.num_model_parameters
    stride = int(max(stride, 1))
    keys = np.arange(0, f, stride)
    if keys[-1] != f - 1:
        keys = np.append(keys, f - 1)
    init0 = _initial(character, initial)
    if init0.ndim == 1:
        init0 = init0.expand(f, p)
    key_res = track_poses_for_frames(character, markers, init0, config, frame_indices=keys,
                                     is_continuous=True, enabled_mask=enabled_mask)
    km = key_res.motion[torch.as_tensor(keys, device=key_res.motion.device)]  # (K, P)
    if len(keys) == 1:
        init_all = km[0].expand(f, p)
    else:
        t = np.arange(f)
        seg = np.clip(np.searchsorted(keys, t, "right") - 1, 0, len(keys) - 2)
        lo, hi = keys[seg], keys[seg + 1]
        w = torch.as_tensor(((t - lo) / np.maximum(hi - lo, 1))[:, None], dtype=km.dtype,
                            device=km.device)
        seg_t = torch.as_tensor(seg, device=km.device)
        init_all = km[seg_t] * (1 - w) + km[seg_t + 1] * w
    return track_poses_batched(character, markers, config, initial=init_all,
                               enabled_mask=enabled_mask)


def get_locator_error(character: Character, markers: MarkerSequence, motion: torch.Tensor):
    """(average per-frame marker error, max marker error) of a motion
    against the markers (getLocatorError, marker_tracker.cpp:1978-2082): per
    frame the mean distance over the visible matched markers, averaged over
    the frames with at least one."""
    f = markers.num_frames
    loc = character.locators
    if loc is None:
        return 0.0, 0.0
    li, mi = _match_names(loc.names, markers)
    if not li.size:
        return 0.0, 0.0
    device = markers.positions.device
    li_t, mi_t = torch.as_tensor(li, device=device), torch.as_tensor(mi, device=device)
    states = character.skeleton_states(torch.as_tensor(motion, device=device)[:f])
    world = ss.transform_points(states.index_select(-2, loc.parent.long()[li_t]),
                                loc.offset[li_t])
    vis = 1.0 - markers.occluded.index_select(-1, mi_t).float()
    norms = torch.linalg.vector_norm(world - markers.positions.index_select(-2, mi_t),
                                     dim=-1) * vis
    count = torch.sum(vis, dim=-1)
    frame_err = torch.sum(norms, dim=-1) / torch.clamp(count, min=1.0)
    n_valid = torch.clamp(torch.sum((count > 0).float()), min=1.0)
    avg = torch.sum(torch.where(count > 0, frame_err, 0.0)) / n_valid
    return float(avg), float(torch.max(norms))


def track_sequence(
    character: Character,
    markers: MarkerSequence,
    config: TrackingConfig = TrackingConfig(),
    universal: Optional[np.ndarray] = None,
    initial: Optional[torch.Tensor] = None,
    extra_per_frame_errors: tuple = (),
    extra_sequence_errors: tuple = (),
    camera_keypoints: tuple = (),
    glove_data: tuple = (),
    glove_config=None,
):
    """Whole-sequence solve with smoothness (trackSequence,
    marker_tracker.cpp:228-700) → (TrackingResult, universal values).
    `extra_per_frame_errors` are stacked per-frame modules added to the
    marker and limit set (calibration's first-frame constraints), after
    the collision term (config.collision_error_weight > 0 and a character
    with collision geometry) and the floor; the cameras' keypoint modules
    follow them."""
    _refuse_unported(glove_data)
    f, p = markers.num_frames, character.num_model_parameters
    device = _device(character)
    markers = _mask_low_visibility(markers, config.min_vis_percent)
    ef0, per_frame = _marker_error_template(character, markers, config)
    seq_errors = tuple(extra_sequence_errors)
    if config.smoothing > 0:
        pweight = (np.asarray(config.smoothing_weights, np.float32)
                   if config.smoothing_weights else None)
        seq_errors = seq_errors + (ModelParametersSequenceErrorFunction.create(
            p, pweight=pweight, weight=config.smoothing, device=device),)
    per_frame_errors = [per_frame(ef0, markers.positions, markers.occluded),
                        LimitErrorFunction.create(device=device)]
    if config.collision_error_weight > 0 and character.collision is not None:
        per_frame_errors.append(CollisionErrorFunction.create(
            character, weight=config.collision_error_weight, device=device))
    if getattr(config, "floor_constraints", True):
        fl = _floor_error(character)
        if fl is not None:
            per_frame_errors.append(fl)
    per_frame_errors.extend(extra_per_frame_errors)
    per_frame_errors.extend(_keypoint_modules(character, camera_keypoints, config))

    fn = SequenceSolverFunction.create(character, f, universal=universal,
                                       per_frame_errors=tuple(per_frame_errors),
                                       sequence_errors=seq_errors)
    if initial is not None:
        pf0, u0 = fn.split(torch.as_tensor(initial, device=device))
    else:
        pf0 = torch.zeros((f, fn.num_per_frame), device=device)
        u0 = torch.zeros((fn.num_universal,), device=device)
    res = solve_sequence(fn, pf0, u0, SolverOptions(
        max_iterations=config.max_iter, regularization=config.regularization,
        # plain GN can overshoot the log2 scale on mm-scale uncalibrated
        # data; Armijo backtracking (sequence_solver.cpp:531-555) keeps the
        # universal solve in range
        do_line_search=(config.line_search or config.method != "gauss_newton")))
    return _sequence_result(fn, res, pf0, u0)


def _sequence_result(fn: SequenceSolverFunction, res, pf0, u0):
    """(TrackingResult, universal) of a sequence solve, a part that is not
    finite reverted to its start (tensor_ik.cpp:168-175), on the device."""
    pf = torch.where(torch.isfinite(res.per_frame).all(), res.per_frame, pf0)
    u = torch.where(torch.isfinite(res.universal).all(), res.universal, u0)
    return TrackingResult(motion=fn.join(pf, u),
                          errors=res.error.expand(fn.num_frames)), u


def _mask_low_visibility(markers: MarkerSequence, min_vis_percent: float) -> MarkerSequence:
    """Frames with fewer visible markers than the threshold become fully
    occluded, so they are skipped (marker_tracker.h minVisPercent)."""
    if min_vis_percent <= 0:
        return markers
    frac = torch.mean(1.0 - markers.occluded.float(), dim=-1)
    skip = frac * 100.0 < min_vis_percent
    return dataclasses.replace(markers, occluded=markers.occluded | skip[:, None])


def _calibration_extras(character: Character, config, f: int) -> tuple:
    """Stacked first-frame calibration constraints (addSequenceErrorFunctions,
    marker_tracker.cpp:392-463), each active on frame 0 alone with weight ×
    the frame count, so that a shared constraint counts once:

    - target_height_cm → HeightErrorFunction (:422-428);
    - enforce_floor_in_first_frame → the equality floor pin (:431-438);
    - first_frame_pose_constraint_set → the pose constraints as targets
      (:454-461), when the parameter transform holds that set.

    The frame weight rides the module's per-constraint weights where it has
    them (the floor's cweight, the pose constraints' pweight), its weight
    otherwise: the same energy and rows as JAX's per-frame `weight`."""
    device = _device(character)
    first_np = np.zeros(f, np.float32)
    first_np[0] = float(f)
    first = torch.as_tensor(first_np, device=device)
    extras = []
    if config.target_height_cm > 0 and character.mesh is not None:
        h0 = HeightErrorFunction.create(config.target_height_cm, device=device)
        extras.append(dataclasses.replace(h0, weight=first))
    if config.enforce_floor_in_first_frame:
        fl = _floor_error(character, half_plane=False)
        if fl is not None:
            extras.append(dataclasses.replace(fl, cweight=first[:, None] * fl.cweight))
    pcs = config.first_frame_pose_constraint_set
    pc = getattr(character.parameter_transform, "pose_constraints", None) or {}
    if pcs and pcs in pc:
        p = character.num_model_parameters
        target, mask = np.zeros(p, np.float32), np.zeros(p, np.float32)
        for i, v in pc[pcs]:
            target[i], mask[i] = v, 1.0
        m0 = ModelParametersErrorFunction.create(target, pweight=mask, device=device)
        extras.append(dataclasses.replace(m0, pweight=first[:, None] * m0.pweight))
    return tuple(extras)


def _adaptive_floor_contacts(character: Character, config, motion: torch.Tensor):
    """Equality floor constraints of 3× weight on the detected contact
    frames (marker_tracker.cpp:449-453 perFrameFloorContacts, detection at
    tracker_utils.cpp:944-1002): a stacked PlaneErrorFunction whose cweight
    is the contact mask times the floor weights, or None."""
    rows = _floor_rows(character)
    if rows is None:
        return None
    parents, offsets, cw = rows
    contact, _ = compute_floor_contact_constraints(
        character, motion, parents, offsets, percentile=config.floor_contact_percentile)
    fl = _floor_error(character, half_plane=False, weight=3.0)
    return dataclasses.replace(fl, cweight=contact.float() * fl.cweight)


def calibrate_model(
    character: Character,
    markers: MarkerSequence,
    config: CalibrationConfig = CalibrationConfig(),
    scaling_set: str = "scaling",
    initial: Optional[torch.Tensor] = None,
    camera_keypoints: tuple = (),
):
    """Alternating identity calibration (calibrateModel,
    marker_tracker.cpp:1479-1720): sample frames, then major_iter rounds of
    {per-frame tracking → universal-scale sequence solve}.

    `scaling_set` names the parameter set of the identity parameters
    (else every parameter named like a scale). Returns (identity (P,),
    motion); with config.locators_only the locator offsets are re-estimated
    instead of the scale and the refined character comes third.
    `camera_keypoints`: CameraKeypointData of the same frames, sampled with
    the markers."""
    f_all = markers.num_frames
    n_sample = min(config.calib_frames, f_all)
    if config.greedy_sampling > 0:
        # most-visible first, at least greedy_sampling frames apart
        vis = (1.0 - markers.occluded.float()).mean(-1).cpu().numpy()
        picked = []
        for fidx in np.argsort(-vis):
            if all(abs(int(fidx) - q) >= config.greedy_sampling for q in picked):
                picked.append(int(fidx))
            if len(picked) >= n_sample:
                break
        idx = np.sort(np.asarray(picked, np.int64))
    else:
        idx = np.arange(0, f_all, max(1, f_all // n_sample))[:n_sample]
    sel = torch.as_tensor(idx, device=markers.positions.device)
    sampled = MarkerSequence(positions=markers.positions[sel],
                             occluded=markers.occluded[sel], names=markers.names)
    sampled_kp = tuple(CameraKeypointData(camera=ckd.camera, targets=ckd.targets[sel],
                                          confidence=ckd.confidence[sel])
                       for ckd in camera_keypoints)

    pt = character.parameter_transform
    universal = _scaling_mask(character, scaling_set)
    if config.global_scale_only:
        keep = np.asarray([bool(universal[i]) and "global" in n.lower()
                           for i, n in enumerate(pt.names)])
        universal = keep if keep.any() else universal
    if config.calib_shape and character.blend_shape_param_index:
        universal[list(character.blend_shape_param_index)] = True

    track_cfg = TrackingConfig(
        loss_alpha=config.loss_alpha, loss_c=config.loss_c, max_iter=config.max_iter,
        regularization=config.regularization, method=config.method,
        freeze_scaling=config.freeze_scaling,
        projection_weight=getattr(config, "projection_weight", 0.0), line_search=True)

    if config.enforce_floor_in_first_frame and config.adaptive_floor_contact:
        raise ValueError("enforce_floor_in_first_frame and adaptive_floor_contact are "
                         "exclusive")
    extras_static = _calibration_extras(character, config, len(idx))

    identity = _initial(character, initial)
    u_idx = torch.as_tensor(np.nonzero(universal)[0], device=identity.device)
    motion = None
    for _ in range(config.major_iter):
        tracked = track_poses_per_frame(character, sampled, track_cfg, initial=identity,
                                        camera_keypoints=sampled_kp)
        if config.locators_only:
            # refine only the locator offsets against the tracked poses
            character = calibrate_locators(character, sampled, tracked.motion, config)
            motion = tracked.motion
            continue
        extras = extras_static
        if config.adaptive_floor_contact:
            ad = _adaptive_floor_contacts(character, config, tracked.motion)
            if ad is not None:
                extras = extras_static + (ad,)
        # the keypoints ride the scale's sequence solve as stacked modules
        extras = extras + _keypoint_modules(character, sampled_kp, track_cfg)
        seq_res, u = track_sequence(character, sampled, track_cfg, universal=universal,
                                    initial=tracked.motion, extra_per_frame_errors=extras)
        identity = identity.index_copy(0, u_idx, u)
        motion = seq_res.motion
    if config.locators_only:
        return identity, motion, character
    return identity, motion


def calibrate_locators(
    character: Character,
    markers: MarkerSequence,
    motion: torch.Tensor,
    config: CalibrationConfig = CalibrationConfig(),
    iterations: int = 10,
):
    """Refine the locator offsets against a tracked motion
    (calibrateLocators): Gauss-Newton on the offsets with the poses held
    fixed, each step a closed-form 3×3 solve per locator from the clip
    energy's gradient and its Hessian's diagonal blocks (3 Hessian-vector
    products). FK runs once, outside the differentiated energy, which is
    then a function of the offsets alone."""
    li, mi = _match_locators(character, markers)
    loc = character.locators
    device = markers.positions.device
    li_t, mi_t = torch.as_tensor(li, device=device), torch.as_tensor(mi, device=device)
    states = character.skeleton_states(motion)  # (F, nJ, 8)
    st = states.index_select(-2, loc.parent.long()[li_t])  # (F, L, 8)
    tgt = markers.positions.index_select(-2, mi_t)
    w = loc.weight[li_t] * (1.0 - markers.occluded.index_select(-1, mi_t).float())

    def energy(offsets):
        world = ss.transform_points(st, offsets)
        return torch.sum(w * torch.sum((world - tgt) ** 2, dim=-1))

    grad = torch.func.grad(energy)
    eye = torch.eye(3, device=device)
    offsets = loc.offset[li_t]
    for _ in range(iterations):
        g = grad(offsets)
        cols = torch.stack([torch.func.jvp(grad, (offsets,), (eye[i].expand_as(offsets),))[1]
                            for i in range(3)], dim=-1)  # (L, 3, 3)
        offsets = offsets - torch.linalg.solve(cols + 1e-8 * eye, g[..., None])[..., 0]
    new_loc = dataclasses.replace(loc, offset=loc.offset.index_copy(0, li_t, offsets))
    return dataclasses.replace(character, locators=new_loc)


def refine_motion(
    character: Character,
    markers: MarkerSequence,
    motion: torch.Tensor,
    config=None,
    camera_keypoints: tuple = (),
):
    """Refine a motion against the markers (refineMotion,
    marker_tracker.cpp): the whole-sequence solve warm-started at `motion`,
    with an optional per-frame pull toward it and an optional identity
    re-calibration (RefineConfig.calib_id). With config.f64 (the default)
    the normal equations accumulate and factor in float64, JAX's x64 scope
    (ROADMAP F13); FK and the rows stay float32, as in JAX, whose inputs
    are float32 arrays there too. `camera_keypoints`: CameraKeypointData of
    the same frames. → (TrackingResult, universal values)."""
    from momentum_tpu_torch.tracking.config import RefineConfig

    config = config or RefineConfig()
    f, p = markers.num_frames, character.num_model_parameters
    device = _device(character)
    markers = _mask_low_visibility(markers, config.min_vis_percent)
    ef0, per_frame = _marker_error_template(character, markers, config)
    per_frame_errors = [per_frame(ef0, markers.positions, markers.occluded),
                        LimitErrorFunction.create(device=device)]
    per_frame_errors.extend(_keypoint_modules(character, camera_keypoints, config))
    if config.regularizer > 0:
        reg0 = ModelParametersErrorFunction.create(np.zeros(p, np.float32),
                                                   weight=config.regularizer, device=device)
        per_frame_errors.append(dataclasses.replace(reg0, target=motion))
    seq_errors = ()
    if config.smoothing > 0:
        pweight = (np.asarray(config.smoothing_weights, np.float32)
                   if config.smoothing_weights else None)
        seq_errors = (ModelParametersSequenceErrorFunction.create(
            p, pweight=pweight, weight=config.smoothing, device=device),)
    universal = _scaling_mask(character) if config.calib_id else None
    fn = SequenceSolverFunction.create(character, f, universal=universal,
                                       per_frame_errors=tuple(per_frame_errors),
                                       sequence_errors=seq_errors)
    pf0, u0 = fn.split(motion)
    use_f64 = getattr(config, "f64", True)
    opts = SolverOptions(
        max_iterations=config.max_iter, regularization=config.regularization,
        do_line_search=(config.line_search or config.method != "gauss_newton"),
        # the smoothing-dominated refine system is near-singular at float32
        # resolution: float64 normal equations, or LM-style 1e-5 jitter
        f64_normal_equations=use_f64, equilibrated_jitter=None if use_f64 else 1e-5)
    return _sequence_result(fn, solve_sequence(fn, pf0, u0, opts), pf0, u0)
