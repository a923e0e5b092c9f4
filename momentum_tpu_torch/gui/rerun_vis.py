"""Rerun.io logging of characters, motions and markers — the port of
momentum_tpu/gui/rerun_vis.py, taking torch tensors (copied to the host at
the logging boundary).

Mirror of the reference's rerun surface — momentum/gui/rerun/logger.h
(logCharacter/logMarkerLocators/logModelParams + the batched
logModelParamsColumns/send_columns fast path, logger.h:100-163) and
pymomentum/rerun_vis.py (log_mesh/log_joints/log_locators/
log_collision_geometry/log_character/log_animation).

The rerun SDK is an optional dependency: when `import rerun` succeeds every
call logs real archetypes to a RecordingStream (viewer, .rrd file, ...).
When it is absent (headless images), `make_recording()` returns an in-process
`FallbackRecording` that captures the identical (entity_path, archetype,
payload, timeline) stream and can save it as a self-describing .npz — the
full logging surface stays exercisable and testable without the SDK, and a
saved capture can be replayed into a real stream later with `replay()`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from momentum_tpu_torch.device import to_host

__all__ = [
    "rerun_available", "make_recording", "FallbackRecording",
    "log_marker_locator_correspondence",
    "log_mesh", "log_joints", "log_locators", "log_markers",
    "log_collision_geometry", "log_character", "log_model_params",
    "log_animation", "log_motion", "replay",
]


def _try_rerun():
    try:
        import rerun as rr  # type: ignore

        return rr
    except Exception:
        return None


def rerun_available() -> bool:
    return _try_rerun() is not None


@dataclasses.dataclass
class _Entry:
    path: str
    archetype: str  # "points3d" | "linestrips3d" | "mesh3d" | "scalar" | ...
    payload: dict  # name -> np.ndarray (or list for strips)
    time: Optional[tuple] = None  # (timeline, value)
    static: bool = False


class FallbackRecording:
    """In-process stand-in for rerun.RecordingStream: captures the log
    stream; `save()` writes a self-describing .npz archive."""

    def __init__(self, application_id: str = "momentum_tpu"):
        self.application_id = application_id
        self.entries: list[_Entry] = []
        self._time: Optional[tuple] = None

    # -- rerun-like surface --
    def set_time(self, timeline: str, *, sequence=None, timestamp=None):
        self._time = (timeline, sequence if sequence is not None else timestamp)

    def log(self, path: str, archetype: str, payload: dict, static=False):
        payload = {k: (to_host(v) if not isinstance(v, (list, tuple, str))
                       else v) for k, v in payload.items()}
        self.entries.append(_Entry(path, archetype, payload, self._time, static))

    def save(self, path: str):
        """Flat .npz: entry i's payload key k stored as 'i/k', with a json
        index of paths/archetypes/times."""
        import json

        arrays = {}
        index = []
        for i, e in enumerate(self.entries):
            keys = {}
            for k, v in e.payload.items():
                if isinstance(v, (list, tuple)):
                    v = np.asarray(v, dtype=object) if any(
                        isinstance(x, np.ndarray) for x in v) else np.asarray(v)
                if isinstance(v, str):
                    keys[k] = {"str": v}
                    continue
                arrays[f"{i}/{k}"] = v
                keys[k] = {"array": f"{i}/{k}"}
            index.append({"path": e.path, "archetype": e.archetype,
                          "time": e.time, "static": e.static, "keys": keys})
        arrays["__index__"] = np.frombuffer(
            json.dumps(index).encode(), dtype=np.uint8)
        np.savez_compressed(path, **{k: np.asarray(v, dtype=object)
                                     if getattr(v, "dtype", None) == object
                                     else v for k, v in arrays.items()})

    # stats used by tests
    def paths(self):
        return sorted({e.path for e in self.entries})

    def count(self, archetype=None):
        return sum(1 for e in self.entries
                   if archetype is None or e.archetype == archetype)


class _RerunRec:
    """Adapter from the internal (path, archetype, payload) calls to real
    rerun archetypes."""

    def __init__(self, rr, stream):
        self.rr = rr
        self.stream = stream

    def set_time(self, timeline: str, *, sequence=None, timestamp=None):
        rr = self.rr
        if sequence is not None:
            rr.set_time_sequence(timeline, int(sequence), recording=self.stream)
        else:
            rr.set_time_seconds(timeline, float(timestamp), recording=self.stream)

    def log(self, path: str, archetype: str, payload: dict, static=False):
        rr = self.rr
        if archetype == "points3d":
            obj = rr.Points3D(payload["positions"],
                              radii=payload.get("radii"),
                              colors=payload.get("colors"),
                              labels=payload.get("labels"))
        elif archetype == "linestrips3d":
            obj = rr.LineStrips3D(payload["strips"],
                                  colors=payload.get("colors"))
        elif archetype == "mesh3d":
            obj = rr.Mesh3D(vertex_positions=payload["vertices"],
                            triangle_indices=payload["faces"],
                            vertex_normals=payload.get("normals"),
                            vertex_colors=payload.get("colors"))
        elif archetype == "scalar":
            obj = rr.Scalars(payload["value"]) if hasattr(rr, "Scalars") \
                else rr.Scalar(float(np.asarray(payload["value"]).reshape(()))
                               )
        elif archetype == "text":
            obj = rr.TextLog(payload["text"])
        else:
            raise ValueError(f"unknown archetype {archetype}")
        rr.log(path, obj, static=static, recording=self.stream)


def make_recording(application_id: str = "momentum_tpu",
                   save_path: Optional[str] = None, spawn: bool = False):
    """A recording stream: real rerun when the SDK is importable (optionally
    saving to .rrd / spawning a viewer), else a FallbackRecording."""
    rr = _try_rerun()
    if rr is None:
        return FallbackRecording(application_id)
    stream = rr.new_recording(application_id=application_id)
    if save_path:
        rr.save(save_path, recording=stream)
    if spawn:
        rr.spawn(recording=stream)
    return _RerunRec(rr, stream)


# ---------------------------------------------------------------- loggers



def _np(a):
    return np.asarray(to_host(a), np.float32)


def log_mesh(rec, path: str, vertices, faces, normals=None, colors=None):
    """pymomentum/rerun_vis.py log_mesh."""
    payload = {"vertices": _np(vertices), "faces": np.asarray(to_host(faces), np.int32)}
    if normals is not None:
        payload["normals"] = _np(normals)
    if colors is not None:
        payload["colors"] = to_host(colors)
    rec.log(path, "mesh3d", payload)


def log_joints(rec, path: str, character, skel_states):
    """Skeleton as line segments parent→child + joint points
    (pymomentum/rerun_vis.py log_joints)."""
    pos = to_host(skel_states[..., :3])
    parents = character.skeleton.parents_np
    strips = [np.stack([pos[p], pos[j]]) for j, p in enumerate(parents) if p >= 0]
    rec.log(path + "/bones", "linestrips3d", {"strips": strips})
    rec.log(path + "/joints", "points3d", {"positions": pos})


def log_locators(rec, path: str, character, skel_states, color=None):
    """World-space locator positions (logMarkerLocators, logger.h:117-125)."""
    world = to_host(character.locators.world_positions(skel_states))
    payload = {"positions": world, "labels": list(character.locators.names)}
    if color is not None:
        payload["colors"] = to_host(color)
    rec.log(path, "points3d", payload)


def log_markers(rec, path: str, positions, occluded=None, names=()):
    """One frame of mocap markers; occluded markers are dropped
    (logMarkers semantics)."""
    pos = _np(positions)
    if occluded is not None:
        pos = pos[~to_host(occluded)]
    rec.log(path, "points3d", {"positions": pos, "labels": list(names)})


def log_marker_locator_correspondence(rec, path: str, character,
                                      skel_states, marker_positions,
                                      marker_names, occluded=None,
                                      error_threshold: float = float("inf")):
    """Line segments from each visible marker to its same-named locator
    (logMarkerLocatorCorrespondence, logger.h:79-86). Pairs whose distance
    exceeds `error_threshold` are colored as outliers; unmatched names are
    skipped."""
    loc = character.locators
    if loc is None or loc.num_locators == 0:
        return
    lookup = {n: i for i, n in enumerate(loc.names)}
    world = to_host(loc.world_positions(skel_states))
    pos = _np(marker_positions)
    occ = np.zeros(len(pos), bool) if occluded is None \
        else np.asarray(to_host(occluded), bool)
    strips, colors = [], []
    for m, name in enumerate(marker_names):
        i = lookup.get(name)
        if i is None or occ[m]:
            continue
        strips.append(np.stack([pos[m], world[i]]))
        err = float(np.linalg.norm(pos[m] - world[i]))
        colors.append((255, 64, 64) if err > error_threshold
                      else (64, 200, 64))
    if strips:
        rec.log(path, "linestrips3d", {"strips": strips, "colors": colors})


def log_collision_geometry(rec, path: str, character, skel_states,
                           segments: int = 16):
    """Tapered capsules as line loops (pymomentum/rerun_vis.py
    log_collision_geometry, simplified to strip outlines)."""
    coll = character.collision
    if coll is None:
        return
    from momentum_tpu_torch.errors.collision import capsule_states

    origin, direction, _ = capsule_states(coll, skel_states)
    a = to_host(origin)
    b = a + to_host(direction)
    strips = [np.stack([a[i], b[i]]) for i in range(a.shape[0])]
    rec.log(path, "linestrips3d", {"strips": strips})


def log_character(rec, prefix: str, character, skel_states,
                  mesh_vertices=None, color=None):
    """Full character snapshot: skeleton + locators (+ skinned mesh when
    provided) — logCharacter (logger.h:96-105)."""
    log_joints(rec, prefix + "/skeleton", character, skel_states)
    if character.locators is not None and character.locators.num_locators:
        log_locators(rec, prefix + "/locators", character, skel_states,
                     color=color)
    if mesh_vertices is not None and character.mesh is not None:
        log_mesh(rec, prefix + "/mesh", mesh_vertices, character.mesh.faces)
    if character.collision is not None:
        log_collision_geometry(rec, prefix + "/collision", character,
                               skel_states)


def log_model_params(rec, world_prefix: str, pose_prefix: str,
                     names: Sequence[str], params):
    """Per-parameter scalar streams, split world (root) vs pose params —
    they live on different scales (logModelParams, logger.h:107-113)."""
    params = to_host(params)
    for i, n in enumerate(names):
        prefix = world_prefix if i < 6 else pose_prefix
        rec.log(f"{prefix}/{n}", "scalar", {"value": params[i]})


def log_animation(rec, prefix: str, character, motion, fps: float = 120.0,
                  markers=None, timeline: str = "frame"):
    """Batched whole-clip logging — the send_columns fast path
    (logModelParamsColumns, logger.h:136-152): FK of every frame in one
    batch (K1 on the card), then per-frame timeline entries. Returns the
    (F, nJ, 8) states on the character's device."""
    motion = torch.as_tensor(motion, dtype=torch.float32,
                             device=character.parameter_transform.transform.device)
    states = character.skeleton_states(motion)
    for i in range(motion.shape[0]):
        rec.set_time(timeline, sequence=i)
        log_character(rec, prefix, character, states[i])
        if markers is not None:
            log_markers(rec, prefix + "/markers", markers.positions[i],
                        markers.occluded[i], markers.names)
    return states


def log_motion(rec, prefix: str, character, motion, fps: float = 120.0,
               markers=None):
    """Alias matching the round brief's naming (gui.rerun_vis.log_motion)."""
    return log_animation(rec, prefix, character, motion, fps=fps,
                         markers=markers)


def replay(recording: FallbackRecording, target):
    """Replay a captured fallback stream into another recording (e.g. a real
    rerun stream once the SDK is available)."""
    for e in recording.entries:
        if e.time is not None:
            target.set_time(e.time[0], sequence=e.time[1])
        target.log(e.path, e.archetype, e.payload, static=e.static)
