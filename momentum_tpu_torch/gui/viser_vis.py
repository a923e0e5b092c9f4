"""Viser visualization of characters and motions — the port of
momentum_tpu/gui/viser_vis.py, taking torch tensors (copied to the host at
the scene boundary).

Mirror of pymomentum/viser_vis.py (CharacterHandles / show_character /
update_character / animation loop) against the small subset of the viser
scene API actually used: add_mesh_simple, add_point_cloud,
add_line_segments. The scene object is injected, so:

  * with the viser SDK installed: `viser.ViserServer().scene`
  * headless (this image): `FallbackScene` records every scene call and
    keeps live handles whose property updates are captured — the whole
    update path is exercisable and testable without a server.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.device import to_host

__all__ = ["viser_available", "make_scene", "FallbackScene",
           "CharacterHandles", "show_character", "update_character",
           "animate_motion"]


def viser_available() -> bool:
    try:
        import viser  # type: ignore # noqa: F401

        return True
    except Exception:
        return False


class _FakeHandle:
    def __init__(self, scene, name, kind, **props):
        self._scene = scene
        self.name = name
        self.kind = kind
        self.props = dict(props)

    def __setattr__(self, k, v):
        if k in ("_scene", "name", "kind", "props"):
            object.__setattr__(self, k, v)
            return
        self.props[k] = v
        self._scene.updates.append((self.name, k))


class FallbackScene:
    """Records add_*/update calls; drop-in for viser's SceneApi subset."""

    def __init__(self):
        self.nodes = {}
        self.updates = []

    def add_mesh_simple(self, name, vertices, faces, color=(200, 200, 200),
                        **kw):
        h = _FakeHandle(self, name, "mesh", vertices=to_host(vertices),
                        faces=to_host(faces), color=color)
        self.nodes[name] = h
        return h

    def add_point_cloud(self, name, points, colors=None, point_size=1.0,
                        **kw):
        h = _FakeHandle(self, name, "points", points=to_host(points),
                        colors=colors, point_size=point_size)
        self.nodes[name] = h
        return h

    def add_line_segments(self, name, points, colors=None, **kw):
        h = _FakeHandle(self, name, "lines", points=to_host(points),
                        colors=colors)
        self.nodes[name] = h
        return h


def make_scene(port: Optional[int] = None):
    """A live viser scene when the SDK is available, else a FallbackScene."""
    try:
        import viser  # type: ignore

        server = viser.ViserServer(port=port) if port else viser.ViserServer()
        return server.scene
    except Exception:
        return FallbackScene()


@dataclasses.dataclass
class CharacterHandles:
    """Scene handles for one character (pymomentum/viser_vis.py:107-123)."""

    mesh: Optional[object] = None
    joints: Optional[object] = None
    bones: Optional[object] = None
    locators: Optional[object] = None
    markers: Optional[object] = None



def _bone_segments(character, skel_states):
    pos = to_host(skel_states[..., :3])
    parents = character.skeleton.parents_np
    segs = [(pos[p], pos[j]) for j, p in enumerate(parents) if p >= 0]
    return np.asarray(segs)  # (B, 2, 3)


def show_character(scene, character, skel_states, prefix: str = "/character",
                   mesh_vertices=None, color=(200, 200, 200)) -> CharacterHandles:
    """Add skeleton + locators (+ skinned mesh) to the scene
    (pymomentum/viser_vis.py show_character)."""
    h = CharacterHandles()
    pos = to_host(skel_states[..., :3])
    h.joints = scene.add_point_cloud(prefix + "/joints", pos, point_size=2.0)
    h.bones = scene.add_line_segments(prefix + "/bones",
                                      _bone_segments(character, skel_states))
    if character.locators is not None and character.locators.num_locators:
        world = to_host(character.locators.world_positions(skel_states))
        h.locators = scene.add_point_cloud(prefix + "/locators", world,
                                           point_size=1.5)
    if mesh_vertices is not None and character.mesh is not None:
        h.mesh = scene.add_mesh_simple(prefix + "/mesh",
                                       to_host(mesh_vertices),
                                       to_host(character.mesh.faces),
                                       color=color)
    return h


def update_character(handles: CharacterHandles, character, skel_states,
                     mesh_vertices=None, marker_positions=None):
    """Push a new pose into existing handles (the per-frame update loop of
    pymomentum/viser_vis.py animate)."""
    pos = to_host(skel_states[..., :3])
    if handles.joints is not None:
        handles.joints.points = pos
    if handles.bones is not None:
        handles.bones.points = _bone_segments(character, skel_states)
    if handles.locators is not None:
        handles.locators.points = to_host(character.locators.world_positions(skel_states))
    if handles.mesh is not None and mesh_vertices is not None:
        handles.mesh.vertices = to_host(mesh_vertices)
    if handles.markers is not None and marker_positions is not None:
        handles.markers.points = to_host(marker_positions)


def animate_motion(scene, character, motion, prefix: str = "/character",
                   markers=None, frame_callback=None) -> CharacterHandles:
    """Step a whole motion through the scene (one batched FK pass, K1 on the
    card, then per-frame handle updates). `frame_callback(i)` is invoked
    per frame — hook for sleeping at the clip's fps in a live viewer."""
    states = character.skeleton_states(torch.as_tensor(
        motion, dtype=torch.float32, device=character.parameter_transform.transform.device))
    handles = show_character(scene, character, states[0], prefix=prefix)
    if markers is not None:
        handles.markers = scene.add_point_cloud(
            prefix + "/markers", to_host(markers.positions[0]),
            point_size=1.5)
    for i in range(states.shape[0]):
        update_character(
            handles, character, states[i],
            marker_positions=None if markers is None
            else markers.positions[i])
        if frame_callback is not None:
            frame_callback(i)
    return handles
