"""Offline motion viewer: posed characters rendered to image sequences —
the port of momentum_tpu/gui/viewer.py.

Reference surface: momentum/gui/ (rerun's logCharacter, logMesh,
logMarkers; the glb_viewer app). Without a live viewer the equivalent is
batch rendering: FK and skinning of the whole motion in one batch (K1 on
the card), the z-buffer render of each frame on the character's device
(K4a/K4b through render_mesh's planes path), optional skeleton and marker
overlays drawn on the host, export as frames or an animated GIF.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["auto_camera", "render_motion", "draw_skeleton", "draw_markers",
           "save_motion_gif", "create_camera_for_body", "create_camera_for_hand"]



def _device(character) -> torch.device:
    return character.parameter_transform.transform.device


def auto_camera(points, width: int, height: int, fov_scale: float = 1.2, device="cuda"):
    """Frame a point cloud: a camera on +z looking at the bbox centre (host
    numpy), built on `device` (the card unless the caller asks for the
    CPU)."""
    from momentum_tpu_torch.camera import Camera, PinholeIntrinsics
    from momentum_tpu_torch.math import skel_state as ss

    device = resolve(device, "auto_camera")
    pts = to_host(points).reshape(-1, 3)
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2
    radius = max(float(np.linalg.norm(hi - lo)) / 2, 1e-3)
    f = 0.5 * min(width, height)
    # world → camera with the identity rotation: the bbox centre lands at
    # eye-space (0, 0, dist), in front of the camera (+z forward)
    t = np.asarray([0.0, 0.0, fov_scale * radius * 2.0]) - center
    intr = PinholeIntrinsics.create(f, f, width / 2.0, height / 2.0, device=device)
    pose = ss.join(torch.as_tensor(t, dtype=torch.float32, device=device),
                   torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
                   torch.ones(1, device=device))
    return Camera.create(intr, pose)


def _posed(character, model_params: torch.Tensor):
    """(mesh vertices or None, skeleton states) of (..., P) parameters."""
    if character.mesh is None or character.skin_weights is None:
        return None, character.skeleton_states(model_params)
    from momentum_tpu_torch.character.character_state import character_state

    st = character_state(character.with_inverse_bind_pose(), model_params,
                         update_collision=False)
    return st.mesh_vertices, st.skeleton_state


def render_motion(character, motion, width: int = 256, height: int = 256, camera=None,
                  light_dir=(0.3, -0.7, 0.6), skeleton_overlay: bool = False,
                  ground: bool = False) -> np.ndarray:
    """Render a (F, P) model-parameter motion → (F, H, W, 3) float colours
    (host numpy). The whole motion is posed in one batch; the camera is
    auto-framed from the first frame unless given; `ground` draws the
    reference viewer's checkerboard floor under the character
    (rasterize_checkerboard, once), z-tested against each frame."""
    from momentum_tpu_torch.rasterizer import rasterize_checkerboard, render_mesh

    dev = _device(character)
    motion = torch.as_tensor(motion, dtype=torch.float32, device=dev)
    if motion.ndim == 1:
        motion = motion[None]
    verts, states = _posed(character, motion)
    ref = to_host(verts[0] if verts is not None else states[0, :, :3])
    cam = camera if camera is not None else auto_camera(ref, width, height, device=dev)
    ground_buffers = None
    if ground:
        extent = float(np.abs(ref[:, [0, 2]]).max()) * 3.0 + 1.0
        ground_buffers = rasterize_checkerboard(cam, width, height, half_extent=extent,
                                                squares=10)
    frames = []
    for i in range(motion.shape[0]):
        if verts is not None:
            out = render_mesh(cam, verts[i], character.mesh.faces, width, height,
                              light_dir=light_dir)
            img = out["color"]
            if ground_buffers is not None:
                gz, gc = ground_buffers
                img = torch.where((out["depth"] < gz)[..., None], img, gc)
            img = to_host(img)
        elif ground_buffers is not None:
            img = to_host(ground_buffers[1]).copy()
        else:
            img = np.zeros((height, width, 3), np.float32)
        if skeleton_overlay or verts is None:
            img = draw_skeleton(img, cam, character.skeleton, states[i])
        frames.append(img)
    return np.stack(frames)


def _draw_line(img: np.ndarray, x0, y0, x1, y1, color) -> np.ndarray:
    """Host-side Bresenham segment, drawn in place."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.round(np.linspace(x0, x1, n + 1)).astype(int)
    ys = np.round(np.linspace(y0, y1, n + 1)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color
    return img


def draw_skeleton(img, camera, skeleton, states, color=(1.0, 0.3, 0.1)) -> np.ndarray:
    """Bone segments (parent → child) over a rendered frame (host numpy)."""
    img = np.array(to_host(img), copy=True)
    pts = torch.as_tensor(states, dtype=torch.float32,
                          device=camera.eye_from_world.device)[..., :3]
    uvz, valid = camera.project(pts)
    uvz, valid = to_host(uvz), to_host(valid)
    col = np.asarray(color, img.dtype)
    for j, p in enumerate(skeleton.parents_np):
        if p < 0 or not (valid[j] and valid[p]):
            continue
        img = _draw_line(img, uvz[p, 0], uvz[p, 1], uvz[j, 0], uvz[j, 1], col)
    return img


def draw_markers(img, camera, positions, color=(0.2, 1.0, 0.2), size: int = 1) -> np.ndarray:
    """Marker points over a rendered frame (logMarkers' equivalent)."""
    img = np.array(to_host(img), copy=True)
    uvz, valid = camera.project(torch.as_tensor(positions, dtype=torch.float32,
                                                device=camera.eye_from_world.device))
    uvz, valid = to_host(uvz), to_host(valid)
    h, w = img.shape[:2]
    for i in range(uvz.shape[0]):
        if not valid[i]:
            continue
        x, y = int(round(uvz[i, 0])), int(round(uvz[i, 1]))
        x0, x1 = max(x - size, 0), min(x + size + 1, w)
        y0, y1 = max(y - size, 0), min(y + size + 1, h)
        if x0 < x1 and y0 < y1:
            img[y0:y1, x0:x1] = np.asarray(color, img.dtype)
    return img


def save_motion_gif(path, character, motion, width: int = 256, height: int = 256,
                    fps: float = 15.0, **kw) -> None:
    """Render a motion and export it as an animated GIF (glb_viewer's
    equivalent); `kw` goes to render_motion."""
    from momentum_tpu_torch.gui.gif import save_gif

    save_gif(path, render_motion(character, motion, width, height, **kw), fps=fps)


def create_camera_for_body(character, model_params, width: int, height: int,
                           fov_scale: float = 1.2):
    """Auto-framed camera for a posed character (pymomentum renderer
    create_camera_for_body), on the character's device."""
    dev = _device(character)
    verts, states = _posed(character, torch.as_tensor(model_params, dtype=torch.float32,
                                                      device=dev))
    ref = verts if verts is not None else states[..., :3]
    return auto_camera(ref, width, height, fov_scale, device=dev)


def create_camera_for_hand(character, model_params, width: int, height: int,
                           wrist_joint: str = "l_wrist", fov_scale: float = 0.8):
    """Auto-framed close-up of the subtree under a wrist joint
    (create_camera_for_hand); the body's camera if the rig has no such
    joint."""
    names = character.skeleton.joint_names
    if wrist_joint not in names:
        return create_camera_for_body(character, model_params, width, height)
    wi = names.index(wrist_joint)
    parents = character.skeleton.parents_np
    sub = [wi]
    for j in range(wi + 1, len(parents)):
        if parents[j] in sub:
            sub.append(j)
    dev = _device(character)
    states = character.skeleton_states(torch.as_tensor(model_params, dtype=torch.float32,
                                                       device=dev))
    return auto_camera(states[..., :3][sub], width, height, fov_scale, device=dev)
