"""Renderer utility surface: buffers, compositing, scene-level rasterizers
and auto-framed cameras — the port of momentum_tpu/rasterizer/utils.py
(pymomentum.renderer: renderer_pybind.cpp:217-893, momentum_render.cpp:
36-360, rasterizer_primitives.cpp:139-650, momentum/rasterizer/image.h:16).

The buffer builders make tensors from sizes alone, on the card unless the
caller asks for the CPU; the scene rasterizers work on their camera's
device. Triangulation and the cameras' framing are host numpy, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = ["create_z_buffer", "create_rgb_buffer", "create_index_buffer", "alpha_matte",
           "triangulate", "rasterize_mesh", "rasterize_checkerboard", "rasterize_grid",
           "rasterize_camera_frustum", "rasterize_transforms",
           "create_shadow_projection_matrix", "create_camera_for_body",
           "create_camera_for_hand"]


# ---- buffers (pymomentum.renderer create_*_buffer) ----

def create_z_buffer(width: int, height: int, device="cuda") -> torch.Tensor:
    """(H, W) float32 depth buffer of +inf (empty)."""
    device = resolve(device, "create_z_buffer")
    return torch.full((height, width), torch.inf, dtype=torch.float32, device=device)


def create_rgb_buffer(width: int, height: int, device="cuda") -> torch.Tensor:
    """(H, W, 3) float32 colour buffer of black."""
    device = resolve(device, "create_rgb_buffer")
    return torch.zeros((height, width, 3), dtype=torch.float32, device=device)


def create_index_buffer(width: int, height: int, device="cuda") -> torch.Tensor:
    """(H, W) int32 triangle-index buffer of −1 (empty), the convention of
    the rasterizers' "face" output."""
    device = resolve(device, "create_index_buffer")
    return torch.full((height, width), -1, dtype=torch.int32, device=device)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def alpha_matte(z_buffer, rgb_buffer, tgt_image, alpha: float = 1.0) -> torch.Tensor:
    """Composite rendered pixels over a target image (image.h:16
    alphaMatte): where the z-buffer is finite, tgt = alpha·rgb +
    (1 − alpha)·tgt. Returns the result on the z-buffer's device (the
    reference writes tgt in place)."""
    z = torch.as_tensor(z_buffer, dtype=torch.float32)
    rgb, tgt = _f32(rgb_buffer, z.device), _f32(tgt_image, z.device)
    covered = torch.isfinite(z)[..., None]
    return torch.where(covered, alpha * rgb + (1.0 - alpha) * tgt, tgt)


def triangulate(face_indices, face_offsets) -> np.ndarray:
    """Fan-triangulate a polygon soup (momentum_render.cpp:297-327): face i
    spans face_indices[face_offsets[i]:face_offsets[i+1]]; → (T, 3) int32."""
    face_indices = np.asarray(face_indices, np.int64).reshape(-1)
    face_offsets = np.asarray(face_offsets, np.int64).reshape(-1)
    tris = []
    for i in range(len(face_offsets) - 1):
        beg, end = face_offsets[i], face_offsets[i + 1]
        nv = end - beg
        if nv < 3:
            raise ValueError(f"invalid face with {nv} indices; expected >= 3")
        for j in range(1, nv - 1):
            tris.append((face_indices[beg], face_indices[beg + j], face_indices[beg + j + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


# ---- scene-level rasterizers ----

def _camera_device(camera) -> torch.device:
    return camera.eye_from_world.device


def _z_test(depth, color, z_buffer, rgb_buffer, width, height):
    """(depth, color) composited over the given buffers (empty where None)
    where strictly nearer."""
    dev = depth.device
    z = create_z_buffer(width, height, dev) if z_buffer is None else _f32(z_buffer, dev)
    rgb = create_rgb_buffer(width, height, dev) if rgb_buffer is None else _f32(rgb_buffer, dev)
    win = depth < z
    return torch.where(win, depth, z), torch.where(win[..., None], color, rgb)


def rasterize_mesh(camera, vertices, faces, width: int, height: int, z_buffer=None,
                   rgb_buffer=None, **kwargs):
    """Render a mesh into (z, rgb) buffers, z-testing against their content
    (renderer_pybind rasterize_mesh; Lambert shading, render_mesh's keyword
    arguments: use render_mesh_phong for materials). Without buffers,
    render_mesh's depth and colour."""
    from momentum_tpu_torch.rasterizer.render import render_mesh

    dev = _camera_device(camera)
    out = render_mesh(camera, _f32(vertices, dev),
                      torch.as_tensor(faces, dtype=torch.int32, device=dev), width, height,
                      **kwargs)
    if z_buffer is None and rgb_buffer is None:
        return out["depth"], out["color"]
    return _z_test(out["depth"], out["color"], z_buffer, rgb_buffer, width, height)


def rasterize_checkerboard(camera, width: int, height: int, half_extent: float = 200.0,
                           squares: int = 20, z_buffer=None, rgb_buffer=None,
                           colors=((0.8, 0.8, 0.8), (0.4, 0.4, 0.4))):
    """Checkerboard floor in the x-z plane, y up (renderer_pybind.cpp:
    670-708), through the dense `rasterize`. → (z, rgb)."""
    from momentum_tpu_torch.rasterizer.primitives import make_checkerboard
    from momentum_tpu_torch.rasterizer.render import rasterize, screen_vertices

    dev = _camera_device(camera)
    verts, faces, face_shade = make_checkerboard(half_extent, squares)
    out = rasterize(screen_vertices(camera, _f32(verts, dev)),
                    torch.as_tensor(faces, dtype=torch.int32, device=dev), width, height)
    # make_checkerboard's grey 0.8 / 0.4 faces take the two given colours;
    # empty pixels (face −1) the appended black row
    light = torch.as_tensor(face_shade[:, 0] >= 0.6, device=dev)[:, None]
    face_rgb = torch.where(light, _f32(colors[0], dev), _f32(colors[1], dev))
    face_rgb = torch.cat([face_rgb, torch.zeros((1, 3), device=dev)])
    face = out["face"].long()
    color = face_rgb[torch.where(face >= 0, face, face_rgb.shape[0] - 1)]
    return _z_test(out["depth"], color, z_buffer, rgb_buffer, width, height)


def rasterize_grid(camera, width: int, height: int, half_extent: float = 200.0,
                   step: float = 20.0, color=(0.6, 0.6, 0.6), thickness: float = 1.0,
                   z_buffer=None, rgb_buffer=None):
    """Grid lines on the x-z ground plane (renderer_pybind.cpp:710-713,
    rasterize_checkerboard's line-only sibling). → (z, rgb)."""
    from momentum_tpu_torch.rasterizer.overlays import rasterize_lines
    from momentum_tpu_torch.rasterizer.primitives import make_grid_lines

    segs = make_grid_lines(half_extent, step)
    return rasterize_lines(camera, segs.reshape(-1, 3), width, height, color=color,
                           thickness=thickness, z_buffer=z_buffer, rgb_buffer=rgb_buffer)


def rasterize_camera_frustum(viewer_camera, shown_camera, width: int, height: int,
                             depth: float = 50.0, color=(1.0, 1.0, 0.0),
                             thickness: float = 1.0, z_buffer=None, rgb_buffer=None):
    """`shown_camera`'s frustum wireframe seen from `viewer_camera`
    (renderer_pybind rasterize_camera_frustum). → (z, rgb)."""
    from momentum_tpu_torch.rasterizer.overlays import rasterize_lines
    from momentum_tpu_torch.rasterizer.primitives import make_camera_frustum

    sw = shown_camera.intrinsics.image_width or width
    sh = shown_camera.intrinsics.image_height or height
    segs = make_camera_frustum(shown_camera, sw, sh, depth)
    return rasterize_lines(viewer_camera, segs.reshape(-1, 3), width, height, color=color,
                           thickness=thickness, z_buffer=z_buffer, rgb_buffer=rgb_buffer)


def rasterize_transforms(camera, transforms, width: int, height: int, scale: float = 5.0,
                         thickness: float = 1.5, z_buffer=None, rgb_buffer=None):
    """Coordinate-axis triads of a batch of transforms
    (rasterizer_primitives.cpp:608 rasterizeTransforms): +x red, +y green,
    +z blue. `transforms` (N, 8) skel_states or (N, 4, 4) matrices.
    → (z, rgb)."""
    from momentum_tpu_torch.rasterizer.overlays import rasterize_lines

    t = torch.as_tensor(transforms, dtype=torch.float32)
    if t.ndim == 3 and t.shape[-2:] == (4, 4):
        origins = t[:, :3, 3].cpu().numpy()
        axes = t[:, :3, :3].cpu().numpy()  # columns are the axes
    elif t.ndim == 2 and t.shape[-1] == 8:
        _, q, s = ss.split(t)
        origins = t[:, :3].cpu().numpy()
        axes = (quat.to_rotation_matrix(q) * s.reshape(-1)[:, None, None]).cpu().numpy()
    else:
        raise ValueError(f"expected (N, 8) skel_states or (N, 4, 4), got {tuple(t.shape)}")

    z, rgb = z_buffer, rgb_buffer
    colors = ((1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.4, 1.0))
    for axis in range(3):
        segs = np.stack([origins, origins + scale * axes[:, :, axis]], axis=1)  # (N, 2, 3)
        z, rgb = rasterize_lines(camera, segs.reshape(-1, 3), width, height,
                                 color=colors[axis], thickness=thickness, z_buffer=z,
                                 rgb_buffer=rgb)
    return z, rgb


def create_shadow_projection_matrix(light_dir, plane_normal=(0.0, 1.0, 0.0),
                                    plane_offset: float = 0.0, device="cuda") -> torch.Tensor:
    """(4, 4) matrix flattening geometry onto the plane n·p = offset along
    the directional light: the planar-shadow projection of the reference's
    create_shadow_projection_matrix. Built in float64 on the host."""
    device = resolve(device, "create_shadow_projection_matrix")
    light = np.asarray(light_dir, np.float64)
    n = np.asarray(plane_normal, np.float64)
    d = -float(plane_offset)
    ndotl = float(n @ light)
    if abs(ndotl) < 1e-12:
        raise ValueError("light direction is parallel to the shadow plane")
    m = np.empty((4, 4), np.float64)
    m[:3, :3] = ndotl * np.eye(3) - np.outer(light, n)
    m[:3, 3] = -d * light
    m[3, :3] = 0.0
    m[3, 3] = ndotl
    return _f32(m, device)


# ---- auto-framed cameras (momentum_render.cpp:36-360) ----

def _make_outside_in_camera(up_world, look_world, aim_center, distance,
                            image_height: int, image_width: int,
                            focal_length_mm: float = 50.0, device=None):
    """Eye basis from (up, look): x right, y down, z forward
    (momentum_render.cpp:36-80); 35mm-equivalent focal length."""
    from momentum_tpu_torch.camera import Camera, PinholeIntrinsics

    up = np.asarray(up_world, np.float64)
    look = np.asarray(look_world, np.float64)
    aim = np.asarray(aim_center, np.float64)
    side = np.cross(look, up)
    up_ortho = np.cross(side, look)
    r = np.zeros((3, 3))
    r[:, 1] = -up_ortho / np.linalg.norm(up_ortho)
    r[:, 2] = look / np.linalg.norm(look)
    r[:, 0] = np.cross(r[:, 1], r[:, 2])
    if not np.linalg.det(r) > 0:
        raise ValueError("up and look directions give no right-handed eye basis")

    # world→eye: translate aim to the origin, rotate by Rᵀ, push back along +z
    r_we = r.T
    t_we = distance * np.asarray([0.0, 0.0, 1.0]) - r_we @ aim
    focal_px = (focal_length_mm / 36.0) * image_width
    intr = PinholeIntrinsics.create(
        focal_px, focal_px, (image_width - 1) / 2.0, (image_height - 1) / 2.0,
        image_size=(image_width, image_height), device=device)
    q = quat.from_rotation_matrix(torch.as_tensor(r_we, dtype=torch.float32, device=device))
    state = torch.cat([torch.as_tensor(t_we, dtype=torch.float32, device=device), q,
                       torch.ones(1, dtype=torch.float32, device=device)])
    return Camera.create(intr, state)


def _frame_character(camera, character, skel_states: torch.Tensor, min_z: float = 5.0):
    """Move the camera so every skinned vertex (or joint, without a mesh)
    of every given frame is in view (momentum_render.cpp:82-101 frameMesh)."""
    from momentum_tpu_torch.character.skinning import skin_points

    if character.mesh is not None and character.skin_weights is not None:
        char = character.with_inverse_bind_pose()
        pts = skin_points(char.skin_weights, skel_states, char.inverse_bind_pose,
                          char.mesh.vertices)
    else:
        pts = skel_states[..., :3]
    return camera.frame(pts.reshape(-1, 3), min_z=min_z, edge_padding=0.05)


def create_camera_for_body(character, skeleton_states, image_height: int,
                           image_width: int, focal_length_mm: float = 50.0,
                           horizontal: bool = False, camera_angle: float = 0.0):
    """Camera facing the body's front across all given frames
    (momentum_render.cpp:103-196 makeOutsideInCameraForBody): centred on the
    mid-spine, 2.5 m out, then dollied so every frame is in view.
    skeleton_states: (nJ, 8) or (nFrames, nJ, 8); the camera lives on their
    device."""
    states = torch.as_tensor(skeleton_states, dtype=torch.float32)
    if states.ndim == 2:
        states = states[None]
    names = character.skeleton.joint_names
    for cand in ("b_spine3", "c_spine3", "spineUpper_joint",
                 "b_l_wrist", "b_r_wrist", "l_wrist", "r_wrist"):
        if cand in names:
            spine = names.index(cand)
            break
    else:
        # the middle joint of the chain on non-standard rigs (the reference throws)
        spine = character.skeleton.num_joints // 2

    blended = ss.blend(states[:, spine])
    center = blended[:3].cpu().numpy().astype(np.float64)
    r = quat.to_rotation_matrix(blended[3:7]).cpu().numpy().astype(np.float64)

    # spine-local: x up, y forward, z body-left (momentum_render.cpp:151-154)
    body_forward = r @ np.asarray([0.0, 1.0, 0.0])
    cam_forward = -body_forward
    if horizontal:
        cam_up = np.asarray([0.0, 1.0, 0.0])
        cam_forward = cam_forward.copy()
        cam_forward[1] = 0.0
        nrm = np.linalg.norm(cam_forward)
        if nrm < 1e-5:
            cam_forward = -body_forward
            cam_up = r @ np.asarray([1.0, 0.0, 0.0])
            cam_up /= np.linalg.norm(cam_up)
        else:
            cam_forward /= nrm
    else:
        cam_up = r @ np.asarray([1.0, 0.0, 0.0])
        cam_up /= np.linalg.norm(cam_up)

    if camera_angle != 0.0:
        c, s = np.cos(camera_angle), np.sin(camera_angle)
        k = cam_up / np.linalg.norm(cam_up)
        cam_forward = (cam_forward * c + np.cross(k, cam_forward) * s
                       + k * (k @ cam_forward) * (1.0 - c))

    cam = _make_outside_in_camera(cam_up, cam_forward, center, 250.0, image_height,
                                  image_width, focal_length_mm, device=states.device)
    return _frame_character(cam, character, states)


def create_camera_for_hand(wrist_transformation, image_height: int, image_width: int,
                           device="cuda"):
    """Camera looking in at a hand from 0.5 m (momentum_render.cpp:328-360
    create_camera_for_hand); wrist_transformation (4, 4), translation in
    mm."""
    m = np.asarray(wrist_transformation, np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"wrist_transformation must be 4x4, got {m.shape}")
    return _make_outside_in_camera((0.0, 1.0, 0.0), (0.0, 0.0, 1.0), m[:3, 3] * 0.1, 50.0,
                                   image_height, image_width, device=device)
