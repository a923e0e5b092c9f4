"""Auto-framed cameras (momentum_render.cpp:36-196), the part of
momentum_tpu/rasterizer/utils.py that the shadowed clip render uses. Host
numpy, as in the JAX package; the skinning for the framing runs on the
character's device.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = ["create_camera_for_body"]


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
