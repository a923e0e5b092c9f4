"""Pinhole camera: intrinsics + extrinsics T_eye_from_world (camera.h:29-330),
the part of momentum_tpu/camera/models.py that rendering uses.

Conventions (camera.h): `project(p_eye)` maps eye-space points to (u, v, z),
pixel coordinates plus the eye-space depth, with valid = z > 0; eye-space +Z
looks forward and +Y points down. The intrinsics are 0-d float32 tensors on
the camera's device; `Camera.frame` is host numpy code, as in the JAX
package. The distorted models (OpenCV, fisheye) come with ROADMAP M3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["PinholeIntrinsics", "Camera"]


@dataclasses.dataclass(frozen=True, eq=False)
class PinholeIntrinsics:
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    image_width: int = 0  # 0 = unknown; `Camera.frame` needs the size
    image_height: int = 0

    @classmethod
    def create(cls, fx, fy, cx, cy, image_size=(0, 0), device="cuda") -> "PinholeIntrinsics":
        device = resolve(device, "PinholeIntrinsics.create")
        def f(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return cls(f(fx), f(fy), f(cx), f(cy), int(image_size[0]), int(image_size[1]))

    def to(self, device) -> "PinholeIntrinsics":
        return dataclasses.replace(self, **{k: getattr(self, k).to(device)
                                            for k in ("fx", "fy", "cx", "cy")})

    def project(self, p_eye: torch.Tensor):
        """(..., 3) eye-space points → ((..., 3) [u, v, z], (...,) z > 0)."""
        z = p_eye[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
        u = self.fx * (p_eye[..., 0] / safe_z) + self.cx
        v = self.fy * (p_eye[..., 1] / safe_z) + self.cy
        return torch.stack([u, v, z], dim=-1), z > 0


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Intrinsics + extrinsics (T_eye_from_world as an (8,) skel_state)."""

    intrinsics: PinholeIntrinsics
    eye_from_world: torch.Tensor

    @classmethod
    def create(cls, intrinsics: PinholeIntrinsics, eye_from_world=None) -> "Camera":
        device = intrinsics.fx.device
        if eye_from_world is None:
            eye_from_world = ss.identity(device=device)
        return cls(intrinsics=intrinsics,
                   eye_from_world=torch.as_tensor(eye_from_world, dtype=torch.float32,
                                                  device=device))

    def to(self, device) -> "Camera":
        return Camera(self.intrinsics.to(device), self.eye_from_world.to(device))

    def world_to_eye(self, p_world: torch.Tensor) -> torch.Tensor:
        return ss.transform_points(self.eye_from_world, p_world)

    def project(self, p_world: torch.Tensor):
        return self.intrinsics.project(self.world_to_eye(p_world))

    def frame(self, points, min_z: float = 0.1, edge_padding: float = 0.05) -> "Camera":
        """Translate the camera (orientation kept) so every point projects
        inside the padded image rect (framePoints, camera.cpp:1289-1345):
        recentre laterally on the eye-space bbox, put the near plane at the
        closest point, then dolly until every point meets its field-of-view
        and min-z constraints. Host numpy, as in the JAX package."""
        efw0 = self.eye_from_world
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=efw0.device).reshape(-1, 3)
        if points.shape[0] == 0:
            return self
        intr = self.intrinsics
        if not intr.image_width or not intr.image_height:
            raise ValueError("intrinsics carry no image size; pass image_size to create()")
        w, h = intr.image_width, intr.image_height
        cx, cy = w / 2.0, h / 2.0  # geometric centre, ignoring the principal point
        fx, fy = float(intr.fx), float(intr.fy)

        p_eye = self.world_to_eye(points).cpu().numpy()
        lo, hi = p_eye.min(axis=0), p_eye.max(axis=0)
        center = 0.5 * (lo + hi)
        shift = np.asarray([-center[0], -center[1], -lo[2]], np.float32)
        efw = ss.multiply(ss.from_translation(torch.as_tensor(shift, device=efw0.device)),
                          efw0)

        p_eye2 = p_eye + shift[None, :]
        max_x = (1.0 - 2.0 * edge_padding) * max(cx, (w - 1) - cx)
        max_y = (1.0 - 2.0 * edge_padding) * max(cy, (h - 1) - cy)
        # the clip-plane constraint counts only for points inside min_z
        # (camera.cpp:1330-1332); the field-of-view ones always, so the dolly
        # may be negative and move the camera closer
        dz_clip = np.where(p_eye2[:, 2] < min_z, min_z - p_eye2[:, 2], -np.inf)
        dz_x = fx * np.abs(p_eye2[:, 0]) / max_x - p_eye2[:, 2]
        dz_y = fy * np.abs(p_eye2[:, 1]) / max_y - p_eye2[:, 2]
        max_dz = float(np.max(np.concatenate([dz_clip, dz_x, dz_y])))
        dolly = torch.as_tensor([0.0, 0.0, max_dz], dtype=torch.float32, device=efw0.device)
        return dataclasses.replace(self, eye_from_world=ss.multiply(ss.from_translation(dolly),
                                                                    efw))
