"""CameraProjectionErrorFunction: the pixel residual of points through a
full camera model with its distortion, after
momentum_tpu/errors/camera_projection.py
(camera_projection_error_function.{h,cpp}):

    f_c = project(T_parent_c · offset_c).uv − target_c,   0 behind nearClip

It has no analytic Jacobian, as in JAX: its rows reach the solver by
forward mode, FK's primal through kernel K1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.camera.models import Camera
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.geometric import _create, clamped
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["CameraProjectionErrorFunction"]


@dataclasses.dataclass(frozen=True, eq=False)
class CameraProjectionErrorFunction(VectorErrorFunction):
    camera: Camera
    parent: torch.Tensor  # (C,)
    offset: torch.Tensor  # (C, 3)
    target: torch.Tensor  # (..., C, 2) pixel targets
    cweight: torch.Tensor  # (..., C)
    weight: torch.Tensor
    near_clip: float = 0.01
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 2

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def raw(self, character, ctx: EvalContext):
        states = ctx.skel_states.index_select(-2, clamped(self.parent, ctx))
        uvz, valid = self.camera.project(ss.transform_points(states, self.offset))
        valid = valid & (uvz[..., 2] >= self.near_clip)
        return torch.where(valid[..., None], uvz[..., :2] - self.target, 0.0), self.cweight

    @classmethod
    def create(cls, camera, parent, offset, target, cweight=None, weight=1.0, near_clip=0.01,
               loss=None, capacity=None, device="cuda"):
        return _create(cls, "CameraProjectionErrorFunction.create", device, parent, cweight,
                       weight, loss, capacity,
                       dict(offset=(offset, (3,)), target=(np.asarray(target), (2,))),
                       camera=camera, near_clip=near_clip)
