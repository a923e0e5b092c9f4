"""CameraProjectionErrorFunction: the pixel residual of points through a
full camera model with its distortion, after
momentum_tpu/errors/camera_projection.py
(camera_projection_error_function.{h,cpp}):

    f_c = project(T_parent_c · offset_c).uv − target_c,   0 behind nearClip

(a NaN depth is not behind the near clip: its rows are NaN, as the
reference's comparison `z < nearClip` leaves them; JAX's module zeroes them).

Its Jacobian is analytic for pinhole and OpenCV intrinsics
(`has_analytic_jacobian`; JAX's module has none): the point's model-space
Jacobian chained through the projection's derivative in the eye-space
point and the eye's rotation, d(u, v)/dθ = dπ/dp_eye · R_eye · dp/dθ, each
constraint's two rows scaled by the loss's row scale and zero where the
point lies behind `near_clip`. `jacobian_model` forms it in K6's projection
form (ops/jacobian.py::projection_jacobian_model); modules over the same
`parent` and `offset` tensors with the same loss and near clip (the
tracker's, one a camera) share one launch an evaluation
(`jacobian_group`, `group_jacobian_model`), their rows in the modules'
order, and their rows alone one pass over the K cameras at once
(`group_residual`). `jacobian` is the joint-space form. A fisheye camera's rows reach
the solver by forward mode, FK's primal through kernel K1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.camera.models import Camera, project_opencv, stack_opencv_parameters
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.geometric import _create, clamped
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.utils.profiling import spanned

__all__ = ["CameraProjectionErrorFunction"]


def _in_front(z: torch.Tensor, near_clip: float) -> torch.Tensor:
    """Where a point's rows count: all but depths not positive or below the
    near clip, so that a NaN depth (a failed step's pose) gives NaN rows,
    which LM rejects, and not rows of zeros, which it would accept."""
    return ~((z <= 0) | (z < near_clip))


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

    @property
    def has_analytic_jacobian(self) -> bool:
        return self.camera.intrinsics.has_analytic_jacobian

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def _world(self, ctx: EvalContext):
        """(clamped parents (C,), world points (..., C, 3))."""
        parents = clamped(self.parent, ctx)
        return parents, ss.transform_points(ctx.skel_states.index_select(-2, parents),
                                            self.offset)

    def raw(self, character, ctx: EvalContext):
        _, world = self._world(ctx)
        uvz, _ = self.camera.project(world)
        valid = _in_front(uvz[..., 2], self.near_clip)
        return torch.where(valid[..., None], uvz[..., :2] - self.target, 0.0), self.cweight

    def jacobian_group(self):
        """The key of the modules whose model-space Jacobians one launch
        forms (`group_jacobian_model`): the same parent and offset tensors,
        loss and near clip; None for a camera without an analytic Jacobian."""
        if not self.has_analytic_jacobian:
            return None
        return (CameraProjectionErrorFunction, id(self.parent), id(self.offset),
                self.loss.alpha, self.loss.c, self.near_clip)

    def jacobian_model(self, character, ctx: EvalContext, jc, pt_mat):
        """Rows (..., 2C) and d(rows)/d(model params) (..., 2C, P)."""
        return self.group_jacobian_model((self,), character, ctx, jc, pt_mat)

    @staticmethod
    def _group_rows(modules, ctx: EvalContext):
        """(parents, world points (..., C, 3), eye_from_world (K, 8), OpenCV
        intrinsics (K, 12), where the rows count (..., K, C), row scales
        (..., K, C), rows (..., 2KC)) of K modules of one `jacobian_group`:
        the K cameras' eye-space points and pixels at once, with
        `project`'s arithmetic."""
        first = modules[0]
        parents, world = first._world(ctx)
        cams = [m.camera for m in modules]
        eye = torch.stack([c.eye_from_world for c in cams])  # (K, 8)
        params = stack_opencv_parameters([c.intrinsics for c in cams])  # (K, 12)
        p_eye = ss.transform_points(eye[:, None, :], world[..., None, :, :])  # (..., K, C, 3)
        uv, z = project_opencv(p_eye, params[:, None, :])
        valid = _in_front(z, first.near_clip)
        target = torch.stack(torch.broadcast_tensors(*(m.target for m in modules)), dim=-3)
        f = torch.where(valid[..., None], uv - target, 0.0)  # (..., K, C, 2)
        cweight = torch.stack(torch.broadcast_tensors(*(m.cweight for m in modules)), dim=-2)
        weight = torch.stack([m.weight for m in modules])[:, None]
        scale = torch.sqrt(torch.clamp(weight * cweight, min=0.0))  # _row_scale's, by camera
        loss = first._loss()
        if loss.alpha == 2.0:
            scale = scale * (1.0 / loss.c)
        else:
            scale = scale * torch.sqrt(torch.clamp(loss.deriv(torch.sum(f * f, dim=-1)),
                                                   min=0.0)).detach()
        rows = (scale[..., None] * f).reshape(f.shape[:-3] + (-1,))
        return parents, world, eye, params, valid, scale, rows

    @staticmethod
    def group_residual(modules, character, ctx: EvalContext):
        """Rows (..., 2KC) of K modules of one `jacobian_group`, module k's
        2C rows in a block: the modules' `residual`s, concatenated."""
        return CameraProjectionErrorFunction._group_rows(modules, ctx)[-1]

    @staticmethod
    @spanned("camera_projection.jacobian")
    def group_jacobian_model(modules, character, ctx: EvalContext, jc, pt_mat):
        """Rows (..., 2KC) and J (..., 2KC, P) of K modules of one
        `jacobian_group`, module k's 2C rows in a block, J in one launch of
        K6's projection form."""
        from momentum_tpu_torch.ops.jacobian import projection_jacobian_model

        parents, world, eye, params, valid, scale, rows = \
            CameraProjectionErrorFunction._group_rows(modules, ctx)
        rot = ss.to_matrix(eye)[..., :3, :3]  # (K, 3, 3) world → eye, times the scale
        j = projection_jacobian_model(jc, world, parents, pt_mat, rot.to(world.dtype),
                                      eye[:, :3].to(world.dtype), params.to(world.dtype),
                                      torch.where(valid, scale, 0.0))
        return rows, j

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows (..., 2C) and their joint-space Jacobian (..., 2C, nJ·7),
        d(u, v)/d p_world times the point's joint-space Jacobian (the
        sequence solver's prefer_fused=False path)."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        parents, world = self._world(ctx)
        uvz, _, d = self.camera.project_jacobian(world)
        valid = _in_front(uvz[..., 2], self.near_clip)
        f = torch.where(valid[..., None], uvz[..., :2] - self.target, 0.0)
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        d = torch.where(valid[..., None, None], scale[..., None, None] * d, 0.0)
        j = d @ point_jacobian(jc, world, parents)  # (..., C, 2, nJ·7)
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        return rows, j.reshape(j.shape[:-3] + (rows.shape[-1], j.shape[-1])), None

    @classmethod
    def create(cls, camera, parent, offset, target, cweight=None, weight=1.0, near_clip=0.01,
               loss=None, capacity=None, device="cuda"):
        return _create(cls, "CameraProjectionErrorFunction.create", device, parent, cweight,
                       weight, loss, capacity,
                       dict(offset=(offset, (3,)), target=(np.asarray(target), (2,))),
                       camera=camera, near_clip=near_clip)
