"""SDF residual modules, after momentum_tpu/errors/sdf.py:

  VertexSdfErrorFunction (vertex_sdf_error_function.cpp:240-265;
  kVertexSDFWeight = 5e-3, .h:36): per constraint vertex
      f = sdf(vertex in the grid's frame) − targetDistance          (1 row)
  with the grid world-fixed (sdf_parent < 0) or attached to a joint.
  SdfCollisionErrorFunction (sdf_collision_error_function.cpp:452,578;
  kSDFCollisionWeight = 5e-3, .h:136): per tracked vertex
      f = min(sdf(vertex), 0), the penetration depth                 (1 row)

Both read the posed mesh. Their analytic Jacobian is ∇φ(v)ᵀ times the LBS
vertex Jacobian (solver/analytic_jacobian.py::skinned_point_jacobian) plus
the blend-shape columns, sampled at the world-space vertices. A grid
attached to a joint has none (the inverse frame's chain term is not
written out, as in JAX): such a module takes the solver's forward-mode
Jacobian. The collision rows gate on d < 0, so d = 0 gives zero rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.axel.sdf import SignedDistanceField
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.vertex import _blend_model_columns, _padded
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.solver.analytic_jacobian import skinned_point_jacobian

__all__ = ["VertexSdfErrorFunction", "SdfCollisionErrorFunction", "K_VERTEX_SDF_WEIGHT",
           "K_SDF_COLLISION_WEIGHT"]

K_VERTEX_SDF_WEIGHT = 5e-3  # vertex_sdf_error_function.h:36
K_SDF_COLLISION_WEIGHT = 5e-3  # sdf_collision_error_function.h:136


def _sdf_rows_jacobian(character, ctx, jc, vertex_index, g, coef):
    """(coef·∇φᵀ·d(vertex)/d(joint params) (..., C, nJ·7), the same over the
    blend-shape columns (..., C, P) or None), g (..., C, 3) the gradients
    and coef (..., C) the rows' scale."""
    jv = skinned_point_jacobian(jc, character, ctx, vertex_index)
    j_jp = coef[..., None] * torch.einsum("...ci,...cij->...cj", g, jv)
    jb = _blend_model_columns(character, ctx, vertex_index)
    j_model = None if jb is None else coef[..., None] * torch.einsum(
        "...ci,...cip->...cp", g, jb)
    return j_jp, j_model


@dataclasses.dataclass(frozen=True, eq=False)
class VertexSdfErrorFunction(VectorErrorFunction):
    sdf: SignedDistanceField
    vertex_index: torch.Tensor  # (C,) int32
    target_distance: torch.Tensor  # (..., C)
    cweight: torch.Tensor  # (C,)
    weight: torch.Tensor
    # the joint the grid is attached to (−1: world-fixed)
    sdf_parent: int = -1
    loss: GeneralizedLoss = GeneralizedLoss()

    needs_mesh = True
    D = 1

    def constraint_count(self) -> int:
        return self.vertex_index.shape[0]

    def _vertices(self, ctx: EvalContext) -> torch.Tensor:
        return ctx.mesh_vertices.index_select(-2, self.vertex_index)

    def _to_sdf_space(self, ctx: EvalContext, points: torch.Tensor) -> torch.Tensor:
        """World points (..., C, 3) into the grid's frame. JAX's form
        broadcasts the parent's (..., 8) state against (..., C, 3) and so
        holds unbatched only (ROADMAP F23); here the state takes a
        constraint axis."""
        if self.sdf_parent < 0:
            return points
        frame = ctx.skel_states[..., self.sdf_parent, :]
        return ss.transform_points(ss.inverse(frame)[..., None, :], points)

    def raw(self, character, ctx: EvalContext):
        d = self.sdf.sample(self._to_sdf_space(ctx, self._vertices(ctx)))
        return (d - self.target_distance)[..., None], self.cweight * K_VERTEX_SDF_WEIGHT

    @property
    def has_analytic_jacobian(self) -> bool:
        # the joint-attached grid's inverse-frame chain term is not written
        # out, as in JAX: that case takes the forward-mode Jacobian
        return self.sdf_parent < 0

    def jacobian(self, character, ctx: EvalContext, jc):
        """∇φ(v)ᵀ·(LBS vertex Jacobian) at the world-space vertices, for a
        world-fixed grid (vertex_sdf_error_function.cpp:240-265)."""
        v = self._vertices(ctx)
        f = self.sdf.sample(v) - self.target_distance
        scale = self._row_scale(self.cweight * K_VERTEX_SDF_WEIGHT, f * f)
        j_jp, j_model = _sdf_rows_jacobian(character, ctx, jc, self.vertex_index,
                                           self.sdf.gradient(v), scale)
        return scale * f, j_jp, j_model

    @classmethod
    def create(cls, sdf, vertex_index, target_distance=None, cweight=None, weight=1.0,
               sdf_parent=-1, loss=None, capacity=None, device="cuda"):
        device = resolve(device, "VertexSdfErrorFunction.create")
        vertex_index = np.asarray(vertex_index, np.int32)
        n = vertex_index.shape[0]
        target = (np.zeros(n, np.float32) if target_distance is None
                  else np.asarray(target_distance, np.float32))
        t = _padded(device, capacity, n, cweight, vertex_index=vertex_index,
                    target_distance=target)
        return cls(sdf=sdf, weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   sdf_parent=int(sdf_parent), loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class SdfCollisionErrorFunction(VectorErrorFunction):
    """Penetration penalty of tracked mesh vertices against a world SDF
    (environment geometry)."""

    sdf: SignedDistanceField
    vertex_index: torch.Tensor  # (C,) int32
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    needs_mesh = True
    has_analytic_jacobian = True
    D = 1

    def constraint_count(self) -> int:
        return self.vertex_index.shape[0]

    def raw(self, character, ctx: EvalContext):
        d = self.sdf.sample(ctx.mesh_vertices.index_select(-2, self.vertex_index))
        return torch.minimum(d, d.new_zeros(()))[..., None], \
            self.cweight * K_SDF_COLLISION_WEIGHT

    def jacobian(self, character, ctx: EvalContext, jc):
        """The penetration rows: (d < 0)·∇φ(v)ᵀ·(LBS vertex Jacobian)
        (sdf_collision_error_function.cpp gradient path)."""
        v = ctx.mesh_vertices.index_select(-2, self.vertex_index)
        d = self.sdf.sample(v)
        f = torch.minimum(d, d.new_zeros(()))
        scale = self._row_scale(self.cweight * K_SDF_COLLISION_WEIGHT, f * f)
        j_jp, j_model = _sdf_rows_jacobian(character, ctx, jc, self.vertex_index,
                                           self.sdf.gradient(v), scale * (d < 0).to(d.dtype))
        return scale * f, j_jp, j_model

    @classmethod
    def create(cls, sdf, vertex_index, cweight=None, weight=1.0, loss=None, capacity=None,
               device="cuda"):
        device = resolve(device, "SdfCollisionErrorFunction.create")
        vertex_index = np.asarray(vertex_index, np.int32)
        t = _padded(device, capacity, vertex_index.shape[0], cweight, vertex_index=vertex_index)
        return cls(sdf=sdf, weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss(), **t)
