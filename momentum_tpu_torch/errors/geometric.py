"""Geometric residual modules, after momentum_tpu/errors/geometric.py
(momentum/character_solver/):

  AimDistErrorFunction (aim_error_function.cpp:15-38)
      p = T·localPoint; d = R·localDir; t = target − p
      f = (d·t)·d − t                                           (3 rows)
  AimDirErrorFunction (aim_error_function.cpp:40-65)
      f = d − normalize(target − p)                             (3 rows)
  FixedAxisDiffErrorFunction (fixed_axis_error_function.cpp:15-27)
      f = R·localAxis − globalAxis                              (3 rows)
  FixedAxisCosErrorFunction (:30-42)    f = 1 − (R·localAxis)·globalAxis
  FixedAxisAngleErrorFunction (:45-62)  f = acos(clamp((R·a)·g))  (1 row)
  PlaneErrorFunction (plane_error_function.cpp:51-66)
      f = (T·offset)·normal − d; half_plane: only the negative side counts
  NormalErrorFunction (normal_error_function.cpp:15-31)
      f = (R·localNormal)·(T·localPoint − globalPoint)          (1 row)
  DistanceErrorFunction (distance_error_function.cpp:55-70)
      f = ‖T·offset − origin‖ − target                          (1 row)
  ProjectionErrorFunction (projection_error_function.cpp:25-51)
      q = P(3×4)·hom(T·offset); f = q.xy/q.z − target, 0 where q.z < nearClip

Every module has its analytic joint-space Jacobian (`jacobian`), a chain
rule over solver/analytic_jacobian.py's point_jacobian / vector_jacobian,
which SkeletonSolverFunction chains through the parameter transform. The
Plane module is the floor of the marker tracker (tracking/tracker.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.position import _pad_rows
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["AimDistErrorFunction", "AimDirErrorFunction", "FixedAxisDiffErrorFunction",
           "FixedAxisCosErrorFunction", "FixedAxisAngleErrorFunction", "PlaneErrorFunction",
           "NormalErrorFunction", "DistanceErrorFunction", "ProjectionErrorFunction"]

_EPS = 1e-16
_ACOS_CLAMP = 1.0 - 1e-7


def clamped(index: torch.Tensor, ctx: EvalContext) -> torch.Tensor:
    """Joint indices clamped into range, so that no table, padded or not,
    gathers out of range (ROADMAP F3)."""
    return index.clamp(0, ctx.skel_states.shape[-2] - 1)


def _create(cls, entry: str, device, parent, cweight, weight, loss, capacity, tables,
            **statics):
    """cls(...) with `tables` (name -> (array, row shape)) and the parent and
    constraint weights padded to `capacity` rows on `device`."""
    device = resolve(device, entry)
    parent = np.asarray(parent, np.int32)
    n = parent.shape[0]
    cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
    cap = capacity or n

    def t(x):
        return torch.as_tensor(_pad_rows(x, cap), device=device)

    fields = {k: t(np.asarray(v, np.float32).reshape((n,) + shape))
              for k, (v, shape) in tables.items()}
    return cls(parent=t(parent), cweight=t(cweight),
               weight=torch.tensor(weight, dtype=torch.float32, device=device),
               loss=loss or GeneralizedLoss(), **fields, **statics)


def _finish(ef, f, j, w):
    """(rows (..., C·D), J (..., C·D, nJ·7), None): f (..., C, D) and its
    joint-space Jacobian j (..., C, D, nJ·7), both scaled by the robust row
    scale of constraint weights w."""
    scale = ef._row_scale(w, torch.sum(f * f, dim=-1))
    rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
    jrows = (scale[..., None, None] * j).reshape(j.shape[:-3] + (rows.shape[-1], j.shape[-1]))
    return rows, jrows, None


def _dot_j(v, j):
    """v (..., C, 3) · J (..., C, 3, K) → (..., C, K)."""
    return torch.einsum("...ci,...cij->...cj", v, j)


class _Attached(VectorErrorFunction):
    """Constraints attached to `parent` joints, each with a (C,) weight."""

    D = 3
    has_analytic_jacobian = True

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def _states(self, ctx: EvalContext):
        """(clamped parents, their global states (..., C, 8))."""
        parents = clamped(self.parent, ctx)
        return parents, ctx.skel_states.index_select(-2, parents)


@dataclasses.dataclass(frozen=True, eq=False)
class _PointDirBase(_Attached):
    """Shared layout: parent joint, local point, local direction, world target."""

    parent: torch.Tensor  # (C,) int32
    local_point: torch.Tensor  # (C, 3)
    local_dir: torch.Tensor  # (C, 3)
    target: torch.Tensor  # (..., C, 3)
    cweight: torch.Tensor  # (..., C)
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    def _geom(self, ctx: EvalContext):
        parents, states = self._states(ctx)
        return (parents, ss.transform_points(states, self.local_point),
                ss.rotate_vectors(states, self.local_dir))

    def _geom_jacobians(self, ctx, jc):
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian, vector_jacobian

        parents, p, d = self._geom(ctx)
        return p, d, point_jacobian(jc, p, parents), vector_jacobian(jc, d, parents)

    @classmethod
    def create(cls, parent, local_point, local_dir, target, cweight=None, weight=1.0,
               loss=None, capacity=None, device="cuda"):
        return _create(cls, f"{cls.__name__}.create", device, parent, cweight, weight, loss,
                       capacity, dict(local_point=(local_point, (3,)),
                                      local_dir=(local_dir, (3,)), target=(target, (3,))))


@dataclasses.dataclass(frozen=True, eq=False)
class AimDistErrorFunction(_PointDirBase):
    """The target's distance from the ray through p along d."""

    def raw(self, character, ctx: EvalContext):
        _, p, d = self._geom(ctx)
        t = self.target - p
        return torch.sum(d * t, dim=-1, keepdim=True) * d - t, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """f = (d·t)d − t with dt = −Jp: df = d·(tᵀJd + dᵀJt) + (d·t)·Jd − Jt."""
        p, d, jp, jd = self._geom_jacobians(ctx, jc)
        t = self.target - p
        jt = -jp
        dt = torch.sum(d * t, dim=-1)
        ddt = _dot_j(t, jd) + _dot_j(d, jt)
        j = d[..., None] * ddt[..., None, :] + dt[..., None, None] * jd - jt
        return _finish(self, dt[..., None] * d - t, j, self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class AimDirErrorFunction(_PointDirBase):
    """The angle between d and the direction toward the target."""

    def raw(self, character, ctx: EvalContext):
        _, p, d = self._geom(ctx)
        t = self.target - p
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        tdir = torch.where(norm > _EPS, t / torch.clamp(norm, min=_EPS), 0.0)
        return d - tdir, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """d t̂ = (I − t̂t̂ᵀ)/‖t‖ · dt with dt = −Jp."""
        p, d, jp, jd = self._geom_jacobians(ctx, jc)
        t = self.target - p
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        safe = torch.clamp(norm, min=1e-12)
        that = torch.where(norm > _EPS, t / safe, 0.0)
        proj = jp - torch.einsum("...ci,...cj,...cjk->...cik", that, that, jp)
        return _finish(self, d - that, jd + proj / safe[..., None], self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class _FixedAxisBase(_Attached):
    parent: torch.Tensor
    local_axis: torch.Tensor  # (C, 3)
    global_axis: torch.Tensor  # (..., C, 3)
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    def _world_axis(self, ctx: EvalContext):
        parents, states = self._states(ctx)
        return parents, ss.rotate_vectors(states, self.local_axis)

    def _axis_jacobian(self, ctx, jc):
        from momentum_tpu_torch.solver.analytic_jacobian import vector_jacobian

        parents, v = self._world_axis(ctx)
        return v, vector_jacobian(jc, v, parents)

    @classmethod
    def create(cls, parent, local_axis, global_axis, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        return _create(cls, f"{cls.__name__}.create", device, parent, cweight, weight, loss,
                       capacity, dict(local_axis=(local_axis, (3,)),
                                      global_axis=(global_axis, (3,))))


@dataclasses.dataclass(frozen=True, eq=False)
class FixedAxisDiffErrorFunction(_FixedAxisBase):
    def raw(self, character, ctx: EvalContext):
        return self._world_axis(ctx)[1] - self.global_axis, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        v, jv = self._axis_jacobian(ctx, jc)
        return _finish(self, v - self.global_axis, jv, self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class FixedAxisCosErrorFunction(_FixedAxisBase):
    D = 1

    def raw(self, character, ctx: EvalContext):
        dot = torch.sum(self._world_axis(ctx)[1] * self.global_axis, dim=-1, keepdim=True)
        return 1.0 - dot, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        v, jv = self._axis_jacobian(ctx, jc)
        f = 1.0 - torch.sum(v * self.global_axis, dim=-1, keepdim=True)
        return _finish(self, f, -_dot_j(self.global_axis, jv)[..., None, :], self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class FixedAxisAngleErrorFunction(_FixedAxisBase):
    """The dot product is clamped strictly inside (−1, 1): d(acos)/dx is
    infinite at ±1, where the reference relies on sin(angle) = 0 cancelling
    it (fixed_axis_error_function.cpp:57-62)."""

    D = 1

    def raw(self, character, ctx: EvalContext):
        dot = torch.sum(self._world_axis(ctx)[1] * self.global_axis, dim=-1, keepdim=True)
        return torch.arccos(torch.clamp(dot, -_ACOS_CLAMP, _ACOS_CLAMP)), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        v, jv = self._axis_jacobian(ctx, jc)
        c = torch.clamp(torch.sum(v * self.global_axis, dim=-1), -_ACOS_CLAMP, _ACOS_CLAMP)
        dacos = -1.0 / torch.sqrt(1.0 - c * c)
        j = (dacos[..., None] * _dot_j(self.global_axis, jv))[..., None, :]
        return _finish(self, torch.arccos(c)[..., None], j, self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class PlaneErrorFunction(_Attached):
    """Point-to-plane constraints; kLegacyWeight 1e-4 is the caller's
    (plane_error_function.h:86)."""

    parent: torch.Tensor  # (C,) int32
    offset: torch.Tensor  # (C, 3) point in the joint-local frame
    normal: torch.Tensor  # (C, 3) world-space plane normal
    d: torch.Tensor  # (C,) plane offset along the normal
    cweight: torch.Tensor  # (..., C) per-constraint weight (0 = padding)
    weight: torch.Tensor
    half_plane: bool = False
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def _point(self, ctx: EvalContext):
        parents, states = self._states(ctx)
        return parents, ss.transform_points(states, self.offset)

    def raw(self, character, ctx: EvalContext):
        p = self._point(ctx)[1]
        val = torch.sum(p * self.normal, dim=-1) - self.d
        if self.half_plane:
            val = torch.clamp(val, max=0.0)
        return val[..., None], self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """normalᵀ·Jp, gated to the violated side for a half plane."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        parents, p = self._point(ctx)
        val = torch.sum(p * self.normal, dim=-1) - self.d
        j = _dot_j(self.normal, point_jacobian(jc, p, parents))
        if self.half_plane:
            j = (val < 0).to(j.dtype)[..., None] * j
            val = torch.clamp(val, max=0.0)
        return _finish(self, val[..., None], j[..., None, :], self.cweight)

    @classmethod
    def create(cls, parent, offset, normal, d, cweight=None, weight=1.0, half_plane=False,
               loss=None, capacity=None, device="cuda"):
        return _create(cls, "PlaneErrorFunction.create", device, parent, cweight, weight, loss,
                       capacity, dict(offset=(offset, (3,)), normal=(normal, (3,)),
                                      d=(d, ())), half_plane=half_plane)


@dataclasses.dataclass(frozen=True, eq=False)
class NormalErrorFunction(_Attached):
    """Point-to-plane with a body-attached normal."""

    parent: torch.Tensor
    local_point: torch.Tensor
    local_normal: torch.Tensor
    global_point: torch.Tensor  # (..., C, 3)
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def _geom(self, ctx: EvalContext):
        parents, states = self._states(ctx)
        return (parents, ss.transform_points(states, self.local_point),
                ss.rotate_vectors(states, self.local_normal))

    def raw(self, character, ctx: EvalContext):
        _, p, nrm = self._geom(ctx)
        return torch.sum(nrm * (p - self.global_point), dim=-1, keepdim=True), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian, vector_jacobian

        parents, p, nrm = self._geom(ctx)
        diff = p - self.global_point
        j = (_dot_j(diff, vector_jacobian(jc, nrm, parents))
             + _dot_j(nrm, point_jacobian(jc, p, parents)))
        f = torch.sum(nrm * diff, dim=-1, keepdim=True)
        return _finish(self, f, j[..., None, :], self.cweight)

    @classmethod
    def create(cls, parent, local_point, local_normal, global_point, cweight=None, weight=1.0,
               loss=None, capacity=None, device="cuda"):
        return _create(cls, "NormalErrorFunction.create", device, parent, cweight, weight,
                       loss, capacity, dict(local_point=(local_point, (3,)),
                                            local_normal=(local_normal, (3,)),
                                            global_point=(global_point, (3,))))


@dataclasses.dataclass(frozen=True, eq=False)
class DistanceErrorFunction(_Attached):
    """Point-to-origin distance; kDistanceWeight = 1
    (distance_error_function.cpp:72)."""

    parent: torch.Tensor
    offset: torch.Tensor  # (C, 3)
    origin: torch.Tensor  # (..., C, 3) world space
    target: torch.Tensor  # (..., C)
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def _point(self, ctx: EvalContext):
        parents, states = self._states(ctx)
        return parents, ss.transform_points(states, self.offset)

    def raw(self, character, ctx: EvalContext):
        dist = torch.linalg.vector_norm(self._point(ctx)[1] - self.origin + 1e-20, dim=-1)
        return (dist - self.target)[..., None], self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        parents, p = self._point(ctx)
        dvec = p - self.origin
        dist = torch.linalg.vector_norm(dvec + 1e-20, dim=-1)
        dhat = dvec / torch.clamp(dist, min=1e-12)[..., None]
        j = _dot_j(dhat, point_jacobian(jc, p, parents))[..., None, :]
        return _finish(self, (dist - self.target)[..., None], j, self.cweight)

    @classmethod
    def create(cls, parent, offset, origin, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        return _create(cls, "DistanceErrorFunction.create", device, parent, cweight, weight,
                       loss, capacity, dict(offset=(offset, (3,)), origin=(origin, (3,)),
                                            target=(target, ())))


@dataclasses.dataclass(frozen=True, eq=False)
class ProjectionErrorFunction(_Attached):
    """Pinhole-matrix projection, 0 behind the near clip;
    kProjectionWeight = 1 (projection_error_function.h:112)."""

    parent: torch.Tensor
    offset: torch.Tensor  # (C, 3)
    projection: torch.Tensor  # (..., C, 3, 4)
    target: torch.Tensor  # (..., C, 2)
    cweight: torch.Tensor
    weight: torch.Tensor
    near_clip: float = 1.0
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 2

    def _project(self, ctx: EvalContext):
        """(parents, world point p, q = P·hom(p), safe depth)."""
        parents, states = self._states(ctx)
        p = ss.transform_points(states, self.offset)
        q = (torch.einsum("...ij,...j->...i", self.projection[..., :3], p)
             + self.projection[..., 3])
        z = q[..., 2]
        return parents, p, q, torch.where(torch.abs(z) > _EPS, z, 1.0)

    def raw(self, character, ctx: EvalContext):
        _, _, q, safe_z = self._project(ctx)
        f = q[..., :2] / safe_z[..., None] - self.target
        return torch.where((q[..., 2] >= self.near_clip)[..., None], f, 0.0), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """d(q.xy/z) = [1/z, 0, −x/z²; 0, 1/z, −y/z²]·M[:, :3]·Jp, over the
        constraint axis at every batch shape (JAX's form indexes that axis
        as axis 1 and holds only unbatched, ROADMAP F15)."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        parents, p, q, safe_z = self._project(ctx)
        valid = (q[..., 2] >= self.near_clip).to(p.dtype)
        f = (q[..., :2] / safe_z[..., None] - self.target) * valid[..., None]
        jq = torch.einsum("...cij,...cjk->...cik", self.projection[..., :3],
                          point_jacobian(jc, p, parents))
        inv_z = (1.0 / safe_z)[..., None]
        j = torch.stack([inv_z * jq[..., 0, :] - (q[..., 0:1] * inv_z ** 2) * jq[..., 2, :],
                         inv_z * jq[..., 1, :] - (q[..., 1:2] * inv_z ** 2) * jq[..., 2, :]],
                        dim=-2) * valid[..., None, None]
        return _finish(self, f, j, self.cweight)

    @classmethod
    def create(cls, parent, offset, projection, target, cweight=None, weight=1.0,
               near_clip=1.0, loss=None, capacity=None, device="cuda"):
        return _create(cls, "ProjectionErrorFunction.create", device, parent, cweight, weight,
                       loss, capacity, dict(offset=(offset, (3,)),
                                            projection=(projection, (3, 4)),
                                            target=(target, (2,))), near_clip=near_clip)
