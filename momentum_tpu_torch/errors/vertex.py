"""Vertex (mesh) residual modules, after momentum_tpu/errors/vertex.py. They
read the posed mesh of the EvalContext (the reference's MeshState,
mesh_state.h:28-71: neutral → blend shapes → rest → LBS → posed, once per
evaluation):

  VertexPositionErrorFunction (vertex_position_error_function.cpp:35-49)
      f = posedVertex − target                                     (3 rows)
  VertexPlaneErrorFunction (vertex_plane_error_function.cpp:32-71)
      n' = n flipped toward the posed mesh normal;
      f = (v − point)·n', clamped to 0 above the plane if `above`    (1 row)
  VertexNormalErrorFunction (vertex_normal_error_function.cpp:43-80)
      n = srcW·meshNormal + tgtW·(targetNormal sign-matched to it)
      f = n·(v − targetPosition)                                    (1 row)
  VertexProjectionErrorFunction (vertex_projection_error_function.cpp:28-60)
      q = P·hom(v); f = q.xy/q.z − target for q.z ≥ near_clip       (2 rows)

Each has the analytic joint-space Jacobian of the LBS walk
(`jacobian`, solver/analytic_jacobian.py's skinned_* functions) plus the
blend-shape columns in model space. The sign choices read the mesh normals,
whose scatter-add sums with atomics on CUDA: near a zero dot product a row's
sign can differ between runs there, so compare energies, not raw rows.

Three modules have no analytic Jacobian, as in JAX; their rows reach the
solver by forward mode (the solver function's mixed analytic/AD branch):

  PointTriangleVertexErrorFunction (point_triangle_vertex_error_function.cpp)
      position: f = v_src − Σ_i bary_i·v_tri_i                      (3 rows)
      plane:    f = n·(v_src − Σ_i bary_i·v_tri_i), n blended from the
                source vertex normal and the triangle's normal       (1 row)
  VertexVertexDistanceErrorFunction (vertex_vertex_distance_error_function.cpp:52-70)
      f = ‖v1 − v2‖ − target                                         (1 row)
  CameraVertexProjectionErrorFunction (camera_vertex_projection_error_function.cpp)
      f = project(v).uv − target through a full camera model, 0 behind
      near_clip                                                      (2 rows)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.camera.models import Camera
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction, pad_rows
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.solver.analytic_jacobian import (
    skinned_blend_jacobian, skinned_point_jacobian, skinned_vector_jacobian)

__all__ = ["VertexPositionErrorFunction", "VertexPlaneErrorFunction",
           "VertexNormalErrorFunction", "VertexProjectionErrorFunction",
           "PointTriangleVertexErrorFunction", "VertexVertexDistanceErrorFunction",
           "CameraVertexProjectionErrorFunction"]


def _tables(device, cap, vertex_index, cweight, **arrays):
    """The module's tables (arrays already float32 of C rows) as tensors on
    `device`, padded to `cap` rows: padding rows read vertex 0 at weight 0."""
    vertex_index = np.asarray(vertex_index, np.int32)
    n = vertex_index.shape[0]
    cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
    out = {}
    for k, v in dict(vertex_index=vertex_index, cweight=cweight, **arrays).items():
        padded = np.zeros((cap or n,) + v.shape[1:], v.dtype)
        padded[:n] = v
        out[k] = torch.as_tensor(padded, device=device)
    return out


def _blend_model_columns(character, ctx: EvalContext, vertex_index: torch.Tensor):
    """d(posed vertex)/d(model params) on the blend-shape and
    face-expression columns, (..., C, 3, P), or None: the skinning linear
    map applied to each basis delta, scattered into model space by the
    character's one-hot selectors (built once on its device)."""
    out = None
    for entry in character.shape_bases:
        if entry is None:
            continue
        basis, _, sel = entry
        jb = skinned_blend_jacobian(character, ctx, vertex_index, basis)
        jm = torch.einsum("...cib,bp->...cip", jb, sel)
        out = jm if out is None else out + jm
    return out


class _VertexErrorFunction(VectorErrorFunction):
    needs_mesh = True
    has_analytic_jacobian = True

    def constraint_count(self) -> int:
        return self.vertex_index.shape[0]

    def _vertices(self, ctx: EvalContext) -> torch.Tensor:
        return ctx.mesh_vertices.index_select(-2, self.vertex_index)

    def _normals(self, ctx: EvalContext) -> torch.Tensor:
        return ctx.mesh_normals.index_select(-2, self.vertex_index)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexPositionErrorFunction(_VertexErrorFunction):
    vertex_index: torch.Tensor  # (C,) int32
    target: torch.Tensor  # (..., C, 3)
    cweight: torch.Tensor  # (C,)
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 3

    def raw(self, character, ctx: EvalContext):
        return self._vertices(ctx) - self.target, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows (..., 3C), the LBS walk's joint-space rows (..., 3C, nJ·7)
        and the blend-shape columns (..., 3C, P) or None."""
        f, w = self.raw(character, ctx)
        scale = self._row_scale(w, torch.sum(f * f, dim=-1))[..., None, None]
        rows = (scale[..., 0] * f).reshape(f.shape[:-2] + (-1,))
        j_jp = scale * skinned_point_jacobian(jc, character, ctx, self.vertex_index)
        j_jp = j_jp.reshape(j_jp.shape[:-3] + (rows.shape[-1], j_jp.shape[-1]))
        jb = _blend_model_columns(character, ctx, self.vertex_index)
        j_model = None
        if jb is not None:
            j_model = (scale * jb).reshape(jb.shape[:-3] + (rows.shape[-1], jb.shape[-1]))
        return rows, j_jp, j_model

    @classmethod
    def create(cls, vertex_index, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        device = resolve(device, "VertexPositionErrorFunction.create")
        n = len(vertex_index)
        t = _tables(device, capacity, vertex_index, cweight,
                    target=np.asarray(target, np.float32).reshape(n, 3))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexPlaneErrorFunction(_VertexErrorFunction):
    vertex_index: torch.Tensor
    point: torch.Tensor  # (C, 3) a point on the plane
    normal: torch.Tensor  # (C, 3)
    cweight: torch.Tensor
    weight: torch.Tensor
    above: bool = False
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def _distance(self, ctx: EvalContext):
        """(signed distance (..., C) before the `above` clamp, n' (..., C, 3))."""
        flip = torch.sum(self._normals(ctx) * self.normal, dim=-1, keepdim=True) < 0
        n = torch.where(flip, -self.normal, self.normal)
        return torch.sum((self._vertices(ctx) - self.point) * n, dim=-1), n

    def raw(self, character, ctx: EvalContext):
        dist, _ = self._distance(ctx)
        if self.above:
            dist = torch.clamp(dist, max=0.0)
        return dist[..., None], self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """n'ᵀ · (LBS vertex Jacobian); the mesh normal only picks the sign
        (constant, as upstream treats the flip), and the `above` gate zeroes
        the inactive rows."""
        dist, n = self._distance(ctx)
        gate = torch.ones_like(dist)
        if self.above:
            gate = (dist < 0).to(dist.dtype)
            dist = torch.clamp(dist, max=0.0)
        scale = self._row_scale(self.cweight, dist * dist)
        coef = (scale * gate)[..., None]
        jv = skinned_point_jacobian(jc, character, ctx, self.vertex_index)
        j_jp = coef * torch.einsum("...ci,...cij->...cj", n, jv)
        jb = _blend_model_columns(character, ctx, self.vertex_index)
        j_model = None if jb is None else coef * torch.einsum("...ci,...cip->...cp", n, jb)
        return scale * dist, j_jp, j_model

    @classmethod
    def create(cls, vertex_index, point, normal, cweight=None, weight=1.0, above=False,
               loss=None, capacity=None, device="cuda"):
        device = resolve(device, "VertexPlaneErrorFunction.create")
        n = len(vertex_index)
        t = _tables(device, capacity, vertex_index, cweight,
                    point=np.asarray(point, np.float32).reshape(n, 3),
                    normal=np.asarray(normal, np.float32).reshape(n, 3))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   above=above, loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexNormalErrorFunction(_VertexErrorFunction):
    vertex_index: torch.Tensor
    target_position: torch.Tensor  # (C, 3)
    target_normal: torch.Tensor  # (C, 3)
    cweight: torch.Tensor
    weight: torch.Tensor
    source_normal_weight: float = 0.5
    target_normal_weight: float = 0.5
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def _terms(self, ctx: EvalContext):
        """(source normal, blended normal n, v − target position), each
        (..., C, 3)."""
        src_n = self._normals(ctx)
        flip = torch.sum(src_n * self.target_normal, dim=-1, keepdim=True) < 0
        tgt_n = torch.where(flip, -self.target_normal, self.target_normal)
        n = self.source_normal_weight * src_n + self.target_normal_weight * tgt_n
        return src_n, n, self._vertices(ctx) - self.target_position

    def raw(self, character, ctx: EvalContext):
        _, n, diff = self._terms(ctx)
        return torch.sum(n * diff, dim=-1, keepdim=True), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """nᵀ·dv + w_src·(v − tgt)ᵀ·d(src_n) over the LBS walk, the source
        normal rotating rigidly with its skinning frames (the reference's
        combined gradient + normal walk, skeleton_derivative.h:233-235)."""
        src_n, n, diff = self._terms(ctx)
        dist = torch.sum(n * diff, dim=-1)
        scale = self._row_scale(self.cweight, dist * dist)
        jv = skinned_point_jacobian(jc, character, ctx, self.vertex_index)
        j_jp = torch.einsum("...ci,...cij->...cj", n, jv)
        if self.source_normal_weight != 0.0:
            jn = skinned_vector_jacobian(jc, character, ctx, self.vertex_index, src_n)
            j_jp = j_jp + self.source_normal_weight * torch.einsum(
                "...ci,...cij->...cj", diff, jn)
        j_jp = scale[..., None] * j_jp
        jb = _blend_model_columns(character, ctx, self.vertex_index)
        j_model = None if jb is None else scale[..., None] * torch.einsum(
            "...ci,...cip->...cp", n, jb)
        return scale * dist, j_jp, j_model

    @classmethod
    def create(cls, vertex_index, target_position, target_normal, cweight=None, weight=1.0,
               source_normal_weight=0.5, target_normal_weight=0.5, loss=None,
               capacity=None, device="cuda"):
        device = resolve(device, "VertexNormalErrorFunction.create")
        n = len(vertex_index)
        t = _tables(device, capacity, vertex_index, cweight,
                    target_position=np.asarray(target_position, np.float32).reshape(n, 3),
                    target_normal=np.asarray(target_normal, np.float32).reshape(n, 3))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   source_normal_weight=source_normal_weight,
                   target_normal_weight=target_normal_weight,
                   loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexProjectionErrorFunction(_VertexErrorFunction):
    vertex_index: torch.Tensor
    projection: torch.Tensor  # (C, 3, 4)
    target: torch.Tensor  # (C, 2)
    cweight: torch.Tensor
    weight: torch.Tensor
    near_clip: float = 1.0
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 2

    def _project(self, ctx: EvalContext):
        """(f (..., C, 2) zeroed behind the near plane, q (..., C, 3), the
        safe depth (..., C, 1), valid (..., C))."""
        v = self._vertices(ctx)
        q = torch.einsum("...ij,...j->...i", self.projection[..., :3], v) + self.projection[..., 3]
        z = q[..., 2:3]
        valid = z[..., 0] >= self.near_clip
        zsafe = torch.where(torch.abs(z) > 1e-16, z, 1.0)
        f = torch.where(valid[..., None], q[..., :2] / zsafe - self.target, 0.0)
        return f, q, zsafe, valid

    def raw(self, character, ctx: EvalContext):
        return self._project(ctx)[0], self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """The pinhole chain rule over the LBS walk: with q = P·[v; 1],
        d(q_xy/q_z)/dv = P[:2, :3]/z − (q_xy/z²)·P[2, :3]."""
        f, q, zsafe, valid = self._project(ctx)
        scale = self._row_scale(self.cweight, torch.sum(f * f, dim=-1))
        gate = (scale * valid.to(scale.dtype))[..., None, None]
        dfdv = gate * (self.projection[..., :2, :3] / zsafe[..., None]
                       - (q[..., :2] / (zsafe * zsafe))[..., None] * self.projection[..., 2:3, :3])
        rows = (scale[..., None] * f).reshape(f.shape[:-2] + (-1,))
        jv = skinned_point_jacobian(jc, character, ctx, self.vertex_index)
        j_jp = torch.einsum("...cdi,...cij->...cdj", dfdv, jv)
        j_jp = j_jp.reshape(j_jp.shape[:-3] + (rows.shape[-1], jv.shape[-1]))
        jb = _blend_model_columns(character, ctx, self.vertex_index)
        j_model = None
        if jb is not None:
            j_model = torch.einsum("...cdi,...cip->...cdp", dfdv, jb)
            j_model = j_model.reshape(j_model.shape[:-3] + (rows.shape[-1], jb.shape[-1]))
        return rows, j_jp, j_model

    @classmethod
    def create(cls, vertex_index, projection, target, cweight=None, weight=1.0,
               near_clip=1.0, loss=None, capacity=None, device="cuda"):
        device = resolve(device, "VertexProjectionErrorFunction.create")
        n = len(vertex_index)
        t = _tables(device, capacity, vertex_index, cweight,
                    projection=np.asarray(projection, np.float32).reshape(n, 3, 4),
                    target=np.asarray(target, np.float32).reshape(n, 2))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   near_clip=near_clip, loss=loss or GeneralizedLoss(), **t)


def _padded(device, cap, n, cweight, **arrays) -> dict:
    """The arrays and cweight (ones by default) as tensors on `device`,
    padded to `cap` (or n) rows of zeros: padding rows read vertex 0 at
    weight 0."""
    cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
    return {k: torch.as_tensor(pad_rows(v, cap or n), device=device)
            for k, v in dict(arrays, cweight=cweight).items()}


@dataclasses.dataclass(frozen=True, eq=False)
class PointTriangleVertexErrorFunction(VectorErrorFunction):
    src_vertex: torch.Tensor  # (C,) int32
    tri_vertices: torch.Tensor  # (C, 3) int32
    bary: torch.Tensor  # (C, 3)
    cweight: torch.Tensor
    weight: torch.Tensor
    constraint_type: str = "position"  # or "plane"
    source_normal_weight: float = 0.5
    target_normal_weight: float = 0.5
    loss: GeneralizedLoss = GeneralizedLoss()

    needs_mesh = True

    @property
    def D(self):  # noqa: N802 - VectorErrorFunction's row width
        return 3 if self.constraint_type == "position" else 1

    def constraint_count(self) -> int:
        return self.src_vertex.shape[0]

    def raw(self, character, ctx: EvalContext):
        verts = ctx.mesh_vertices
        v_src = verts.index_select(-2, self.src_vertex)
        tri = verts.index_select(-2, self.tri_vertices.reshape(-1))
        tri = tri.reshape(verts.shape[:-2] + tuple(self.tri_vertices.shape) + (3,))
        diff = v_src - torch.sum(self.bary[..., None] * tri, dim=-2)
        if self.constraint_type == "position":
            return diff, self.cweight
        src_n = ctx.mesh_normals.index_select(-2, self.src_vertex)
        a, b, c = tri.unbind(-2)
        tn = torch.linalg.cross(b - a, c - a)
        tn = tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1, keepdim=True), min=1e-12)
        n = self.source_normal_weight * src_n + self.target_normal_weight * tn
        return torch.sum(n * diff, dim=-1, keepdim=True), self.cweight

    @classmethod
    def create(cls, src_vertex, tri_vertices, bary, cweight=None, weight=1.0,
               constraint_type="position", loss=None, capacity=None, device="cuda"):
        device = resolve(device, "PointTriangleVertexErrorFunction.create")
        src_vertex = np.asarray(src_vertex, np.int32)
        n = src_vertex.shape[0]
        t = _padded(device, capacity, n, cweight, src_vertex=src_vertex,
                    tri_vertices=np.asarray(tri_vertices, np.int32).reshape(n, 3),
                    bary=np.asarray(bary, np.float32).reshape(n, 3))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   constraint_type=constraint_type, loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class VertexVertexDistanceErrorFunction(VectorErrorFunction):
    vertex1: torch.Tensor  # (C,) int32
    vertex2: torch.Tensor  # (C,) int32
    target: torch.Tensor  # (..., C)
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    needs_mesh = True
    D = 1

    def constraint_count(self) -> int:
        return self.vertex1.shape[0]

    def raw(self, character, ctx: EvalContext):
        p1 = ctx.mesh_vertices.index_select(-2, self.vertex1)
        p2 = ctx.mesh_vertices.index_select(-2, self.vertex2)
        dist = torch.linalg.vector_norm(p1 - p2 + 1e-20, dim=-1)
        return (dist - self.target)[..., None], self.cweight

    @classmethod
    def create(cls, vertex1, vertex2, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        device = resolve(device, "VertexVertexDistanceErrorFunction.create")
        vertex1 = np.asarray(vertex1, np.int32)
        t = _padded(device, capacity, vertex1.shape[0], cweight, vertex1=vertex1,
                    vertex2=np.asarray(vertex2, np.int32),
                    target=np.asarray(target, np.float32))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class CameraVertexProjectionErrorFunction(VectorErrorFunction):
    camera: Camera
    vertex_index: torch.Tensor  # (C,) int32
    target: torch.Tensor  # (..., C, 2) pixel targets
    cweight: torch.Tensor
    weight: torch.Tensor
    near_clip: float = 0.01
    loss: GeneralizedLoss = GeneralizedLoss()

    needs_mesh = True
    D = 2

    def constraint_count(self) -> int:
        return self.vertex_index.shape[0]

    def raw(self, character, ctx: EvalContext):
        uvz, valid = self.camera.project(ctx.mesh_vertices.index_select(-2, self.vertex_index))
        valid = valid & (uvz[..., 2] >= self.near_clip)
        return torch.where(valid[..., None], uvz[..., :2] - self.target, 0.0), self.cweight

    @classmethod
    def create(cls, camera, vertex_index, target, cweight=None, weight=1.0, near_clip=0.01,
               loss=None, capacity=None, device="cuda"):
        device = resolve(device, "CameraVertexProjectionErrorFunction.create")
        vertex_index = np.asarray(vertex_index, np.int32)
        n = vertex_index.shape[0]
        t = _padded(device, capacity, n, cweight, vertex_index=vertex_index,
                    target=np.asarray(target, np.float32).reshape(n, 2))
        return cls(camera=camera, weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   near_clip=near_clip, loss=loss or GeneralizedLoss(), **t)
