"""Spatial queries by brute force, after momentum_tpu/axel/queries.py (the
reference's axel TriBvh closestSurfacePoint/rayHit and SimdKdTree KNN).

Every query point is tested against every face in (chunk, F) tensors on the
inputs' device, the first index winning a tie as JAX's argmin does. The JAX
package has no kernel here (lax.map and vmap over jnp), so neither has the
port.
"""

from __future__ import annotations

import math

import torch

from momentum_tpu_torch.math.geometry import point_triangle_closest_point

__all__ = ["closest_point_on_mesh", "ray_mesh_intersect", "knn"]


def _corners(vertices, faces):
    faces = torch.as_tensor(faces, device=vertices.device).long()
    return tuple(vertices[faces[:, k]] for k in range(3))


def closest_point_on_mesh(points, vertices, faces, chunk: int = 1024):
    """For each query point (Q, 3): (closest surface point (Q, 3), face
    index (Q,), barycentric (Q, 3), squared distance (Q,)), over all faces
    (TriBvh.closestSurfacePoint); `chunk` points at a time."""
    points = torch.as_tensor(points)
    vertices = torch.as_tensor(vertices, device=points.device)
    a, b, c = _corners(vertices, faces)
    out = []
    for p in points.split(chunk):
        cp, bary = point_triangle_closest_point(p[:, None], a[None], b[None], c[None])
        d2 = torch.sum((cp - p[:, None]) ** 2, dim=-1)  # (q, F)
        i = torch.argmin(d2, dim=-1)
        rows = torch.arange(p.shape[0], device=p.device)
        out.append((cp[rows, i], i, bary[rows, i], d2[rows, i]))
    if not out:
        z = points.new_zeros((0, 3))
        return z, torch.zeros(0, dtype=torch.int64, device=points.device), z, z[:, 0]
    return tuple(torch.cat(parts) for parts in zip(*out))


def ray_mesh_intersect(origins, directions, vertices, faces, max_t=math.inf):
    """Möller-Trumbore ray/triangle over all faces (TriBvh.rayHit): (t, face
    index, hit mask) per ray, t = inf and face 0 where nothing is hit."""
    origins = torch.as_tensor(origins)
    directions = torch.as_tensor(directions, device=origins.device)
    vertices = torch.as_tensor(vertices, device=origins.device)
    a, b, c = _corners(vertices, faces)
    e1, e2 = b - a, c - a
    d = directions[:, None]  # (R, 1, 3)
    pvec = torch.linalg.cross(d.expand(-1, e2.shape[0], -1), e2[None].expand(d.shape[0], -1, -1))
    det = torch.sum(e1 * pvec, dim=-1)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = origins[:, None] - a
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-8) & (t < max_t)
    t = torch.where(hit, t, math.inf)
    i = torch.argmin(t, dim=-1)
    t_best = t.gather(-1, i[:, None])[:, 0]
    return t_best, i, torch.isfinite(t_best)


def knn(points, queries, k: int):
    """The k nearest neighbours by brute force (SimdKdTree): (indices (Q, k),
    squared distances (Q, k)), nearest first and the lower index first on a
    tie (lax.top_k's order)."""
    points = torch.as_tensor(points)
    queries = torch.as_tensor(queries, device=points.device)
    d2 = torch.sum((queries[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    neg, idx = torch.sort(-d2, dim=-1, descending=True, stable=True)
    return idx[:, :k], -neg[:, :k]
