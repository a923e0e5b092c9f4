"""Mesh analysis: the self-intersection test and the 2-D support polygon,
after momentum_tpu/math/mesh_ops.py (the reference's
momentum/math/intersection.h, brute force over all face pairs, and
support_polygon.h).

`_tri_tri_intersect` keeps JAX's eps = 1e-9 on plane distances, which is
below float32's resolution at unit scale: so a pair touching at a vertex or
coplanar within rounding decides as JAX's does, by the rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import to_host

__all__ = ["intersect_mesh_brute_force", "support_polygon"]


def _plane(p, q, r):
    n = torch.linalg.cross(q - p, r - p)
    return n, -torch.sum(n * p, dim=-1)


def _dists(n, d, a, b, c):
    return tuple(torch.sum(n * x, dim=-1) + d for x in (a, b, c))


def _interval(pa, pb, pc, da, db, dc, axis, eps):
    """The parameter interval, on the intersection line's dominant axis,
    where the triangle crosses the other plane: (lo, hi), NaN where no edge
    crosses (jnp.nanmin/nanmax of JAX's)."""
    proj = torch.stack([x.gather(-1, axis[..., None])[..., 0] for x in (pa, pb, pc)], dim=-1)
    dvals = torch.stack([da, db, dc], dim=-1)
    params = []
    for i, j in ((0, 1), (1, 2), (2, 0)):
        di, dj = dvals[..., i], dvals[..., j]
        t = di / torch.where(torch.abs(di - dj) > eps, di - dj, 1.0)
        p = proj[..., i] + (proj[..., j] - proj[..., i]) * t
        params.append(torch.where(di * dj < 0, p, torch.nan))
    ps = torch.stack(params, dim=-1)
    none = torch.isnan(ps).all(-1)
    lo = torch.where(none, torch.nan, torch.where(torch.isnan(ps), torch.inf, ps).amin(-1))
    hi = torch.where(none, torch.nan, torch.where(torch.isnan(ps), -torch.inf, ps).amax(-1))
    return lo, hi


def _tri_tri_intersect(p1, q1, r1, p2, q2, r2, eps=1e-9):
    """Batched Möller triangle-triangle intersection predicate, each
    argument (..., 3) → bool (...,): each triangle must straddle the other's
    plane, and their intervals on the intersection line must overlap."""
    n1, d1 = _plane(p1, q1, r1)
    da, db, dc = _dists(n1, d1, p2, q2, r2)
    same_side_2 = ((da > eps) & (db > eps) & (dc > eps)) | \
        ((da < -eps) & (db < -eps) & (dc < -eps))
    n2, d2 = _plane(p2, q2, r2)
    ea, eb, ec = _dists(n2, d2, p1, q1, r1)
    same_side_1 = ((ea > eps) & (eb > eps) & (ec > eps)) | \
        ((ea < -eps) & (eb < -eps) & (ec < -eps))
    axis = torch.argmax(torch.abs(torch.linalg.cross(n1, n2)), dim=-1)
    lo1, hi1 = _interval(p1, q1, r1, ea, eb, ec, axis, eps)
    lo2, hi2 = _interval(p2, q2, r2, da, db, dc, axis, eps)
    overlap = (hi1 >= lo2) & (hi2 >= lo1) & ~torch.isnan(lo1) & ~torch.isnan(lo2)
    return overlap & ~same_side_1 & ~same_side_2


def intersect_mesh_brute_force(vertices, faces, chunk: int = 256) -> np.ndarray:
    """All intersecting face pairs (i < j), pairs sharing a vertex excluded
    (intersectMeshBruteForce, intersection.h:47), tested on the vertices'
    device → (N, 2) numpy array."""
    vertices = torch.as_tensor(vertices)
    faces_np = np.asarray(to_host(faces))
    f = faces_np.shape[0]
    pairs = np.asarray([(i, j) for i in range(f) for j in range(i + 1, f)
                        if not set(faces_np[i]) & set(faces_np[j])], np.int32)
    if len(pairs) == 0:
        return np.zeros((0, 2), np.int32)
    tri = vertices[torch.as_tensor(faces_np.astype(np.int64), device=vertices.device)]
    pt = torch.as_tensor(pairs.astype(np.int64), device=vertices.device)
    a, b = tri[pt[:, 0]], tri[pt[:, 1]]
    hit = _tri_tri_intersect(a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])
    return pairs[to_host(hit)]


def support_polygon(points, up_axis: int = 1, height_tolerance: float = 0.05) -> np.ndarray:
    """2-D convex hull of the lowest contact points (support_polygon.h),
    on the host: points (N, 3) → hull (H, 2) in CCW order, from the points
    within `height_tolerance` of the minimum along the up axis."""
    pts = np.asarray(to_host(points))
    h = pts[:, up_axis]
    contact = pts[h <= h.min() + height_tolerance]
    xy = contact[:, [i for i in range(3) if i != up_axis]]
    if len(xy) < 3:
        return xy
    # Andrew's monotone chain
    xy = xy[np.lexsort((xy[:, 1], xy[:, 0]))]

    def half(points_iter):
        out = []
        for p in points_iter:
            while len(out) >= 2 and ((out[-1] - out[-2])[0] * (p - out[-2])[1]
                                     - (out[-1] - out[-2])[1] * (p - out[-2])[0]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(xy)
    upper = half(xy[::-1])
    return np.asarray(lower[:-1] + upper[:-1])
