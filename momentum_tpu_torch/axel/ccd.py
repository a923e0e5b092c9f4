"""Continuous collision detection, batched and branch-free, after
momentum_tpu/axel/ccd.py (the reference's
axel/math/ContinuousCollisionDetection.cpp): the times in (0, dt] at which
four moving points become coplanar (a cubic in t, CoplanarityCheck.cpp
timesCoplanar), then a proximity test at each candidate time
(EdgeEdgeDistance.cpp, PointTriangleProjection.cpp). Every candidate root
is evaluated and the hits reduced with a masked any, over a leading pair
axis.
"""

from __future__ import annotations

import math

import torch

from momentum_tpu_torch.math.geometry import (
    closest_points_on_segments, point_triangle_closest_point)

__all__ = ["solve_cubic", "times_coplanar", "ccd_edge_edge", "ccd_vertex_triangle",
           "distance_edge_edge"]

_EPS = 1e-12


def solve_cubic(c3, c2, c1, c0):
    """Real roots of c3·t³ + c2·t² + c1·t + c0 = 0, batched → (roots (..., 3),
    valid (..., 3) bool). Degenerate leading coefficients (|c| ≤ 1e-30) fall
    through to the quadratic and linear solves by select
    (CoplanarityCheck.cpp:11-73); invalid slots carry 0."""
    c3, c2, c1, c0 = (torch.as_tensor(x) for x in (c3, c2, c1, c0))
    c3_deg = torch.abs(c3) <= 1e-30
    c2_deg = torch.abs(c2) <= 1e-30
    c1_deg = torch.abs(c1) <= 1e-30

    # cubic, normalized: t³ + a t² + b t + c
    safe3 = torch.where(c3_deg, 1.0, c3)
    a, b, c = c2 / safe3, c1 / safe3, c0 / safe3
    a2 = a * a
    q = (a2 - 3.0 * b) / 9.0
    r = (a * (2.0 * a2 - 9.0 * b) + 27.0 * c) / 54.0
    r2 = r * r
    q3 = q * q * q
    three_real = r2 < q3
    # three real roots: the trigonometric form
    tt = torch.acos(torch.clamp(r / torch.sqrt(torch.where(three_real, q3, 1.0)), -1.0, 1.0))
    qs = -2.0 * torch.sqrt(torch.clamp(q, min=0.0))
    a3 = a / 3.0
    r0 = qs * torch.cos(tt / 3.0) - a3
    r1 = qs * torch.cos((tt + 2.0 * math.pi) / 3.0) - a3
    r2_ = qs * torch.cos((tt - 2.0 * math.pi) / 3.0) - a3
    # one real root: Cardano
    arg = torch.clamp(r2 - q3, min=0.0)
    aa = -torch.sign(r) * torch.pow(torch.abs(r) + torch.sqrt(arg), 1.0 / 3.0)
    big = torch.abs(aa) > _EPS
    bb = torch.where(big, q / torch.where(big, aa, 1.0), 0.0)
    single = (aa + bb) - a3
    cub_roots = torch.stack([torch.where(three_real, r0, single),
                             torch.where(three_real, r1, single),
                             torch.where(three_real, r2_, single)], dim=-1)
    cub_valid = torch.stack([torch.ones_like(three_real), three_real, three_real], dim=-1)

    # quadratic: c2 t² + c1 t + c0
    safe2 = torch.where(c2_deg, 1.0, c2)
    disc = c1 * c1 - 4.0 * c2 * c0
    has = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q0 = (-c1 + sq) / (2.0 * safe2)
    q1 = (-c1 - sq) / (2.0 * safe2)
    quad_roots = torch.stack([q0, q1, torch.zeros_like(q0)], dim=-1)
    quad_valid = torch.stack([has, has & (disc > 1e-9), torch.zeros_like(has)], dim=-1)

    # linear: c1 t + c0
    lin_root = -c0 / torch.where(c1_deg, 1.0, c1)
    lin_roots = torch.stack([lin_root, torch.zeros_like(lin_root), torch.zeros_like(lin_root)],
                            dim=-1)
    lin_valid = torch.stack([~c1_deg, torch.zeros_like(c1_deg), torch.zeros_like(c1_deg)],
                            dim=-1)

    roots = torch.where(c3_deg[..., None],
                        torch.where(c2_deg[..., None], lin_roots, quad_roots), cub_roots)
    valid = torch.where(c3_deg[..., None],
                        torch.where(c2_deg[..., None], lin_valid, quad_valid), cub_valid)
    return roots, valid


def _det(u, v, w):
    return torch.sum(torch.linalg.cross(u, v) * w, dim=-1)


def times_coplanar(x1, x2, x3, x4, v1, v2, v3, v4):
    """Times at which the four moving points are coplanar: the roots of
    (x21 + t·v21)×(x31 + t·v31)·(x41 + t·v41) = 0 (CoplanarityCheck.cpp
    timesCoplanar) → (roots (..., 3), valid)."""
    x21, x31, x41 = x2 - x1, x3 - x1, x4 - x1
    v21, v31, v41 = v2 - v1, v3 - v1, v4 - v1
    c3 = _det(v21, v31, v41)
    c2 = _det(x21, v31, v41) + _det(v21, x31, v41) + _det(v21, v31, x41)
    c1 = _det(x21, x31, v41) + _det(x21, v31, x41) + _det(v21, x31, x41)
    c0 = _det(x21, x31, x41)
    return solve_cubic(c3, c2, c1, c0)


def distance_edge_edge(p1, q1, p2, q2):
    """Closest-point distance between segments [p1, q1] and [p2, q2]
    (EdgeEdgeDistance.cpp distanceEdgeEdge) → (s, t, distance,
    nondegenerate), the last False where both segments collapse to points."""
    s, t, dist = closest_points_on_segments(p1, q1 - p1, p2, q2 - p2)
    a = torch.sum((q1 - p1) ** 2, dim=-1)
    e = torch.sum((q2 - p2) ** 2, dim=-1)
    return s, t, dist, ~((a <= 1e-5) & (e <= 1e-5))


def _candidate_times(x1, x2, x3, x4, v1, v2, v3, v4, dt):
    """The coplanarity roots and dt itself (against numerical imprecision,
    ContinuousCollisionDetection.cpp:30-31), valid where in (0, dt]."""
    roots, valid = times_coplanar(x1, x2, x3, x4, v1, v2, v3, v4)
    dt_col = torch.full(roots.shape[:-1] + (1,), float(dt), dtype=roots.dtype,
                        device=roots.device)
    times = torch.cat([roots, dt_col], dim=-1)
    ok = torch.cat([valid, torch.ones_like(dt_col, dtype=torch.bool)], dim=-1)
    return times, ok & (times > 0.0) & (times <= dt)


def _at(x, v, tt):
    return x[..., None, :] + tt * v[..., None, :]


def ccd_edge_edge(x1, x2, x3, x4, v1, v2, v3, v4, distance_threshold, dt):
    """True where the moving edges (x1, x2) + t·(v1, v2) and (x3, x4) +
    t·(v3, v4) pass within `distance_threshold` during (0, dt]
    (ContinuousCollisionDetection.cpp ccdEdgeEdge); points (..., 3), the
    result (...,) bool."""
    times, ok = _candidate_times(x1, x2, x3, x4, v1, v2, v3, v4, dt)
    tt = times[..., None]
    _, _, dist, nondeg = distance_edge_edge(_at(x1, v1, tt), _at(x2, v2, tt),
                                            _at(x3, v3, tt), _at(x4, v4, tt))
    return torch.any(ok & nondeg & (dist < distance_threshold), dim=-1)


def ccd_vertex_triangle(x1, x2, x3, x4, v1, v2, v3, v4, distance_threshold, dt):
    """True where the moving vertex x4 + t·v4 passes within
    `distance_threshold` of the moving triangle (x1, x2, x3) during (0, dt]
    with its closest point inside the triangle (projectOnTriangle's inside
    flag, ContinuousCollisionDetection.cpp:80-88)."""
    times, ok = _candidate_times(x1, x2, x3, x4, v1, v2, v3, v4, dt)
    tt = times[..., None]
    p = _at(x4, v4, tt)
    q, bary = point_triangle_closest_point(p, _at(x1, v1, tt), _at(x2, v2, tt),
                                           _at(x3, v3, tt))
    inside = torch.all(bary > 0.0, dim=-1) & torch.all(bary < 1.0, dim=-1)
    dist_sq = torch.sum((p - q) ** 2, dim=-1)
    return torch.any(ok & inside & (dist_sq < distance_threshold * distance_threshold), dim=-1)
