"""Closest-point primitives, after momentum_tpu/math/geometry.py: between
two segments (the reference's math/utility.cpp closestPointsOnSegments,
which collision needs), on a segment, and on a triangle (axel's
PointTriangleProjection.h).
"""

from __future__ import annotations

import torch

__all__ = ["closest_points_on_segments", "closest_point_on_segment",
           "point_triangle_closest_point"]

_EPS = 1e-12


def closest_points_on_segments(o1, d1, o2, d2):
    """(s, t, distance) of the closest points p(s) = o1 + s·d1 and
    q(t) = o2 + t·d2, s, t ∈ [0, 1]: Ericson RTCD §5.1.9 with every branch
    a select. Each division's denominator is replaced where its branch is
    not taken (torch.where evaluates both), and the distance's norm takes
    + eps inside, as in JAX."""
    r = o1 - o2
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    denom = a * e - b * b
    a_deg = a <= _EPS
    e_deg = e <= _EPS

    # the general case's first s, clamped; parallel segments (denom ≈ 0) take s = 0
    s = torch.where(denom > _EPS,
                    torch.clamp((b * f - c * e) / torch.where(denom > _EPS, denom, 1.0),
                                0.0, 1.0), 0.0)
    t = torch.where(e_deg, 0.0, (b * s + f) / torch.where(e_deg, 1.0, e))
    t_cl = torch.clamp(t, 0.0, 1.0)
    # s again for the clamped t
    s = torch.where(a_deg, 0.0,
                    torch.clamp((b * t_cl - c) / torch.where(a_deg, 1.0, a), 0.0, 1.0))
    s = torch.where(a_deg & e_deg, 0.0, s)  # both degenerate: two points
    t_cl = torch.where(a_deg, torch.clamp(f / torch.where(e_deg, 1.0, e), 0.0, 1.0), t_cl)
    t_cl = torch.where(e_deg, 0.0, t_cl)

    p = o1 + s[..., None] * d1
    q = o2 + t_cl[..., None] * d2
    return s, t_cl, torch.linalg.vector_norm(p - q + _EPS, dim=-1)


def closest_point_on_segment(origin, direction, point):
    """Clamped parameter t ∈ [0, 1] of the closest point origin + t·direction
    to `point` (collision_geometry_state.h:160-171); 0 on a degenerate
    segment."""
    d2 = torch.sum(direction * direction, dim=-1)
    t = torch.sum((point - origin) * direction, dim=-1) / torch.clamp(d2, min=_EPS)
    return torch.where(d2 <= _EPS, 0.0, torch.clamp(t, 0.0, 1.0))


def point_triangle_closest_point(p, a, b, c):
    """(point, barycentric (..., 3)) of the closest point on triangle
    (a, b, c) to p: Ericson RTCD §5.1.5 with every region a select, in
    JAX's order (the face, then the vertex regions, the edge regions and
    the vertex regions again, which win over the edges)."""
    ab, ac = b - a, c - a
    d1 = torch.sum(ab * (p - a), dim=-1)
    d2 = torch.sum(ac * (p - a), dim=-1)
    d3 = torch.sum(ab * (p - b), dim=-1)
    d4 = torch.sum(ac * (p - b), dim=-1)
    d5 = torch.sum(ab * (p - c), dim=-1)
    d6 = torch.sum(ac * (p - c), dim=-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(num, den):
        return num / torch.where(torch.abs(den) > _EPS, den, 1.0)

    denom = va + vb + vc
    v_face, w_face = safe(vb, denom), safe(vc, denom)
    v_ab = safe(d1, d1 - d3)
    w_ac = safe(d2, d2 - d6)
    w_bc = safe(d4 - d3, (d4 - d3) + (d5 - d6))
    one, zero = torch.ones_like(v_face), torch.zeros_like(v_face)
    bary = torch.stack([1.0 - v_face - w_face, v_face, w_face], dim=-1)
    vertices = (((d1 <= 0) & (d2 <= 0), torch.stack([one, zero, zero], dim=-1)),
                ((d3 >= 0) & (d4 <= d3), torch.stack([zero, one, zero], dim=-1)),
                ((d6 >= 0) & (d5 <= d6), torch.stack([zero, zero, one], dim=-1)))
    edges = (((vc <= 0) & (d1 >= 0) & (d3 <= 0), torch.stack([1.0 - v_ab, v_ab, zero], dim=-1)),
             ((vb <= 0) & (d2 >= 0) & (d6 <= 0), torch.stack([1.0 - w_ac, zero, w_ac], dim=-1)),
             ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
              torch.stack([zero, 1.0 - w_bc, w_bc], dim=-1)))
    for region, value in vertices + edges + vertices:
        bary = torch.where(region[..., None], value, bary)
    point = bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c
    return point, bary
