"""Closest points between segments, the one geometry primitive collision
needs, after momentum_tpu/math/geometry.py (the reference's
math/utility.cpp closestPointsOnSegments).
"""

from __future__ import annotations

import torch

__all__ = ["closest_points_on_segments"]

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
