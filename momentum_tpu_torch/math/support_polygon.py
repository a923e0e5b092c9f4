"""Oriented support plane and the 2-D support polygon, after
momentum_tpu/math/support_polygon.py (the reference's
momentum/math/support_polygon.{h,cpp}): SupportPlaneT (an oriented plane
with an in-plane (u, v) basis, by default Y-up keeping world X and Z,
support_polygon.h:26-63), cross2d, computeConvexHull2d (Andrew's monotone
chain without duplicates or collinear points) and
computeSupportPolygonFromWorldPoints.

The plane's math is torch on its device; the hull, whose size depends on
the data, runs on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["SupportPlane", "cross2d", "convex_hull_2d", "support_polygon_from_world_points"]


@dataclasses.dataclass(frozen=True, eq=False)
class SupportPlane:
    """Oriented plane n·x = offset with the in-plane basis (u_axis, v_axis).
    The default (Y-up, u = +X, v = +Z) matches the reference's left-handed
    world-XZ support coordinates (support_polygon.h:19-24)."""

    normal: torch.Tensor  # (3,) unit
    offset: torch.Tensor  # ()
    u_axis: torch.Tensor  # (3,) unit, in-plane
    v_axis: torch.Tensor  # (3,) unit, in-plane

    @classmethod
    def create(cls, normal=(0.0, 1.0, 0.0), offset=0.0, u_hint=(1.0, 0.0, 0.0),
               device="cuda") -> "SupportPlane":
        """The plane on `device` (the card unless the caller asks for the
        CPU), its basis built in float64 on the host."""
        device = resolve(device, "SupportPlane.create")
        n = np.asarray(normal, np.float64)
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            raise ValueError("support plane normal must be non-zero")
        off = float(offset) / nn
        n = n / nn
        u = np.asarray(u_hint, np.float64)
        u = u - n * (n @ u)  # reject onto the plane
        if np.linalg.norm(u) < 1e-8:
            # u_hint collinear with the normal: a stable perpendicular
            # (support_polygon.cpp fallbackSupportPlaneAxis)
            e = np.zeros(3)
            e[int(np.argmin(np.abs(n)))] = 1.0
            u = e - n * (n @ e)
        u = u / np.linalg.norm(u)
        # v = u × n, so the default basis is (+X, +Z) under Y-up
        v = np.cross(u, n)
        v = v / np.linalg.norm(v)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return cls(normal=f32(n), offset=f32(off), u_axis=f32(u), v_axis=f32(v))

    def origin(self) -> torch.Tensor:
        return self.normal * self.offset

    def signed_distance(self, point: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...i,i->...", point, self.normal) - self.offset

    def project_point(self, point: torch.Tensor) -> torch.Tensor:
        return point - self.signed_distance(point)[..., None] * self.normal

    def coordinates(self, point: torch.Tensor) -> torch.Tensor:
        p = self.project_point(point) - self.origin()
        return torch.stack([torch.einsum("...i,i->...", p, self.u_axis),
                            torch.einsum("...i,i->...", p, self.v_axis)], dim=-1)

    def point_from_coordinates(self, uv: torch.Tensor) -> torch.Tensor:
        return self.origin() + uv[..., :1] * self.u_axis + uv[..., 1:2] * self.v_axis


def cross2d(origin, a, b):
    """Signed 2-D cross product (a − origin) × (b − origin), positive when
    origin → a → b turns counter-clockwise (support_polygon.h cross2d)."""
    o, a, b = (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
               for x in (origin, a, b))
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def convex_hull_2d(points) -> np.ndarray:
    """Convex hull of 2-D points, counter-clockwise, duplicates and
    collinear boundary points removed (computeConvexHull2d), on the host;
    degenerate inputs give 0, 1 or 2 points."""
    pts = np.asarray(to_host(points), np.float64).reshape(-1, 2)
    pts = pts[np.all(np.isfinite(pts), axis=1)]
    if len(pts) == 0:
        return np.zeros((0, 2), np.float32)
    pts = np.unique(pts, axis=0)  # sorts lexicographically (x, then y)
    if len(pts) <= 2:
        return pts.astype(np.float32)

    def cross(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(seq):
        hull = []
        for p in seq:
            while len(hull) >= 2 and cross(hull[-1] - hull[-2], p - hull[-2]) <= 1e-12:
                hull.pop()
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1], np.float64)
    if len(hull) < 3:  # all collinear
        return np.stack([pts[0], pts[-1]]).astype(np.float32)
    return hull.astype(np.float32)


def support_polygon_from_world_points(points, plane: SupportPlane | None = None) -> np.ndarray:
    """World points projected onto the support plane (by default Y-up
    through the origin, on the points' device) and hulled
    (computeSupportPolygonFromWorldPoints) → (H, 2) float32 in the plane's
    coordinates, counter-clockwise."""
    points = torch.as_tensor(points, dtype=torch.float32)
    if plane is None:
        plane = SupportPlane.create(device=points.device)
    return convex_hull_2d(plane.coordinates(points.to(plane.normal.device)))
