"""Uniform-grid acceleration for mesh queries, after
momentum_tpu/axel/grid.py (the reference's TriBvh broadphase, as a dense
grid): triangles binned to cells once on the host in float64 (padded
candidate lists, −1 for an empty slot), then each query gathers a fixed
3×3×3 cell neighbourhood of candidates (closest point) or walks the cells
along its ray by a fixed-length DDA (ray casting), with masked dense math
on the queries' device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from momentum_tpu_torch.axel.queries import closest_point_on_mesh
from momentum_tpu_torch.device import resolve, to_host
from momentum_tpu_torch.math.geometry import point_triangle_closest_point

__all__ = ["TriangleGrid", "build_triangle_grid", "closest_point_on_mesh_grid",
           "ray_mesh_intersect_grid"]


@dataclasses.dataclass(frozen=True, eq=False)
class TriangleGrid:
    """Dense (R³, K) triangle bins and the grid's frame. −1 pads empty slots."""

    cells: torch.Tensor  # (R, R, R, K) int32 triangle indices
    origin: torch.Tensor  # (3,)
    cell_size: torch.Tensor  # ()
    resolution: int

    @property
    def max_per_cell(self) -> int:
        return self.cells.shape[-1]


def build_triangle_grid(vertices, faces, resolution: int = 16, device="cuda") -> TriangleGrid:
    """Bin triangles into an R³ grid by bounding-box overlap, on the host in
    float64; the grid on `device` (the card unless the caller asks for the
    CPU)."""
    device = resolve(device, "build_triangle_grid")
    verts = np.asarray(to_host(vertices), np.float64)
    tris = np.asarray(to_host(faces), np.int64)
    lo = verts.min(0)
    hi = verts.max(0)
    # pad so no geometry lies exactly on a bounding face (rays hitting the
    # boundary would otherwise race the DDA exit test)
    margin = max(1e-6, 1e-3 * float((hi - lo).max()))
    lo = lo - margin
    hi = hi + margin
    cell = max(float((hi - lo).max()) / resolution, 1e-9)

    bins: dict = {}
    tv = verts[tris]  # (F, 3, 3)
    tlo = np.clip(np.floor((tv.min(1) - lo) / cell).astype(np.int64), 0, resolution - 1)
    thi = np.clip(np.floor((tv.max(1) - lo) / cell).astype(np.int64), 0, resolution - 1)
    for f in range(tris.shape[0]):
        for i in range(tlo[f, 0], thi[f, 0] + 1):
            for j in range(tlo[f, 1], thi[f, 1] + 1):
                for k in range(tlo[f, 2], thi[f, 2] + 1):
                    bins.setdefault((i, j, k), []).append(f)
    k_max = max((len(v) for v in bins.values()), default=1)
    cells = np.full((resolution,) * 3 + (k_max,), -1, np.int32)
    for (i, j, k), lst in bins.items():
        cells[i, j, k, : len(lst)] = lst
    return TriangleGrid(cells=torch.as_tensor(cells, device=device),
                        origin=torch.as_tensor(lo, dtype=torch.float32, device=device),
                        cell_size=torch.tensor(cell, dtype=torch.float32, device=device),
                        resolution=resolution)


def _offsets(device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


def closest_point_on_mesh_grid(grid: TriangleGrid, points, vertices, faces, exact: bool = True):
    """The closest surface point of each query among the triangles of its
    27-cell neighbourhood → (closest point (Q, 3), face index (Q,),
    squared distance (Q,)).

    exact=True also runs the brute-force query and takes its answer wherever
    the ring bound (found distance ≤ one cell) does not certify the grid's;
    exact=False returns the ring's answer as it is."""
    points = torch.as_tensor(points, dtype=torch.float32, device=grid.cells.device)
    vertices = torch.as_tensor(vertices, device=points.device)
    faces = torch.as_tensor(faces, device=points.device).long()
    r = grid.resolution
    cell_idx = torch.clamp(torch.floor((points - grid.origin) / grid.cell_size).long(), 0, r - 1)
    nb = torch.clamp(cell_idx[:, None, :] + _offsets(points.device)[None], 0, r - 1)
    cand = grid.cells[nb[..., 0], nb[..., 1], nb[..., 2]].reshape(points.shape[0], -1).long()
    valid = cand >= 0
    tri = faces[torch.clamp(cand, min=0)]  # (Q, C, 3)
    va, vb, vc = (vertices[tri[..., k]] for k in range(3))
    p = points[:, None, :]
    cp, _ = point_triangle_closest_point(p, va, vb, vc)
    d2 = torch.where(valid, torch.sum((p - cp) ** 2, dim=-1), math.inf)
    best = torch.argmin(d2, dim=-1)
    best_d2 = d2.gather(1, best[:, None])[:, 0]
    best_cp = cp.gather(1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    best_face = cand.gather(1, best[:, None])[:, 0]
    if not exact:
        return best_cp, best_face.to(torch.int32), best_d2
    # the ring holds the true closest triangle only when the distance found
    # is within one cell; elsewhere the brute-force answer stands
    ok = best_d2 <= grid.cell_size ** 2
    bf_cp, bf_face, _, bf_d2 = closest_point_on_mesh(points, vertices, faces)
    return (torch.where(ok[:, None], best_cp, bf_cp),
            torch.where(ok, best_face, bf_face).to(torch.int32),
            torch.where(ok, best_d2, bf_d2))


def ray_mesh_intersect_grid(grid: TriangleGrid, origins, directions, vertices, faces,
                            max_t=math.inf):
    """Grid-marched ray casting (TriBvh.rayHit): a DDA of 3R steps walks
    each ray's cells, every visited cell's candidates tested by
    Möller-Trumbore, the first hit winning; rays that leave the grid report
    no hit. → (t, face index, hit mask) per ray, as ray_mesh_intersect."""
    origins = torch.as_tensor(origins, dtype=torch.float32, device=grid.cells.device)
    o = origins
    d = torch.as_tensor(directions, dtype=torch.float32, device=o.device)
    vertices = torch.as_tensor(vertices, device=o.device)
    faces = torch.as_tensor(faces, device=o.device).long()
    r = grid.resolution
    cell = grid.cell_size
    a, b, c = (vertices[faces[:, k]] for k in range(3))
    e1, e2 = b - a, c - a

    dn = d / torch.clamp(torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-12)
    lo = grid.origin
    hi = grid.origin + cell * r
    safe = torch.where(torch.abs(dn) > 1e-12, dn, 1e-12)
    t_lo, t_hi = (lo - o) / safe, (hi - o) / safe
    t_near = torch.minimum(t_lo, t_hi).amax(-1)
    t_far = torch.maximum(t_lo, t_hi).amin(-1)
    t_cur = torch.clamp(t_near, min=0.0) + 1e-6
    alive = t_far >= t_cur
    t_best = torch.full_like(t_cur, math.inf)
    f_best = torch.full(t_cur.shape, -1, dtype=torch.int64, device=o.device)
    dir_ok = torch.abs(dn) > 1e-12
    for _ in range(3 * r):
        p = o + t_cur[:, None] * dn
        idx3 = torch.clamp(torch.floor((p - lo) / cell).long(), 0, r - 1)
        cand = grid.cells[idx3[:, 0], idx3[:, 1], idx3[:, 2]].long()  # (R, K)
        valid = cand >= 0
        cc = torch.clamp(cand, min=0)
        ca, ce1, ce2 = a[cc], e1[cc], e2[cc]
        dk = dn[:, None].expand_as(ce2)
        pvec = torch.linalg.cross(dk, ce2)
        det = torch.sum(ce1 * pvec, dim=-1)
        ok = torch.abs(det) > 1e-12
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        tvec = o[:, None] - ca
        u = torch.sum(tvec * pvec, dim=-1) * inv_det
        qvec = torch.linalg.cross(tvec, ce1)
        v = torch.sum(dk * qvec, dim=-1) * inv_det
        t = torch.sum(ce2 * qvec, dim=-1) * inv_det
        hit = valid & ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-8) & (t < max_t)
        t = torch.where(hit, t, math.inf)
        i = torch.argmin(t, dim=-1)
        t_i = t.gather(1, i[:, None])[:, 0]
        better = t_i < t_best
        t_new = torch.where(better, t_i, t_best)
        f_new = torch.where(better, cand.gather(1, i[:, None])[:, 0], f_best)
        t_best = torch.where(alive, t_new, t_best)
        f_best = torch.where(alive, f_new, f_best)
        # advance to the next cell boundary along the ray
        cell_lo = lo + idx3.to(torch.float32) * cell
        bounds = torch.where(dn >= 0, cell_lo + cell, cell_lo)
        t_exit = torch.where(dir_ok, (bounds - o) / torch.where(dir_ok, dn, 1.0),
                             math.inf).amin(-1)
        t_next = torch.maximum(t_exit, t_cur) + 1e-3 * cell
        # stop past the far plane, or on a hit before the current cell's
        # entry (first-hit semantics)
        alive = alive & (t_next <= t_far + 1e-2 * cell) & ~(t_best < t_cur)
        t_cur = t_next
    hit = torch.isfinite(t_best)
    return t_best, torch.where(hit, f_best, 0).to(torch.int32), hit
