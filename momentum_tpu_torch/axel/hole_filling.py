"""Mesh hole detection + filling (host-side preprocessing, numpy), the
port's own copy of momentum_tpu/axel/hole_filling.py: it takes and returns
numpy arrays, as JAX's does.

Reference: axel/axel/math/MeshHoleFilling.{h,cpp} — detect boundary-edge
loops (directed edges with no opposite), then fill each hole with one of:
centroid fan (default, best for SDF generation), ear clipping (no new
vertices), spherical cap (smooth SDF gradients near cut boundaries), or
auto (centroid for ≤8 boundary vertices, ear clipping for larger). New
vertices can be Laplacian-smoothed afterwards.

This is mesh conditioning that runs once on the host before meshes are
shipped to the device (e.g. ahead of axel.sdf.mesh_to_sdf, which assumes a
closed surface), so it is plain numpy by design.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HoleBoundary",
    "detect_mesh_holes",
    "fill_mesh_holes",
    "fill_hole",
]


@dataclasses.dataclass
class HoleBoundary:
    """Ordered boundary loop of a hole (MeshHoleFilling.h HoleBoundary)."""

    vertices: np.ndarray  # (B,) ordered vertex indices
    center: np.ndarray  # (3,)
    radius: float


def _boundary_edges(faces):
    """Directed edges that appear exactly once (their reverse is absent)."""
    f = np.asarray(faces, np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    fwd = set(map(tuple, e.tolist()))
    return [(a, b) for a, b in fwd if (b, a) not in fwd]


def detect_mesh_holes(vertices, faces):
    """→ list[HoleBoundary], one per closed boundary loop
    (MeshHoleFilling.cpp detectMeshHoles)."""
    vertices = np.asarray(vertices, np.float64)
    edges = _boundary_edges(faces)
    nxt = {}
    for a, b in edges:
        nxt.setdefault(a, []).append(b)

    holes = []
    used = set()
    for a, b in edges:
        if (a, b) in used:
            continue
        loop = [a]
        cur, start = b, a
        used.add((a, b))
        closed = False
        for _ in range(len(edges) + 1):
            loop.append(cur)
            if cur == start:
                closed = True
                break
            cands = [v for v in nxt.get(cur, []) if (cur, v) not in used]
            if not cands:
                break
            used.add((cur, cands[0]))
            cur = cands[0]
        if not closed or len(loop) < 4:  # loop includes the repeated start
            continue
        vs = np.asarray(loop[:-1], np.int64)
        pts = vertices[vs]
        center = pts.mean(0)
        radius = float(np.linalg.norm(pts - center, axis=-1).mean())
        holes.append(HoleBoundary(vertices=vs, center=center, radius=radius))
    return holes


def _hole_normal(pts, center):
    """Average of normalized cross products from the centroid
    (MeshHoleFilling.cpp fillHoleWithCentroid normal estimate)."""
    e1 = pts - center
    e2 = np.roll(pts, -1, axis=0) - center
    cr = np.cross(e1, e2)
    n = np.linalg.norm(cr, axis=-1, keepdims=True)
    cr = np.where(n > 1e-12, cr / np.maximum(n, 1e-12), 0.0)
    total = cr.sum(0)
    tn = np.linalg.norm(total)
    return (total / tn, True) if tn > 1e-6 else (np.zeros(3), False)


def _fill_centroid(hole, vertices):
    pts = vertices[hole.vertices]
    center = pts.mean(0)
    normal, ok = _hole_normal(pts, center)
    if ok:
        center = center + 0.1 * hole.radius * normal
    b = len(hole.vertices)
    cidx = len(vertices)
    tris = [(hole.vertices[(i + 1) % b], hole.vertices[i], cidx)
            for i in range(b)]
    return np.asarray([center], np.float64), np.asarray(tris, np.int64)


def _fill_spherical_cap(hole, vertices, cap_height_ratio=0.5):
    pts = vertices[hole.vertices]
    center = pts.mean(0)
    normal, ok = _hole_normal(pts, center)
    if not ok:
        return _fill_centroid(hole, vertices)
    normal = -normal  # bulge outward (MeshHoleFilling.cpp:254-256)
    b = len(hole.vertices)
    radius = float(np.linalg.norm(pts - center, axis=-1).mean())
    n_rings = min(4, max(2, b // 4))
    base = len(vertices)

    new_v = []
    for k in range(1, n_rings + 1):
        theta = k / n_rings * (np.pi / 2)
        rf = np.cos(theta)
        off = cap_height_ratio * radius * np.sin(theta)
        new_v.extend(center + rf * (pts - center) + off * normal)
    pole = center + cap_height_ratio * radius * normal
    new_v.append(pole)
    pole_idx = base + n_rings * b

    tris = []
    for k in range(n_rings):
        for i in range(b):
            ni = (i + 1) % b
            if k == 0:
                c0, c1 = hole.vertices[i], hole.vertices[ni]
            else:
                c0, c1 = base + (k - 1) * b + i, base + (k - 1) * b + ni
            n0, n1 = base + k * b + i, base + k * b + ni
            tris.append((c1, c0, n0))
            tris.append((c1, n0, n1))
    for i in range(b):
        ni = (i + 1) % b
        tris.append((base + (n_rings - 1) * b + ni,
                     base + (n_rings - 1) * b + i, pole_idx))
    return np.asarray(new_v, np.float64), np.asarray(tris, np.int64)


def _point_in_triangle(p, a, b, c):
    n = np.cross(b - a, c - a)
    nn = np.dot(n, n)
    if nn < 1e-18:
        return False
    # barycentric via projected areas
    w = np.dot(np.cross(b - a, p - a), n) / nn
    v = np.dot(np.cross(p - a, c - a), n) / nn
    u = 1.0 - v - w
    return (u > 1e-9) and (v > 1e-9) and (w > 1e-9)


def _fill_ear_clipping(hole, vertices):
    remaining = list(hole.vertices)
    tris = []
    while len(remaining) > 3:
        best_q, best_i, found = -1.0, 0, False
        n = len(remaining)
        for i in range(n):
            vi1, vi2, vi3 = (remaining[(i - 1) % n], remaining[i],
                             remaining[(i + 1) % n])
            p1, p2, p3 = vertices[vi1], vertices[vi2], vertices[vi3]
            cr = np.cross(p2 - p1, p3 - p2)
            crn = np.linalg.norm(cr)
            if crn <= 1e-6:
                continue
            area = 0.5 * crn
            per = (np.linalg.norm(p2 - p1) + np.linalg.norm(p3 - p2)
                   + np.linalg.norm(p1 - p3))
            quality = area / (per * per)
            is_ear = all(
                not _point_in_triangle(vertices[remaining[j]], p1, p2, p3)
                for j in range(n) if j not in ((i - 1) % n, i, (i + 1) % n))
            if is_ear and quality > best_q:
                best_q, best_i, found = quality, i, True
        if found:
            n = len(remaining)
            tris.append((remaining[(best_i + 1) % n], remaining[best_i],
                         remaining[(best_i - 1) % n]))
            remaining.pop(best_i)
        else:
            tris.append((remaining[2], remaining[1], remaining[0]))
            remaining.pop(1)
    if len(remaining) == 3:
        tris.append((remaining[2], remaining[1], remaining[0]))
    return np.zeros((0, 3), np.float64), np.asarray(tris, np.int64)


def fill_hole(hole, vertices, method="centroid", cap_height_ratio=0.5):
    """→ (new_vertices (M, 3), new_triangles (T, 3)) for one hole."""
    vertices = np.asarray(vertices, np.float64)
    if method == "auto":
        method = "centroid" if len(hole.vertices) <= 8 else "ear_clipping"
    if method == "centroid":
        return _fill_centroid(hole, vertices)
    if method == "spherical_cap":
        return _fill_spherical_cap(hole, vertices, cap_height_ratio)
    if method == "ear_clipping":
        return _fill_ear_clipping(hole, vertices)
    raise ValueError(f"unknown hole-filling method {method!r}")


def fill_mesh_holes(vertices, faces, method="centroid", max_hole_size=None,
                    smoothing_iterations=0, smoothing_factor=0.5,
                    cap_height_ratio=0.5):
    """Fill every detected hole; → (vertices, faces, n_filled)
    (MeshHoleFilling.cpp fillMeshHoles). Holes with more than
    `max_hole_size` boundary vertices are left open. New vertices get
    `smoothing_iterations` rounds of Laplacian smoothing against the final
    triangulation (smoothHoleFilledRegion)."""
    vertices = np.asarray(vertices, np.float64).copy()
    faces = np.asarray(faces, np.int64).copy()
    holes = detect_mesh_holes(vertices, faces)
    new_vertex_start = len(vertices)
    filled = 0
    for hole in holes:
        if max_hole_size is not None and len(hole.vertices) > max_hole_size:
            continue
        nv, nt = fill_hole(hole, vertices, method, cap_height_ratio)
        if len(nv):
            vertices = np.concatenate([vertices, nv], 0)
        if len(nt):
            faces = np.concatenate([faces, nt], 0)
            filled += 1

    if smoothing_iterations > 0 and len(vertices) > new_vertex_start:
        new_set = np.zeros(len(vertices), bool)
        new_set[new_vertex_start:] = True
        # neighbor lists from the final triangulation
        nbrs = [[] for _ in range(len(vertices))]
        for a, b, c in faces:
            nbrs[a] += [b, c]
            nbrs[b] += [a, c]
            nbrs[c] += [a, b]
        for _ in range(smoothing_iterations):
            upd = vertices.copy()
            for i in np.nonzero(new_set)[0]:
                if nbrs[i]:
                    avg = vertices[list(set(nbrs[i]))].mean(0)
                    upd[i] = vertices[i] + smoothing_factor * (avg - vertices[i])
            vertices = upd
    return vertices, faces, filled


def smooth_mesh_laplacian(vertices, faces, vertex_mask=None,
                          iterations: int = 1, step: float = 0.5):
    """Standalone umbrella-operator Laplacian smoothing (pymomentum.axel
    smooth_mesh_laplacian): each selected vertex moves `step` of the way
    toward the average of its one-ring neighbors per iteration; vertices
    outside `vertex_mask` stay pinned."""
    vertices = np.asarray(vertices, np.float64).copy()
    faces = np.asarray(faces, np.int64)
    nv = vertices.shape[0]
    if vertex_mask is None:
        mask = np.ones(nv, bool)
    else:
        vm = np.asarray(vertex_mask)
        if vm.dtype == bool:
            mask = vm
        else:
            mask = np.zeros(nv, bool)
            mask[vm.astype(np.int64)] = True

    # one-ring adjacency from face edges
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    edges = np.concatenate([edges, edges[:, ::-1]])
    for _ in range(max(0, iterations)):
        acc = np.zeros_like(vertices)
        cnt = np.zeros(nv)
        np.add.at(acc, edges[:, 0], vertices[edges[:, 1]])
        np.add.at(cnt, edges[:, 0], 1.0)
        avg = acc / np.maximum(cnt, 1.0)[:, None]
        move = mask & (cnt > 0)
        vertices[move] += step * (avg[move] - vertices[move])
    return vertices
