"""Texture-based triangle classification and mesh splitting, the port's own
copy of momentum_tpu/character/texture_classification.py (host numpy; the
mesh's tensors are copied to the host, from the card where they lie there).

Reference: character/texture_classification.{h,cpp} — classify mesh triangles
into regions by sampling a texture at barycentric points
(classifyTrianglesByTexture) and split a mesh along texture-region boundaries
with binary-searched UV edge crossings (splitMeshByTextureRegion).

Host-side numpy (model-surgery at load time, like character_utility)."""

from __future__ import annotations

import numpy as np

from momentum_tpu_torch.device import to_host

__all__ = ["classify_triangles_by_texture", "split_mesh_by_texture_region"]

# barycentric sample patterns by sample count (texture_classification.cpp)
_BARY = {
    1: [(1 / 3, 1 / 3, 1 / 3)],
    3: [(2 / 3, 1 / 6, 1 / 6), (1 / 6, 2 / 3, 1 / 6), (1 / 6, 1 / 6, 2 / 3)],
    4: [(1 / 3, 1 / 3, 1 / 3), (0.6, 0.2, 0.2), (0.2, 0.6, 0.2),
        (0.2, 0.2, 0.6)],
    6: [(0.816, 0.092, 0.092), (0.092, 0.816, 0.092), (0.092, 0.092, 0.816),
        (0.108, 0.446, 0.446), (0.446, 0.108, 0.446), (0.446, 0.446, 0.108)],
    7: [(1 / 3, 1 / 3, 1 / 3), (0.8, 0.1, 0.1), (0.1, 0.8, 0.1),
        (0.1, 0.1, 0.8), (0.1, 0.45, 0.45), (0.45, 0.1, 0.45),
        (0.45, 0.45, 0.1)],
    10: [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
         (2 / 3, 1 / 3, 0.0), (1 / 3, 2 / 3, 0.0), (0.0, 2 / 3, 1 / 3),
         (0.0, 1 / 3, 2 / 3), (1 / 3, 0.0, 2 / 3), (2 / 3, 0.0, 1 / 3),
         (1 / 3, 1 / 3, 1 / 3)],
}


def _sample_nearest(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-texel RGB lookup; uv in [0, 1] with v up (GL convention)."""
    h, w = texture.shape[:2]
    x = np.clip(np.round(uv[..., 0] * (w - 1)).astype(int), 0, w - 1)
    y = np.clip(np.round((1.0 - uv[..., 1]) * (h - 1)).astype(int), 0, h - 1)
    return texture[y, x]


def _match_regions(colors: np.ndarray, region_colors: np.ndarray,
                   tol: int = 0) -> np.ndarray:
    """(..., 3) colors vs (R, 3) region colors → (..., R) bool."""
    diff = np.abs(colors[..., None, :].astype(int)
                  - region_colors[None, :].astype(int))
    return (diff <= tol).all(axis=-1)


def classify_triangles_by_texture(mesh, texture, region_colors,
                                  threshold: float = 0.0,
                                  num_samples: int = 3, tol: int = 0):
    """classifyTrianglesByTexture: per region, the sorted triangle indices
    whose texture samples match the region color.

    mesh needs texcoords (T, 2) and texcoord_faces (F, 3); `texture`
    (H, W, 3) uint8; region_colors (R, 3) uint8. A triangle belongs to a
    region when > threshold (or ≥1 when threshold == 0) of its `num_samples`
    barycentric samples match."""
    if num_samples not in _BARY:
        raise ValueError(f"num_samples must be one of {sorted(_BARY)}")
    tc = to_host(mesh.texcoords).astype(np.float64)
    tf = to_host(mesh.texcoord_faces if mesh.texcoord_faces is not None
                 else mesh.faces).astype(np.int64)
    texture = to_host(texture)
    region_colors = to_host(region_colors).reshape(-1, 3)
    bary = np.asarray(_BARY[num_samples])  # (S, 3)
    tri_uv = tc[tf]  # (F, 3, 2)
    samples = np.einsum("sc,fcx->fsx", bary, tri_uv)  # (F, S, 2)
    cols = _sample_nearest(texture, samples)  # (F, S, 3)
    match = _match_regions(cols, region_colors, tol)  # (F, S, R)
    frac = match.mean(axis=1)  # (F, R)
    if threshold <= 0.0:
        member = match.any(axis=1)
    else:
        member = frac >= threshold
    return [np.nonzero(member[:, r])[0].astype(np.int32)
            for r in range(region_colors.shape[0])]


def _inside(texture, region_colors, uv, tol):
    return _match_regions(_sample_nearest(texture, uv), region_colors,
                          tol).any(axis=-1)


def _edge_crossing(texture, region_colors, uv_in, uv_out, steps, tol):
    """Binary search the inside→outside boundary along a UV segment."""
    lo, hi = uv_in.copy(), uv_out.copy()
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        if _inside(texture, region_colors, mid[None], tol)[0]:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def split_mesh_by_texture_region(mesh, texture, region_colors,
                                 num_binary_search_steps: int = 8,
                                 tol: int = 0):
    """splitMeshByTextureRegion: keep the sub-mesh whose texture colors match
    region_colors, splitting boundary triangles along the UV region edge.

    Returns (vertices (V', 3), faces (F', 3)) numpy arrays."""
    verts = to_host(mesh.vertices).astype(np.float64)
    faces = to_host(mesh.faces).astype(np.int64)
    tc = to_host(mesh.texcoords).astype(np.float64)
    tf = to_host(mesh.texcoord_faces if mesh.texcoord_faces is not None
                 else mesh.faces).astype(np.int64)
    texture = to_host(texture)
    region_colors = to_host(region_colors).reshape(-1, 3)

    corner_uv = tc[tf]  # (F, 3, 2)
    inside = _inside(texture, region_colors,
                     corner_uv.reshape(-1, 2), tol).reshape(-1, 3)

    new_verts = list(verts)
    new_faces = []

    def cross_point(f, i_in, i_out):
        uv = _edge_crossing(texture, region_colors, corner_uv[f, i_in],
                            corner_uv[f, i_out], num_binary_search_steps, tol)
        # place the new vertex at the same parametric position in 3D
        a, b = corner_uv[f, i_in], corner_uv[f, i_out]
        denom = np.linalg.norm(b - a)
        t = np.linalg.norm(uv - a) / denom if denom > 1e-12 else 0.5
        p = (1 - t) * verts[faces[f, i_in]] + t * verts[faces[f, i_out]]
        new_verts.append(p)
        return len(new_verts) - 1

    for f in range(faces.shape[0]):
        ins = inside[f]
        k = int(ins.sum())
        if k == 3:
            new_faces.append(list(faces[f]))
        elif k == 0:
            continue
        elif k == 1:
            i = int(np.nonzero(ins)[0][0])
            j, l = (i + 1) % 3, (i + 2) % 3
            a = cross_point(f, i, j)
            b = cross_point(f, i, l)
            new_faces.append([faces[f, i], a, b])
        else:  # k == 2: quad → two triangles
            i = int(np.nonzero(~ins)[0][0])
            j, l = (i + 1) % 3, (i + 2) % 3
            a = cross_point(f, j, i)   # crossing on edge j→i
            b = cross_point(f, l, i)   # crossing on edge l→i
            new_faces.append([faces[f, j], faces[f, l], b])
            new_faces.append([faces[f, j], b, a])

    if not new_faces:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    nf = np.asarray(new_faces, np.int64)
    # compact to used vertices
    used = np.unique(nf)
    remap = -np.ones(len(new_verts), np.int64)
    remap[used] = np.arange(used.size)
    return (np.asarray(new_verts, np.float32)[used],
            remap[nf].astype(np.int32))
