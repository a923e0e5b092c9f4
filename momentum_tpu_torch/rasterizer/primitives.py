"""Primitive tessellation and the convenience rasterizers — the port of
momentum_tpu/rasterizer/primitives.py.

Reference: pymomentum/renderer (renderer_pybind.cpp:261-833: subdivide_mesh,
rasterize_{mesh,wireframe,spheres,cylinders,capsules,skeleton,character,
checkerboard,grid,lines,circles}). Every primitive is tessellated once into
triangles on the host (numpy, the JAX package's arithmetic, so the meshes
are bit-equal) and rendered through `render_mesh` on the camera's device;
the 2-D helpers draw on host images with the viewer's `_draw_line`.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import to_host

__all__ = [
    "subdivide_mesh",
    "make_sphere",
    "make_cylinder",
    "make_capsule",
    "make_checkerboard",
    "make_grid_lines",
    "make_camera_frustum",
    "rasterize_spheres",
    "rasterize_cylinders",
    "rasterize_capsules",
    "rasterize_skeleton",
    "rasterize_character",
    "rasterize_wireframe",
    "rasterize_lines_2d",
    "rasterize_circles_2d",
]


def subdivide_mesh(vertices, faces, levels: int = 1):
    """Midpoint (loop-topology) subdivision (subdivideMesh,
    mesh_processing.h:19): each triangle splits into 4; midpoint vertices are
    shared across edges."""
    verts = np.asarray(vertices, np.float64)
    tris = np.asarray(faces, np.int64)
    for _ in range(levels):
        edge_mid = {}
        new_verts = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = len(new_verts)
                new_verts.append(0.5 * (verts[a] + verts[b]))
            return edge_mid[key]

        out = []
        for a, b, c in tris:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(new_verts)
        tris = np.asarray(out, np.int64)
    return verts.astype(np.float32), tris.astype(np.int32)


def make_sphere(subdivision_level: int = 2):
    """Unit icosphere (the reference's subdivided sphere primitive)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    v, f = subdivide_mesh(v, f, subdivision_level)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), f


def make_cylinder(length_subdivisions: int = 16,
                  radius_subdivisions: int = 16):
    """Unit cylinder along +x: x ∈ [0, 1], radius 1 (reference cylinders run
    along the transform's x axis)."""
    ls, rs = max(length_subdivisions, 1), max(radius_subdivisions, 3)
    ang = 2 * np.pi * np.arange(rs) / rs
    ring = np.stack([np.zeros(rs), np.cos(ang), np.sin(ang)], axis=1)
    verts = []
    for i in range(ls + 1):
        x = i / ls
        verts.append(ring + np.asarray([x, 0, 0]))
    verts = np.concatenate(verts)
    faces = []
    for i in range(ls):
        for r in range(rs):
            a = i * rs + r
            b = i * rs + (r + 1) % rs
            c, d = a + rs, b + rs
            faces += [[a, b, c], [b, d, c]]
    # caps
    c0 = len(verts)
    verts = np.concatenate([verts, [[0, 0, 0], [1, 0, 0]]])
    for r in range(rs):
        faces.append([c0, (r + 1) % rs, r])
        faces.append([c0 + 1, ls * rs + r, ls * rs + (r + 1) % rs])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def make_capsule(radius0: float = 1.0, radius1: float = 1.0,
                 length: float = 1.0, radius_subdivisions: int = 16,
                 cap_subdivisions: int = 8):
    """Tapered capsule along +x (the collision-geometry primitive)."""
    rs = max(radius_subdivisions, 3)
    cs = max(cap_subdivisions, 2)
    ang = 2 * np.pi * np.arange(rs) / rs
    cy, sz = np.cos(ang), np.sin(ang)
    rows = []
    # start cap (hemisphere at x=0, radius0), pole to equator
    for i in range(cs, 0, -1):
        phi = 0.5 * np.pi * i / cs
        x = -radius0 * np.sin(phi)
        r = radius0 * np.cos(phi)
        rows.append(np.stack([np.full(rs, x), r * cy, r * sz], 1))
    rows.append(np.stack([np.zeros(rs), radius0 * cy, radius0 * sz], 1))
    rows.append(np.stack([np.full(rs, length), radius1 * cy, radius1 * sz], 1))
    for i in range(1, cs + 1):
        phi = 0.5 * np.pi * i / cs
        x = length + radius1 * np.sin(phi)
        r = radius1 * np.cos(phi)
        rows.append(np.stack([np.full(rs, x), r * cy, r * sz], 1))
    verts = np.concatenate(rows)
    faces = []
    n_rows = len(rows)
    for i in range(n_rows - 1):
        for r in range(rs):
            a = i * rs + r
            b = i * rs + (r + 1) % rs
            c, d = a + rs, b + rs
            faces += [[a, b, c], [b, d, c]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def make_checkerboard(half_extent: float = 100.0, squares: int = 10):
    """Ground checkerboard in the XZ plane (rasterize_checkerboard):
    returns (verts, faces, face_colors)."""
    n = squares
    xs = np.linspace(-half_extent, half_extent, n + 1)
    verts, faces, colors = [], [], []
    for i in range(n):
        for j in range(n):
            b = len(verts)
            verts += [[xs[i], 0, xs[j]], [xs[i + 1], 0, xs[j]],
                      [xs[i + 1], 0, xs[j + 1]], [xs[i], 0, xs[j + 1]]]
            faces += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
            c = 0.8 if (i + j) % 2 == 0 else 0.4
            colors += [[c, c, c]] * 2
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(colors, np.float32))


def make_grid_lines(half_extent: float = 100.0, step: float = 10.0):
    """XZ grid line segments (rasterize_grid): (N, 2, 3) world segments."""
    ticks = np.arange(-half_extent, half_extent + step / 2, step)
    segs = []
    for t in ticks:
        segs.append([[t, 0, -half_extent], [t, 0, half_extent]])
        segs.append([[-half_extent, 0, t], [half_extent, 0, t]])
    return np.asarray(segs, np.float32)


def make_camera_frustum(camera, width: int, height: int, depth: float = 1.0) -> np.ndarray:
    """(8, 2, 3) wireframe segments of a camera's frustum
    (rasterize_camera_frustum), unprojected on the camera's device."""
    dev = camera.eye_from_world.device
    corners_px = np.asarray([[0, 0], [width, 0], [width, height], [0, height]], np.float32)
    uvz = np.concatenate([corners_px, np.full((4, 1), depth, np.float32)], 1)
    world = camera.unproject(torch.as_tensor(uvz, device=dev)).cpu().numpy()
    eye = camera.unproject(torch.as_tensor([[width / 2, height / 2, 1e-4]],
                                           dtype=torch.float32, device=dev)).cpu().numpy()[0]
    segs = []
    for i in range(4):
        segs.append([eye, world[i]])
        segs.append([world[i], world[(i + 1) % 4]])
    return np.asarray(segs, np.float32)


def _instance(template_v, template_f, transforms):
    """Replicate a template mesh under (N, 4, 4) affine transforms."""
    tv, tf = template_v, template_f
    n = transforms.shape[0]
    verts = np.einsum("nij,vj->nvi", transforms[:, :3, :3], tv) \
        + transforms[:, None, :3, 3]
    offs = (np.arange(n) * tv.shape[0])[:, None, None]
    faces = tf[None] + offs
    return verts.reshape(-1, 3).astype(np.float32), \
        faces.reshape(-1, 3).astype(np.int32)


def _x_aligned_transform(p0, p1, scale_yz):
    """Affine mapping the unit +x segment onto p0→p1 with radial scale."""
    d = p1 - p0
    ln = np.linalg.norm(d)
    x = d / max(ln, 1e-12)
    up = np.asarray([0.0, 1.0, 0.0]) if abs(x[1]) < 0.9 else \
        np.asarray([1.0, 0.0, 0.0])
    z = np.cross(x, up)
    z /= max(np.linalg.norm(z), 1e-12)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x * ln
    m[:3, 1] = y * scale_yz
    m[:3, 2] = z * scale_yz
    m[:3, 3] = p0
    return m


def _render(camera, v: np.ndarray, f: np.ndarray, width, height, **kw) -> dict:
    from momentum_tpu_torch.rasterizer.render import render_mesh

    dev = camera.eye_from_world.device
    return render_mesh(camera, torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev),
                       width, height, **kw)


def _spheres_mesh(centers, radii, subdivision_level: int = 2):
    """(vertices float32, faces int32) of icospheres, host numpy."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    radii = np.broadcast_to(np.asarray(radii, np.float64).reshape(-1), (centers.shape[0],))
    tv, tf = make_sphere(subdivision_level)
    tr = np.tile(np.eye(4), (centers.shape[0], 1, 1))
    tr[:, :3, :3] *= radii[:, None, None]
    tr[:, :3, 3] = centers
    return _instance(tv, tf, tr)


def rasterize_spheres(camera, centers, radii, width, height, subdivision_level: int = 2,
                      **kw) -> dict:
    """Spheres as one concatenated icosphere mesh through render_mesh."""
    return _render(camera, *_spheres_mesh(centers, radii, subdivision_level), width, height,
                   **kw)


def _cylinders_mesh(p0, p1, radii, radius_subdivisions: int = 16):
    """(vertices (N·V, 3) float32, faces (N·F, 3) int32) of cylinders from p0
    to p1 (one length subdivision), host numpy."""
    p0 = np.asarray(p0, np.float64).reshape(-1, 3)
    p1 = np.asarray(p1, np.float64).reshape(-1, 3)
    radii = np.broadcast_to(np.asarray(radii, np.float64).reshape(-1), (p0.shape[0],))
    tv, tf = make_cylinder(1, radius_subdivisions)
    tr = np.stack([_x_aligned_transform(a, b, r) for a, b, r in zip(p0, p1, radii)])
    return _instance(tv, tf, tr)


def rasterize_cylinders(camera, p0, p1, radii, width, height, radius_subdivisions: int = 16,
                        **kw) -> dict:
    """Cylinders from p0 to p1 (one length subdivision) through render_mesh."""
    return _render(camera, *_cylinders_mesh(p0, p1, radii, radius_subdivisions), width,
                   height, **kw)


def rasterize_capsules(camera, origins, directions, radii, width, height, **kw) -> dict:
    """Tapered capsules ((N, 3) origins, (N, 3) directions, (N, 2) radii)."""
    origins = np.asarray(origins, np.float64).reshape(-1, 3)
    directions = np.asarray(directions, np.float64).reshape(-1, 3)
    radii = np.asarray(radii, np.float64).reshape(-1, 2)
    vs, fs = [], []
    off = 0
    for o, d, (r0, r1) in zip(origins, directions, radii):
        ln = float(np.linalg.norm(d))
        tv, tf = make_capsule(r0, r1, max(ln, 1e-6))
        m = _x_aligned_transform(o, o + d, 1.0)
        m[:3, 0] /= max(ln, 1e-12)  # the capsule already has its length
        v = tv @ m[:3, :3].T + m[:3, 3]
        vs.append(v)
        fs.append(tf + off)
        off += len(v)
    return _render(camera, np.concatenate(vs).astype(np.float32),
                   np.concatenate(fs).astype(np.int32), width, height, **kw)



def _bones(skeleton, skel_states):
    """(p0, p1) host lists: each bone from its parent joint to its child (a
    stub at the root of a skeleton with no bones)."""
    states = to_host(skel_states)
    p0, p1 = [], []
    for j, p in enumerate(skeleton.parents_np):
        if p < 0:
            continue
        p0.append(states[p, :3])
        p1.append(states[j, :3])
    if not p0:
        p0 = [states[0, :3]]
        p1 = [states[0, :3] + 1e-3]
    return p0, p1


def rasterize_skeleton(camera, skeleton, skel_states, width, height,
                       bone_radius: float = 0.02, **kw) -> dict:
    """Bones as cylinders from each parent joint to its child
    (rasterize_skeleton)."""
    return rasterize_cylinders(camera, *_bones(skeleton, skel_states), bone_radius, width,
                               height, **kw)


def rasterize_character(camera, character, model_params, width, height, **kw) -> dict:
    """The posed skinned mesh if the character has one, else its skeleton
    (rasterize_character); the pose by character_state (FK through K1 on
    the card)."""
    from momentum_tpu_torch.character.character_state import character_state
    from momentum_tpu_torch.rasterizer.render import render_mesh

    mp = torch.as_tensor(model_params, dtype=torch.float32,
                         device=character.parameter_transform.transform.device)
    st = character_state(character.with_inverse_bind_pose(), mp, update_collision=False)
    if st.mesh_vertices is not None:
        return render_mesh(camera, st.mesh_vertices, character.mesh.faces, width, height, **kw)
    return rasterize_skeleton(camera, character.skeleton, st.skeleton_state, width, height,
                              **kw)


def rasterize_wireframe(camera, vertices, faces, width, height, color=(0.1, 0.9, 0.2),
                        buffer=None) -> np.ndarray:
    """Edge overlay by 2-D segments on a host image (rasterize_wireframe)."""
    from momentum_tpu_torch.gui.viewer import _draw_line

    img = np.zeros((height, width, 3), np.float32) if buffer is None \
        else np.array(to_host(buffer), copy=True)
    uvz, valid = camera.project(torch.as_tensor(vertices, dtype=torch.float32,
                                                device=camera.eye_from_world.device))
    uvz, valid = to_host(uvz), to_host(valid)
    col = np.asarray(color, np.float32)
    seen = set()
    for tri in to_host(faces):
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            key = (min(a, b), max(a, b))
            if key in seen or not (valid[a] and valid[b]):
                continue
            seen.add(key)
            img = _draw_line(img, uvz[a, 0], uvz[a, 1], uvz[b, 0], uvz[b, 1], col)
    return img


def rasterize_lines_2d(buffer, segments, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    """(N, 2, 2) pixel segments onto a host image (rasterize_lines_2d)."""
    from momentum_tpu_torch.gui.viewer import _draw_line

    img = np.array(to_host(buffer), copy=True)
    col = np.asarray(color, img.dtype)
    for (x0, y0), (x1, y1) in to_host(segments):
        img = _draw_line(img, x0, y0, x1, y1, col)
    return img


def rasterize_circles_2d(buffer, centers, radii, color=(1.0, 1.0, 1.0),
                         samples: int = 48) -> np.ndarray:
    """Circle outlines in pixel space on a host image (rasterize_circles_2d)."""
    from momentum_tpu_torch.gui.viewer import _draw_line

    img = np.array(to_host(buffer), copy=True)
    col = np.asarray(color, img.dtype)
    centers = np.asarray(to_host(centers), np.float64).reshape(-1, 2)
    radii = np.broadcast_to(np.asarray(to_host(radii), np.float64).reshape(-1),
                            (centers.shape[0],))
    ang = 2 * np.pi * np.arange(samples + 1) / samples
    for c, r in zip(centers, radii):
        xs = c[0] + r * np.cos(ang)
        ys = c[1] + r * np.sin(ang)
        for i in range(samples):
            img = _draw_line(img, xs[i], ys[i], xs[i + 1], ys[i + 1], col)
    return img
