"""Mesh rendering: project, rasterize, shade, texture and shadow-map — the
port of momentum_tpu/rasterizer/render.py.

Three rasterizers compute the same z-buffer (depth, face id, barycentrics):
  * `rasterize_planes` (ops/raster.py; kernels K4a/K4b on the card), the
    "planes" path, which "auto" takes on every device;
  * `rasterize`, dense: every `chunk` faces against every pixel, a Python
    loop over face blocks in place of JAX's `lax.scan`;
  * `rasterize_windowed`: each face inside a window of pixels around its
    bbox, visibility by one scatter-min of packed (depth, face id) keys,
    the largest faces in one dense pass.
Dense and windowed drop faces by |area| ≤ 1e-12 alone; planes also drops
faces with a screen coordinate ≥ 1e7 (ROADMAP F2).

`render_mesh` shades flat (one normal per face). On the planes path the
Lambert colour is computed once per face and rides the rasterizer's
constant-attribute planes; the other paths shade per pixel. The face
selection is not differentiable; the raster kernels refuse inputs that
require grad.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.character.skinning import update_normals
from momentum_tpu_torch.ops.raster import rasterize_planes

__all__ = ["rasterize", "rasterize_windowed", "shade_lambert", "shade_phong", "render_mesh",
           "interpolate_attribute", "sample_texture", "render_mesh_textured",
           "render_shadow_map", "shadow_factor", "render_mesh_shadowed", "shadowed_passes",
           "LIGHT_DIR"]

LIGHT_DIR = (0.3, -0.7, 0.6)  # the renders' default light direction
_INT32_MAX = (1 << 31) - 1


def _edges(ax, ay, bx, by, cx, cy, px, py):
    """Barycentrics (w0, w1, w2) of pixel centres (px, py) and the area
    test |area| > 1e-12, in JAX's order of operations."""
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = torch.abs(area) > 1e-12
    inv = torch.where(ok, 1.0 / area, 0.0)
    w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv
    w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv
    return w0, w1, 1.0 - w0 - w1, ok


def _pixel_grid(width: int, height: int, dtype, device):
    """(px, py) (H, W): the pixel centres."""
    xs = torch.arange(width, dtype=dtype, device=device) + 0.5
    ys = torch.arange(height, dtype=dtype, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def _dense_pass(tri, fid, valid, px, py, depth, face, bary):
    """Fold faces tri (C, 3, 3) with ids fid (C,) and mask valid (C,) into
    the z-buffer (depth, face, bary) over every pixel: per pixel the least
    depth among the covering faces, the first at equal depths, replacing
    the buffer's where strictly nearer."""
    t = [tri[:, i, j] for i in range(3) for j in range(3)]
    w0, w1, w2, ok = _edges(t[0], t[1], t[3], t[4], t[6], t[7], px[..., None], py[..., None])
    z = w0 * t[2] + w1 * t[5] + w2 * t[8]
    hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok & (z > 0) & valid
    z = torch.where(hit, z, torch.inf)
    k = torch.argmin(z, dim=-1, keepdim=True)  # the first least depth
    zbest = torch.gather(z, -1, k)[..., 0]
    better = zbest < depth
    bary_new = torch.cat([torch.gather(w, -1, k) for w in (w0, w1, w2)], dim=-1)
    return (torch.where(better, zbest, depth), torch.where(better, fid[k[..., 0]], face),
            torch.where(better[..., None], bary_new, bary))


def rasterize(verts_screen: torch.Tensor, faces: torch.Tensor, width: int, height: int,
              chunk: int = 64) -> dict:
    """Dense z-buffer rasterization.

    verts_screen (V, 3): pixel x, y and depth z (smaller is closer, only
    z > 0 drawn); faces (F, 3). Every `chunk` faces are tested against
    every pixel at once, an (H, W, chunk) block. Returns dict(depth (H, W)
    inf where empty, face (H, W) int32 −1 where empty, bary (H, W, 3))."""
    dev, dt = verts_screen.device, verts_screen.dtype
    f_count = faces.shape[0]
    tri = verts_screen[faces.long()]  # (F, 3, 3)
    px, py = _pixel_grid(width, height, dt, dev)
    depth = torch.full((height, width), torch.inf, dtype=dt, device=dev)
    face = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((height, width, 3), dtype=dt, device=dev)
    ids = torch.arange(f_count, dtype=torch.int32, device=dev)
    for c0 in range(0, f_count, chunk):
        sl = slice(c0, c0 + chunk)
        depth, face, bary = _dense_pass(tri[sl], ids[sl], True, px, py, depth, face, bary)
    return dict(depth=depth, face=face, bary=bary)


def rasterize_windowed(verts_screen: torch.Tensor, faces: torch.Tensor, width: int,
                       height: int, window: int = 32, big_capacity: int = 64) -> dict:
    """Z-buffer rasterization in per-face pixel windows.

    Each face whose screen bbox spans at most window − 1 pixels is tested
    only inside the window × window block at its bbox; a pixel keeps the
    least packed int32 key (zq << fid_bits) | face id, zq the depth
    quantized over the faces' z range, by one scatter-min (order-free: the
    keys are unique). Depth and barycentrics are then recomputed exactly at
    each winning pixel, so quantization only breaks ties between faces
    closer than ~range/2^zq_bits. The `big_capacity` faces of largest
    extent among the rest go through one dense pass. Returns rasterize's
    dict."""
    dev, dt = verts_screen.device, verts_screen.dtype
    # a window wider than the image would let a column escape its row and
    # wrap into the next one through the flat scatter index
    window = max(min(window, width, height), 1)
    f_count = faces.shape[0]
    fid_bits = max(1, int(np.ceil(np.log2(f_count + 1))))
    # ≤ 23 depth bits keep every quantized level exact in f32, so the clip
    # bound does not round past 2^zq_bits and overflow the shifted key
    zq_bits = min(31 - fid_bits, 23)
    if zq_bits < 12:
        raise ValueError(f"too many faces for packed scatter ({f_count})")
    zq_max = (1 << zq_bits) - 1

    tri = verts_screen[faces.long()]  # (F, 3, 3)
    x, y = tri[..., 0], tri[..., 1]
    xmin, xmax = x.amin(dim=1), x.amax(dim=1)
    ymin, ymax = y.amin(dim=1), y.amax(dim=1)
    inside_img = (xmax >= 0) & (xmin <= width) & (ymax >= 0) & (ymin <= height)
    extent = torch.maximum(xmax - xmin, ymax - ymin)
    small = inside_img & (extent <= window - 1)

    def origin(lo, size):  # NaN bboxes (never `small`) take window 0 (F3)
        lo = torch.where(torch.isnan(lo), 0.0, lo)
        return torch.clamp(torch.floor(lo - 0.5), 0, max(size - window, 0)).to(torch.int32)

    ii = torch.arange(window, dtype=torch.int32, device=dev)
    py_i = origin(ymin, height)[:, None, None] + ii[None, :, None]  # (F, K, 1)
    px_i = origin(xmin, width)[:, None, None] + ii[None, None, :]  # (F, 1, K)
    t = [tri[:, i, j, None, None] for i in range(3) for j in range(3)]
    w0, w1, w2, area_ok = _edges(t[0], t[1], t[3], t[4], t[6], t[7], px_i.to(dt) + 0.5,
                                 py_i.to(dt) + 0.5)
    z = w0 * t[2] + w1 * t[5] + w2 * t[8]
    ok = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > 0) & area_ok & small[:, None, None]

    # depth quantization over the face-vertex z range (only z > 0 matters)
    pos = tri[..., 2] > 0
    zmin = torch.where(pos, tri[..., 2], torch.inf).amin()
    zmax = torch.where(pos, tri[..., 2], -torch.inf).amax()
    zrange = torch.clamp(zmax - zmin, min=1e-6)
    # mask the lanes that draw nothing before the float → int cast: the
    # cast of inf or NaN is implementation-defined
    zf = torch.where(ok, (z - zmin) / zrange * zq_max, 0.0)
    zq = torch.clamp(zf, 0, zq_max).to(torch.int32)
    fids = torch.arange(f_count, dtype=torch.int32, device=dev)[:, None, None]
    packed = torch.where(ok, (zq << fid_bits) | fids, _INT32_MAX)
    flat = (py_i * width + px_i).reshape(-1).long()
    zbuf = torch.full((height * width,), _INT32_MAX, dtype=torch.int32, device=dev)
    zbuf = zbuf.scatter_reduce(0, flat, packed.reshape(-1), "amin", include_self=True)
    zbuf = zbuf.reshape(height, width)
    hit = zbuf != _INT32_MAX
    fid_w = torch.where(hit, zbuf & ((1 << fid_bits) - 1), 0)

    # the exact depth and barycentrics of each windowed winner
    gx, gy = _pixel_grid(width, height, dt, dev)
    tw = tri[fid_w.long()]  # (H, W, 3, 3)
    t = [tw[..., i, j] for i in range(3) for j in range(3)]
    w0, w1, w2, _ = _edges(t[0], t[1], t[3], t[4], t[6], t[7], gx, gy)
    depth = torch.where(hit, w0 * t[2] + w1 * t[5] + w2 * t[8], torch.inf)
    face = torch.where(hit, fid_w, -1)
    bary = torch.stack([w0, w1, w2], dim=-1)

    if big_capacity > 0 and f_count > 0:
        cap = min(big_capacity, f_count)
        score = torch.where(inside_img & ~small, extent, -torch.inf)
        # lax.top_k's order: descending, the lower index first among ties
        bidx = torch.sort(score, descending=True, stable=True).indices[:cap]
        bvalid = score[bidx] > -torch.inf
        depth, face, bary = _dense_pass(tri[bidx], bidx.to(torch.int32), bvalid, gx, gy,
                                        depth, face, bary)

    empty = face < 0
    return dict(depth=torch.where(empty, torch.inf, depth), face=face,
                bary=torch.where(empty[..., None], 0.0, bary))


def _auto_window(f_count: int, width: int, height: int) -> int:
    """The per-face window from the static sizes: the windowed pass costs
    O(F·K²) and the dense pass O(H·W·big_capacity) per frame whether or not
    any face reaches it, so K is the widest power of two (8 to 128) that
    keeps the windowed pass within ~4 images of work; wide windows let
    typical meshes send no face to the dense pass."""
    budget = 4 * width * height
    k = np.sqrt(max(budget // max(f_count, 1), 64))
    k = 1 << int(np.floor(np.log2(k)))
    return int(np.clip(k, 8, 128))


def _rasterize_dispatch(verts_screen, faces, width: int, height: int, chunk: int = 64,
                        method: str = "auto", window=None, big_capacity: int = 16,
                        vertex_attrs=None, face_attrs=None) -> dict:
    """"auto" and "planes" take `rasterize_planes` (kernels K4a/K4b on the
    card, the plain version on the CPU), with vertex_attrs/face_attrs fused
    into the pass; "windowed" (or "window") `rasterize_windowed`, the window
    by `_auto_window` unless given; anything else the dense `rasterize`.
    The attributes are ignored off the planes path: callers interpolate
    them separately."""
    if method in ("auto", "planes"):
        return rasterize_planes(verts_screen, faces, width, height,
                                vertex_attrs=vertex_attrs, face_attrs=face_attrs)
    if method in ("windowed", "window"):
        if window is None:
            window = _auto_window(faces.shape[0], width, height)
        return rasterize_windowed(verts_screen, faces, width, height, window=window,
                                  big_capacity=big_capacity)
    return rasterize(verts_screen, faces, width, height, chunk)


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def shade_lambert(normals: torch.Tensor, light_dir: torch.Tensor,
                  albedo=(0.8, 0.8, 0.8), ambient: float = 0.15) -> torch.Tensor:
    l = light_dir / torch.linalg.norm(light_dir)
    lam = torch.clamp(torch.einsum("...i,i->...", normals, -l), min=0.0)
    return _vec(albedo, normals) * (ambient + (1 - ambient) * lam[..., None])


def shade_phong(normals: torch.Tensor, view_dir: torch.Tensor, light_dir: torch.Tensor,
                albedo=(0.8, 0.8, 0.8), specular: float = 0.3, shininess: float = 16.0,
                ambient: float = 0.15) -> torch.Tensor:
    """Phong shading of (..., 3) normals under one directional light."""
    l = light_dir / torch.linalg.norm(light_dir)
    v = view_dir / torch.linalg.norm(view_dir)
    ndl = torch.einsum("...i,i->...", normals, -l)
    lam = torch.clamp(ndl, min=0.0)
    r = 2.0 * ndl[..., None] * normals + l
    spec = torch.clamp(torch.einsum("...i,i->...", r, -v), min=0.0) ** shininess
    col = _vec(albedo, normals) * (ambient + (1 - ambient) * lam[..., None])
    return col + specular * spec[..., None]


def screen_vertices(camera, vertices: torch.Tensor) -> torch.Tensor:
    """(V, 3) pixel x, y and depth: the camera pass's rasterizer input.
    Points behind the camera are pushed to depth −1, so they never draw."""
    uvz, valid = camera.project(vertices)
    return torch.where(valid[..., None], uvz, _vec([0.0, 0.0, -1.0], uvz))


def face_normals(vertices: torch.Tensor, faces: torch.Tensor,
                 vertex_normals=None) -> torch.Tensor:
    """(F, 3) unit mean of each face's vertex normals."""
    if vertex_normals is None:
        vertex_normals = update_normals(vertices, faces)
    idx = faces.long()
    n = vertex_normals[idx[:, 0]] + vertex_normals[idx[:, 1]] + vertex_normals[idx[:, 2]]
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def flat_face_colors(vertices: torch.Tensor, faces: torch.Tensor, light_dir,
                     vertex_normals=None) -> torch.Tensor:
    """(F, 3) Lambert colour of each face (flat shading: once per face)."""
    return shade_lambert(face_normals(vertices, faces, vertex_normals),
                         _vec(light_dir, vertices))


def render_mesh(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                height: int, vertex_normals=None, light_dir=LIGHT_DIR, chunk: int = 64,
                method: str = "auto", extra_vertex_attrs=None) -> dict:
    """Project, rasterize and flat-Lambert-shade a mesh through a Camera.
    Returns dict(color (H, W, 3), mask, depth, face, bary), and "extra"
    (H, W, C), the barycentric interpolation of `extra_vertex_attrs`, if
    given. On the planes path the face colours and the extra attributes
    ride the rasterizer's attribute planes; the other paths shade each
    pixel with its face's normal and interpolate with
    `interpolate_attribute`. `chunk` is the dense path's."""
    screen = screen_vertices(camera, vertices)
    if method in ("auto", "planes"):
        buf = _rasterize_dispatch(screen, faces, width, height, chunk, "planes",
                                  vertex_attrs=extra_vertex_attrs,
                                  face_attrs=flat_face_colors(vertices, faces, light_dir,
                                                              vertex_normals))
        ca = 0 if extra_vertex_attrs is None else extra_vertex_attrs.shape[-1]
        return _shade(buf, ca)
    buf = _rasterize_dispatch(screen, faces, width, height, chunk, method)
    face_n = face_normals(vertices, faces, vertex_normals)
    color = shade_lambert(face_n[torch.clamp(buf["face"], min=0).long()],
                          _vec(light_dir, vertices))
    mask = buf["face"] >= 0
    out = dict(color=torch.where(mask[..., None], color, 0.0), mask=mask, **buf)
    if extra_vertex_attrs is not None:
        out["extra"] = interpolate_attribute(buf, faces, extra_vertex_attrs)
    return out


def _shade(buf: dict, ca: int) -> dict:
    """A planes pass's buffers as render_mesh returns them: the face colour
    is the 3 attribute channels after the first `ca`, which become "extra"."""
    attrs = buf.pop("attrs")
    mask = buf["face"] >= 0
    out = dict(color=torch.where(mask[..., None], attrs[..., ca:ca + 3], 0.0), mask=mask,
               **buf)
    if ca:
        out["extra"] = attrs[..., :ca]
    return out


def interpolate_attribute(buf: dict, faces: torch.Tensor,
                          vertex_attr: torch.Tensor) -> torch.Tensor:
    """(H, W, K) barycentric interpolation of a per-vertex attribute
    (texcoords, colours, normals) over a rasterization buffer, 0 where
    empty."""
    fid = torch.clamp(buf["face"], min=0).long()
    attr = vertex_attr[faces.long()[fid]]  # (H, W, 3, K)
    out = torch.einsum("hwc,hwck->hwk", buf["bary"], attr)
    return torch.where(buf["face"][..., None] >= 0, out, 0.0)


def sample_texture(texture: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of texture (Th, Tw, C) at uv (..., 2) in [0, 1], v up.
    The texel indices are clamped into the texture, as JAX's gathers clamp
    (ROADMAP F3)."""
    th, tw = texture.shape[:2]
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (tw - 1)
    y = (1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)) * (th - 1)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(yi, xi):
        return texture[torch.clamp(yi, 0, th - 1).long(), torch.clamp(xi, 0, tw - 1).long()]

    return ((texel(y0, x0) * (1 - fx) + texel(y0, x1) * fx) * (1 - fy)
            + (texel(y1, x0) * (1 - fx) + texel(y1, x1) * fx) * fy)


def render_mesh_textured(camera, vertices: torch.Tensor, faces: torch.Tensor,
                         texcoords: torch.Tensor, texture: torch.Tensor, width: int,
                         height: int, light_dir=LIGHT_DIR, chunk: int = 64,
                         method: str = "auto") -> dict:
    """Textured, Lambert-lit render: render_mesh's Lambert term (its grey
    albedo 0.8 divided out) times the bilinear texture at each pixel's
    interpolated texcoords."""
    out = render_mesh(camera, vertices, faces, width, height, light_dir=light_dir,
                      chunk=chunk, method=method)
    albedo = sample_texture(texture, interpolate_attribute(out, faces, texcoords))
    shade = out["color"][..., :1] / 0.8
    out["color"] = torch.where(out["mask"][..., None], albedo * shade, 0.0)
    return out


def _light_basis(light_dir: torch.Tensor) -> torch.Tensor:
    """(3, 3) orthonormal rows whose +z looks along the light."""
    z = light_dir / torch.linalg.norm(light_dir)
    up = torch.where(torch.abs(z[1]) < 0.9, _vec([0.0, 1.0, 0.0], z), _vec([1.0, 0.0, 0.0], z))
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.linalg.norm(x)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z])


def light_projection(vertices: torch.Tensor, light_dir, resolution: int = 256):
    """`to_light`, mapping world points to (u, v, z) in the coordinates of
    an orthographic shadow map that spans the vertices seen from the light
    (z shifted so the vertices lie at z ≥ 1)."""
    basis = _light_basis(_vec(light_dir, vertices))
    local = vertices @ basis.T  # x, y across the beam; z along the light
    lo = local.amin(dim=0)
    hi = local.amax(dim=0)
    scale = (resolution - 1) / torch.clamp(hi[:2] - lo[:2], min=1e-6)
    z0 = lo[2] - 1.0  # only z > 0 is drawn

    def to_light(points):
        lp = points @ basis.T
        return torch.cat([(lp[..., :2] - lo[:2]) * scale, lp[..., 2:] - z0], dim=-1)

    return to_light


def render_shadow_map(vertices: torch.Tensor, faces: torch.Tensor, light_dir,
                      resolution: int = 256, chunk: int = 64, method: str = "auto"):
    """Orthographic depth map seen from the light (the reference
    rasterizer's shadow-map pass). Returns (depth (R, R), to_light)."""
    to_light = light_projection(vertices, light_dir, resolution)
    buf = _rasterize_dispatch(to_light(vertices), faces, resolution, resolution, chunk, method)
    return buf["depth"], to_light


def shadow_factor(shadow_depth: torch.Tensor, light_uvz: torch.Tensor,
                  bias: float = 5e-2) -> torch.Tensor:
    """1 where lit, 0 where occluded, by a nearest lookup in the shadow map."""
    res = shadow_depth.shape[0]
    u = torch.round(light_uvz[..., 0]).to(torch.int32).clamp(0, res - 1).long()
    v = torch.round(light_uvz[..., 1]).to(torch.int32).clamp(0, res - 1).long()
    occluder = shadow_depth[v, u]
    return torch.where(light_uvz[..., 2] <= occluder + bias, 1.0, 0.0)


def shadowed_passes(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                    height: int, light_dir=LIGHT_DIR, shadow_resolution: int = 256) -> dict:
    """The two planes passes of `render_mesh_shadowed`, each as
    (verts_screen, width, height, keyword arguments) of `rasterize_planes`
    with `faces`: "camera" (screen vertices; world positions as vertex
    attributes, flat Lambert colours as face attributes) and "shadow"
    (light-space vertices at shadow_resolution²); and "to_light", the map of
    world points into the shadow map."""
    to_light = light_projection(vertices, light_dir, shadow_resolution)
    return dict(camera=(screen_vertices(camera, vertices), width, height,
                        dict(vertex_attrs=vertices,
                             face_attrs=flat_face_colors(vertices, faces, light_dir))),
                shadow=(to_light(vertices), shadow_resolution, shadow_resolution, {}),
                to_light=to_light)


def render_mesh_shadowed(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                         height: int, light_dir=LIGHT_DIR, shadow_resolution: int = 256,
                         shadow_bias: float = 5e-2, chunk: int = 64,
                         method: str = "auto") -> dict:
    """Lambert render with a shadow map (rasterizer.h shadow maps): a depth
    pass from the light, then an occlusion test of each pixel's world
    position, interpolated by the camera pass. Adds "shadow" (H, W)."""
    out = render_mesh(camera, vertices, faces, width, height, light_dir=light_dir,
                      chunk=chunk, method=method, extra_vertex_attrs=vertices)
    sdepth, to_light = render_shadow_map(vertices, faces, light_dir, shadow_resolution,
                                         chunk, method)
    world = out.pop("extra")  # (H, W, 3)
    lit = torch.where(out["mask"], shadow_factor(sdepth, to_light(world), shadow_bias), 0.0)
    ambient = 0.15
    # the shadow scales the diffuse part; the ambient part stays
    color = out["color"] * (ambient + (1 - ambient) * lit[..., None])
    out["color"] = torch.where(out["mask"][..., None], color, 0.0)
    out["shadow"] = lit
    return out
