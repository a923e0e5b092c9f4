"""Mesh rendering: project, rasterize with planes (kernels K4a/K4b), Lambert
shading and shadow maps — the planes path of
momentum_tpu/rasterizer/render.py.

Shading is flat (one normal per face), so the Lambert colour is computed
once per face and rides the rasterizer's constant-attribute planes; the
shadowed render also interpolates world positions through its vertex-
attribute planes, and looks them up in an orthographic depth map rendered
from the light. Outputs: colour (H, W, 3), mask, depth, face, bary (and
shadow). The face selection is not differentiable; the raster kernels
refuse inputs that require grad.
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.character.skinning import update_normals
from momentum_tpu_torch.ops.raster import rasterize_planes

__all__ = ["shade_lambert", "render_mesh", "render_shadow_map", "shadow_factor",
           "render_mesh_shadowed"]


def _rasterize_dispatch(verts_screen, faces, width: int, height: int,
                        method: str = "auto", vertex_attrs=None, face_attrs=None):
    """"auto" and "planes" take `rasterize_planes` (kernels K4a/K4b on the
    card, the plain version on the CPU)."""
    if method not in ("auto", "planes"):
        raise NotImplementedError(
            f"rasterizer method {method!r}: only the planes path is ported; the dense "
            "and windowed rasterizers come with ROADMAP M8")
    return rasterize_planes(verts_screen, faces, width, height,
                            vertex_attrs=vertex_attrs, face_attrs=face_attrs)


def shade_lambert(normals: torch.Tensor, light_dir: torch.Tensor,
                  albedo=(0.8, 0.8, 0.8), ambient: float = 0.15) -> torch.Tensor:
    l = light_dir / torch.linalg.norm(light_dir)
    lam = torch.clamp(torch.einsum("...i,i->...", normals, -l), min=0.0)
    alb = torch.as_tensor(albedo, dtype=normals.dtype, device=normals.device)
    return alb * (ambient + (1 - ambient) * lam[..., None])


def screen_vertices(camera, vertices: torch.Tensor) -> torch.Tensor:
    """(V, 3) pixel x, y and depth: the camera pass's rasterizer input.
    Points behind the camera are pushed to depth −1, so they never draw."""
    uvz, valid = camera.project(vertices)
    behind = torch.as_tensor([0.0, 0.0, -1.0], dtype=uvz.dtype, device=uvz.device)
    return torch.where(valid[..., None], uvz, behind)


def flat_face_colors(vertices: torch.Tensor, faces: torch.Tensor, light_dir,
                     vertex_normals=None) -> torch.Tensor:
    """(F, 3) Lambert colour of each face from the mean of its vertex
    normals (flat shading: once per face, not per pixel)."""
    if vertex_normals is None:
        vertex_normals = update_normals(vertices, faces)
    idx = faces.long()
    face_n = vertex_normals[idx[:, 0]] + vertex_normals[idx[:, 1]] + vertex_normals[idx[:, 2]]
    face_n = face_n / torch.clamp(torch.linalg.norm(face_n, dim=-1, keepdim=True), min=1e-12)
    return shade_lambert(face_n, torch.as_tensor(light_dir, dtype=vertices.dtype,
                                                 device=vertices.device))


def render_mesh(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                height: int, vertex_normals=None, light_dir=(0.3, -0.7, 0.6),
                method: str = "auto", extra_vertex_attrs=None) -> dict:
    """Project, rasterize and flat-Lambert-shade a mesh through a Camera.
    Returns dict(color (H, W, 3), mask, depth, face, bary), and "extra"
    (H, W, C), the barycentric interpolation of `extra_vertex_attrs`, if
    given. The face colours ride the rasterizer's constant-attribute
    planes."""
    buf = _rasterize_dispatch(screen_vertices(camera, vertices), faces, width, height,
                              method, vertex_attrs=extra_vertex_attrs,
                              face_attrs=flat_face_colors(vertices, faces, light_dir,
                                                          vertex_normals))
    attrs = buf.pop("attrs")
    ca = 0 if extra_vertex_attrs is None else extra_vertex_attrs.shape[-1]
    mask = buf["face"] >= 0
    out = dict(color=torch.where(mask[..., None], attrs[..., ca:ca + 3], 0.0), mask=mask,
               **buf)
    if ca:
        out["extra"] = attrs[..., :ca]
    return out


def _light_basis(light_dir: torch.Tensor) -> torch.Tensor:
    """(3, 3) orthonormal rows whose +z looks along the light."""
    z = light_dir / torch.linalg.norm(light_dir)
    e_y = torch.as_tensor([0.0, 1.0, 0.0], dtype=z.dtype, device=z.device)
    e_x = torch.as_tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device)
    up = torch.where(torch.abs(z[1]) < 0.9, e_y, e_x)
    x = torch.linalg.cross(up, z, dim=-1)
    x = x / torch.linalg.norm(x)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z])


def light_projection(vertices: torch.Tensor, light_dir, resolution: int = 256):
    """`to_light`, mapping world points to (u, v, z) in the coordinates of
    an orthographic shadow map that spans the vertices seen from the light
    (z shifted so the vertices lie at z ≥ 1)."""
    basis = _light_basis(torch.as_tensor(light_dir, dtype=vertices.dtype,
                                         device=vertices.device))
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
                      resolution: int = 256, method: str = "auto"):
    """Orthographic depth map seen from the light (the reference
    rasterizer's shadow-map pass). Returns (depth (R, R), to_light)."""
    to_light = light_projection(vertices, light_dir, resolution)
    buf = _rasterize_dispatch(to_light(vertices), faces, resolution, resolution, method)
    return buf["depth"], to_light


def shadow_factor(shadow_depth: torch.Tensor, light_uvz: torch.Tensor,
                  bias: float = 5e-2) -> torch.Tensor:
    """1 where lit, 0 where occluded, by a nearest lookup in the shadow map."""
    res = shadow_depth.shape[0]
    u = torch.round(light_uvz[..., 0]).to(torch.int32).clamp(0, res - 1).long()
    v = torch.round(light_uvz[..., 1]).to(torch.int32).clamp(0, res - 1).long()
    occluder = shadow_depth[v, u]
    return torch.where(light_uvz[..., 2] <= occluder + bias, 1.0, 0.0)


def render_mesh_shadowed(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                         height: int, light_dir=(0.3, -0.7, 0.6),
                         shadow_resolution: int = 256, shadow_bias: float = 5e-2,
                         method: str = "auto") -> dict:
    """Lambert render with a shadow map (rasterizer.h shadow maps): a depth
    pass from the light, then an occlusion test of each pixel's world
    position, interpolated by the camera pass. Adds "shadow" (H, W)."""
    out = render_mesh(camera, vertices, faces, width, height, light_dir=light_dir,
                      method=method, extra_vertex_attrs=vertices)
    sdepth, to_light = render_shadow_map(vertices, faces, light_dir, shadow_resolution,
                                         method=method)
    world = out.pop("extra")  # (H, W, 3)
    lit = torch.where(out["mask"], shadow_factor(sdepth, to_light(world), shadow_bias), 0.0)
    ambient = 0.15
    # the shadow scales the diffuse part; the ambient part stays
    color = out["color"] * (ambient + (1 - ambient) * lit[..., None])
    out["color"] = torch.where(out["mask"][..., None], color, 0.0)
    out["shadow"] = lit
    return out
