"""Depth-tested 3-D overlays: lines, circles, splats — the port of
momentum_tpu/rasterizer/overlays.py.

Reference: momentum/rasterizer/rasterizer.h:229 rasterizeLines, :278
rasterizeCircles, :475 rasterizeSplats, the scene annotations (bones,
marker dots, point-cloud surfaces) drawn into the mesh's z-buffer so that
they occlude and are occluded.

Each primitive family is evaluated densely over the pixel grid, a
(chunk, H, W) coverage and depth block reduced by least depth, in place of
the reference's per-scanline loops. Pass the z and rgb buffers of an
earlier pass (render_mesh_phong's depth and color) to composite; omitted
buffers start empty (depth +inf, colour black). Everything runs on the
camera's device.
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.math import skel_state as ss

__all__ = ["rasterize_lines", "rasterize_circles", "rasterize_splats"]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _grid(width: int, height: int, image_offset, device):
    """(px, py) (H, W): pixel centres shifted by −image_offset."""
    dx, dy = image_offset
    px = torch.arange(width, dtype=torch.float32, device=device) + 0.5 - dx
    py = torch.arange(height, dtype=torch.float32, device=device) + 0.5 - dy
    py, px = torch.meshgrid(py, px, indexing="ij")
    return px, py


def _buffers(z_buffer, rgb_buffer, width: int, height: int, device):
    z = (torch.full((height, width), torch.inf, device=device) if z_buffer is None
         else _f32(z_buffer, device))
    rgb = (torch.zeros((height, width, 3), device=device) if rgb_buffer is None
           else _f32(rgb_buffer, device))
    return z, rgb


def _composite_min_depth(z, rgb, depths, colors):
    """depths (N, H, W), +inf outside coverage; colors (N, 3) or (N, H, W, 3).
    The nearest primitive wins, then z-tests against the buffer."""
    best = torch.argmin(depths, dim=0, keepdim=True)  # (1, H, W), the first least
    dmin = torch.gather(depths, 0, best)[0]
    if colors.ndim == 2:
        cmin = colors[best[0]]
    else:
        cmin = torch.gather(colors, 0, best[..., None].expand(1, *colors.shape[1:]))[0]
    hit = (dmin < z) & torch.isfinite(dmin)
    return torch.where(hit, dmin, z), torch.where(hit[..., None], cmin, rgb)


def rasterize_lines(camera, positions_world, width: int, height: int,
                    color=(1.0, 1.0, 1.0), thickness: float = 1.0, z_buffer=None,
                    rgb_buffer=None, near_clip: float = 1e-3, depth_offset: float = 0.0,
                    image_offset=(0.0, 0.0), chunk: int = 64):
    """Depth-tested 3-D segments (rasterizeLines, rasterizer.h:229):
    consecutive position pairs form segments, projected and drawn
    `thickness` pixels wide, the depth interpolated along the segment.
    → (z_buffer, rgb_buffer)."""
    dev = camera.eye_from_world.device
    p = _f32(positions_world, dev).reshape(-1, 2, 3)
    uvz = camera.project(p.reshape(-1, 3))[0].reshape(-1, 2, 3)
    z, rgb = _buffers(z_buffer, rgb_buffer, width, height, dev)
    px, py = _grid(width, height, image_offset, dev)
    color = _f32(color, dev)
    half = 0.5 * max(thickness, 1.0)

    for s0 in range(0, uvz.shape[0], chunk):
        seg = uvz[s0:s0 + chunk]  # (C, 2, 3)
        a, b = seg[:, 0], seg[:, 1]
        ok = (a[:, 2] > near_clip) & (b[:, 2] > near_clip)
        d = b[:, :2] - a[:, :2]
        len2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
        ax, ay = a[:, 0, None, None], a[:, 1, None, None]
        dx, dy = d[:, 0, None, None], d[:, 1, None, None]
        # each pixel's closest parameter t on each segment
        t = ((px[None] - ax) * dx + (py[None] - ay) * dy) / len2[:, None, None]
        t = torch.clamp(t, 0.0, 1.0)
        dist2 = (px[None] - (ax + t * dx)) ** 2 + (py[None] - (ay + t * dy)) ** 2
        depth = a[:, 2, None, None] + t * (b[:, 2] - a[:, 2])[:, None, None] + depth_offset
        cover = (dist2 <= half * half) & ok[:, None, None] & (depth > 0)
        z, rgb = _composite_min_depth(z, rgb, torch.where(cover, depth, torch.inf),
                                      color.expand(seg.shape[0], 3))
    return z, rgb


def rasterize_circles(camera, positions_world, width: int, height: int, radius: float = 1.0,
                      line_color=None, fill_color=None, line_thickness: float = 1.0,
                      z_buffer=None, rgb_buffer=None, near_clip: float = 1e-3,
                      depth_offset: float = 0.0, image_offset=(0.0, 0.0), chunk: int = 256):
    """Depth-tested 3-D circles (rasterizeCircles, rasterizer.h:278): the
    centres projected, the world `radius` foreshortened by depth
    (r_px = r·f/z); an outline and/or a fill, each optional.
    → (z_buffer, rgb_buffer)."""
    if line_color is None and fill_color is None:
        raise ValueError("need line_color and/or fill_color")
    dev = camera.eye_from_world.device
    uvz = camera.project(_f32(positions_world, dev).reshape(-1, 3))[0]
    z, rgb = _buffers(z_buffer, rgb_buffer, width, height, dev)
    px, py = _grid(width, height, image_offset, dev)
    f = 0.5 * (float(camera.intrinsics.fx) + float(camera.intrinsics.fy))
    half = 0.5 * max(line_thickness, 1.0)

    for s0 in range(0, uvz.shape[0], chunk):
        cc = uvz[s0:s0 + chunk]  # (C, 3)
        ok = cc[:, 2] > near_clip
        r_px = radius * f / torch.clamp(cc[:, 2], min=near_clip)
        dist = torch.sqrt((px[None] - cc[:, 0, None, None]) ** 2
                          + (py[None] - cc[:, 1, None, None]) ** 2)
        depth = cc[:, 2, None, None] + depth_offset
        base = ok[:, None, None] & (depth > 0)
        if fill_color is not None:
            cover = base & (dist <= r_px[:, None, None])
            z, rgb = _composite_min_depth(z, rgb, torch.where(cover, depth, torch.inf),
                                          _f32(fill_color, dev).expand(cc.shape[0], 3))
        if line_color is not None:
            ring = base & (torch.abs(dist - r_px[:, None, None]) <= half)
            # the outline wins ties against its own fill
            z, rgb = _composite_min_depth(z, rgb, torch.where(ring, depth - 1e-5, torch.inf),
                                          _f32(line_color, dev).expand(cc.shape[0], 3))
    return z, rgb


def rasterize_splats(camera, positions_world, normals_world, width: int, height: int,
                     radius: float = 1.0, front_material=None, back_material=None,
                     lights=None, z_buffer=None, rgb_buffer=None, near_clip: float = 1e-3,
                     depth_offset: float = 0.0, image_offset=(0.0, 0.0), chunk: int = 128):
    """Oriented-disk splats (rasterizeSplats, rasterizer.h:475): each point
    a world-space disk of `radius` facing its normal. Each pixel's view ray
    meets the disk's plane and the hit is tested against the radius, so the
    splats tilt and foreshorten. Front- and back-facing disks shade with
    their own Phong materials (the back normal flipped), lit in eye space,
    once per splat (the normal is constant over a disk).
    → (z_buffer, rgb_buffer)."""
    from momentum_tpu_torch.rasterizer.materials import (
        PhongMaterial, default_lights, shade_phong_lights)

    dev = camera.eye_from_world.device
    if front_material is None:
        front_material = PhongMaterial.create(diffuse_color=(0.8, 0.8, 0.8), device=dev)
    if back_material is None:
        back_material = PhongMaterial.create(diffuse_color=(0.4, 0.4, 0.4), device=dev)
    origin = torch.zeros(3, device=dev)  # eye space: the camera at the origin
    if lights is None:
        lights = default_lights(origin)

    p = _f32(positions_world, dev).reshape(-1, 3)
    n = _f32(normals_world, dev).reshape(-1, 3)
    c_eye = camera.world_to_eye(p)  # (S, 3)
    n_eye = ss.rotate_vectors(camera.eye_from_world, n)
    n_eye = n_eye / torch.clamp(torch.linalg.norm(n_eye, dim=-1, keepdim=True), min=1e-12)

    z, rgb = _buffers(z_buffer, rgb_buffer, width, height, dev)
    px, py = _grid(width, height, image_offset, dev)
    # each pixel's eye-space view ray through z = 1
    ray = camera.intrinsics.unproject(torch.stack([px, py, torch.ones_like(px)], dim=-1))

    for s0 in range(0, p.shape[0], chunk):
        ce, ne = c_eye[s0:s0 + chunk], n_eye[s0:s0 + chunk]  # (S, 3)
        ok = ce[:, 2] > near_clip
        nc = torch.sum(ne * ce, dim=-1)  # (S,)
        facing = nc < 0  # the normal toward the camera: front
        n_shade = torch.where(facing[:, None], ne, -ne)
        colors = torch.where(facing[:, None],
                             shade_phong_lights(ce, n_shade, origin, front_material, lights),
                             shade_phong_lights(ce, n_shade, origin, back_material, lights))
        # the ray meets the disk's plane at t = n·c / n·d
        nd = torch.einsum("hwi,si->shw", ray, ne)
        t = nc[:, None, None] / torch.where(torch.abs(nd) > 1e-9, nd, 1e-9)
        hit = ray[None] * t[..., None]  # (S, H, W, 3)
        inside = torch.sum((hit - ce[:, None, None]) ** 2, dim=-1) <= radius * radius
        depth = hit[..., 2] + depth_offset
        cover = inside & ok[:, None, None] & (depth > near_clip) & (t > 0)
        z, rgb = _composite_min_depth(z, rgb, torch.where(cover, depth, torch.inf), colors)
    return z, rgb
