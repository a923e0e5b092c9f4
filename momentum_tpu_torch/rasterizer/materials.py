"""Phong materials, multi-light shading and supersampled rendering — the
port of momentum_tpu/rasterizer/materials.py.

Reference: momentum/rasterizer/rasterizer.h:49-110 (PhongMaterial with
diffuse, specular and emissive components and diffuse/emissive texture
maps; Light of type point, directional or ambient, the default a light at
the camera) and rasterizeMesh (rasterizer.h:195-214: per-vertex colours,
back-face culling, depth and image offsets, the surface-normal buffer).
`render_mesh_phong(..., supersample=k)` renders at k× and box-filters down,
the anti-aliasing the reference recommends.

Shading is (H, W)-wide elementwise math over the rasterization buffers:
every light evaluated at every pixel and summed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.rasterizer.render import (
    _rasterize_dispatch, interpolate_attribute, sample_texture, screen_vertices)

__all__ = ["PhongMaterial", "Light", "point_light", "directional_light", "ambient_light",
           "default_lights", "shade_phong_lights", "render_mesh_phong", "downsample"]


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class PhongMaterial:
    """rasterizer.h:49-86 PhongMaterial: colours (3,), the specular
    exponent (), optional texture maps (Th, Tw, 3) (None: flat colours)."""

    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    specular_exponent: torch.Tensor
    emissive_color: torch.Tensor
    diffuse_texture: Optional[torch.Tensor] = None
    emissive_texture: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, diffuse_color=(1.0, 1.0, 1.0), specular_color=(0.0, 0.0, 0.0),
               specular_exponent=10.0, emissive_color=(0.0, 0.0, 0.0), diffuse_texture=None,
               emissive_texture=None, device="cuda") -> "PhongMaterial":
        device = resolve(device, "PhongMaterial.create")
        return cls(diffuse_color=_f32(diffuse_color, device),
                   specular_color=_f32(specular_color, device),
                   specular_exponent=_f32(specular_exponent, device),
                   emissive_color=_f32(emissive_color, device),
                   diffuse_texture=None if diffuse_texture is None
                   else _f32(diffuse_texture, device),
                   emissive_texture=None if emissive_texture is None
                   else _f32(emissive_texture, device))


@dataclasses.dataclass(frozen=True, eq=False)
class Light:
    """rasterizer.h:92-110 Light. type: 0 point, 1 directional, 2 ambient;
    position holds the world position (point) or direction (directional)."""

    position: torch.Tensor
    color: torch.Tensor
    type: int = 0


def point_light(position, color=(1.0, 1.0, 1.0), device="cuda") -> Light:
    device = resolve(device, "point_light")
    return Light(_f32(position, device), _f32(color, device), 0)


def directional_light(direction, color=(1.0, 1.0, 1.0), device="cuda") -> Light:
    device = resolve(device, "directional_light")
    return Light(_f32(direction, device), _f32(color, device), 1)


def ambient_light(color=(0.2, 0.2, 0.2), device="cuda") -> Light:
    device = resolve(device, "ambient_light")
    return Light(torch.zeros(3, device=device), _f32(color, device), 2)


def default_lights(camera_position, device=None) -> tuple:
    """The reference's default: a light at the camera plus a small ambient
    term (rasterizer.h:182-183). On camera_position's device when it is a
    tensor and no device is given, else on `device` (the card by default)."""
    if device is None:
        device = (camera_position.device if isinstance(camera_position, torch.Tensor)
                  else "cuda")
    return (point_light(camera_position, (0.85, 0.85, 0.85), device=device),
            ambient_light((0.15, 0.15, 0.15), device=device))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def shade_phong_lights(position: torch.Tensor, normal: torch.Tensor, view_pos: torch.Tensor,
                       material: PhongMaterial, lights, diffuse_albedo=None,
                       emissive=None) -> torch.Tensor:
    """Phong shading of (..., 3) surface points under a sequence of Lights;
    diffuse_albedo / emissive replace the material's flat colours per point
    (the texture and per-vertex-colour paths)."""
    kd = material.diffuse_color if diffuse_albedo is None else diffuse_albedo
    ke = material.emissive_color if emissive is None else emissive
    v = _unit(view_pos - position)
    color = torch.broadcast_to(ke, position.shape).to(position.dtype)
    for light in lights:
        if light.type == 2:
            color = color + kd * light.color
            continue
        if light.type == 0:
            l = _unit(light.position - position)
        else:
            l = torch.broadcast_to(-(light.position / torch.linalg.norm(light.position)),
                                   position.shape)
        ndl = torch.sum(normal * l, dim=-1, keepdim=True)
        # classic Phong: the light reflected about the normal, against the view
        r = 2.0 * ndl * normal - l
        spec = torch.clamp(torch.sum(r * v, dim=-1, keepdim=True), min=0.0) \
            ** material.specular_exponent
        color = color + light.color * (kd * torch.clamp(ndl, min=0.0)
                                       + material.specular_color * spec)
    return color


def downsample(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Box-filter downsample of (H·k, W·k[, C]) by k, the supersampling
    resolve."""
    if factor == 1:
        return image
    h, w = image.shape[:2]
    hh, ww = h // factor, w // factor
    return image[:hh * factor, :ww * factor].reshape(
        hh, factor, ww, factor, *image.shape[2:]).mean(dim=(1, 3))


def _phong_screen(camera, vertices: torch.Tensor, faces: torch.Tensor, supersample: int = 1,
                  backface_culling: bool = True, depth_offset: float = 0.0,
                  image_offset=(0.0, 0.0)):
    """(screen vertices at the supersampled size, faces): render_mesh_phong's
    rasterizer input. Back faces (screen-space signed area ≤ 0) are culled
    by rewriting them to the degenerate face (0, 0, 0), as the JAX package
    does: the rasterizers kill them, the planes path still bins them."""
    k = int(supersample)
    dev = camera.eye_from_world.device
    screen = screen_vertices(camera, vertices)
    screen = torch.cat([screen[..., :2] * k, screen[..., 2:]], dim=-1)
    screen = screen + _f32([image_offset[0] * k, image_offset[1] * k, depth_offset], dev)
    if not backface_culling:
        return screen, faces
    tri = screen[faces.long()]
    area = ((tri[:, 1, 0] - tri[:, 0, 0]) * (tri[:, 2, 1] - tri[:, 0, 1])
            - (tri[:, 1, 1] - tri[:, 0, 1]) * (tri[:, 2, 0] - tri[:, 0, 0]))
    return screen, torch.where((area > 0)[:, None], faces, 0)


def render_mesh_phong(camera, vertices: torch.Tensor, faces: torch.Tensor, width: int,
                      height: int, material: PhongMaterial | None = None, lights=None,
                      vertex_normals=None, vertex_colors=None, texcoords=None,
                      supersample: int = 1, backface_culling: bool = True,
                      depth_offset: float = 0.0, image_offset=(0.0, 0.0), chunk: int = 64,
                      method: str = "auto") -> dict:
    """The reference rasterizer's material path (rasterizeMesh,
    rasterizer.h:195-214): per-pixel smooth normals, Phong lighting under
    point, directional and ambient lights, per-vertex diffuse colours,
    diffuse and emissive textures, back-face culling, depth and image
    offsets, and k× supersampled anti-aliasing.

    Back faces are culled as `_phong_screen` says. Returns
    dict(color, mask, alpha, depth, face, bary, normal) at (height, width):
    with supersample k > 1 the colour, alpha, depth (nearest-ish: −box(−z),
    so +inf wherever a subsample is empty) and normal are box-filtered and
    the face and bary buffers centre-sampled. The material and lights
    default to the camera's device."""
    from momentum_tpu_torch.character.skinning import update_normals

    dev = camera.eye_from_world.device
    if material is None:
        material = PhongMaterial.create(device=dev)
    cam_pos = ss.split(ss.inverse(camera.eye_from_world))[0]
    if lights is None:
        lights = default_lights(cam_pos)

    k = int(supersample)
    screen, faces_r = _phong_screen(camera, vertices, faces, k, backface_culling,
                                    depth_offset, image_offset)
    buf = _rasterize_dispatch(screen, faces_r, width * k, height * k, chunk, method)

    if vertex_normals is None:
        vertex_normals = update_normals(vertices, faces)
    n_pix = _unit(interpolate_attribute(buf, faces_r, vertex_normals))
    p_pix = interpolate_attribute(buf, faces_r, vertices)

    albedo = emissive = None
    if texcoords is not None and material.diffuse_texture is not None:
        albedo = sample_texture(material.diffuse_texture,
                                interpolate_attribute(buf, faces_r, texcoords))
    if texcoords is not None and material.emissive_texture is not None:
        emissive = sample_texture(material.emissive_texture,
                                  interpolate_attribute(buf, faces_r, texcoords))
    if vertex_colors is not None:
        vc = interpolate_attribute(buf, faces_r, vertex_colors)
        albedo = vc if albedo is None else albedo * vc

    color = shade_phong_lights(p_pix, n_pix, cam_pos, material, lights,
                               diffuse_albedo=albedo, emissive=emissive)
    mask = buf["face"] >= 0
    color = torch.where(mask[..., None], color, 0.0)
    if k > 1:
        alpha = downsample(mask.to(color.dtype), k)
        c = k // 2
        return dict(color=downsample(color, k), mask=alpha > 0.5, alpha=alpha,
                    depth=-downsample(-buf["depth"], k),
                    face=buf["face"][c::k, c::k][:height, :width],
                    bary=buf["bary"][c::k, c::k][:height, :width],
                    normal=downsample(n_pix, k))
    return dict(color=color, mask=mask, alpha=mask.to(color.dtype), normal=n_pix, **buf)
