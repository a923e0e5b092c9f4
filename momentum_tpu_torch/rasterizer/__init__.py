"""Software rasterizer: the planes (kernels K4a/K4b), dense and windowed
z-buffers, Lambert, Phong and textured shading, shadow maps, primitives,
overlays, text, buffers and auto-framed cameras — the port of
momentum_tpu/rasterizer."""

from momentum_tpu_torch.rasterizer.render import (  # noqa: F401
    interpolate_attribute, rasterize, rasterize_windowed, render_mesh,
    render_mesh_shadowed, render_mesh_textured, render_shadow_map, sample_texture,
    shade_lambert, shade_phong, shadow_factor)
from momentum_tpu_torch.rasterizer.materials import (  # noqa: F401
    Light, PhongMaterial, ambient_light, default_lights, directional_light, downsample,
    point_light, render_mesh_phong, shade_phong_lights)
from momentum_tpu_torch.rasterizer import primitives  # noqa: F401
from momentum_tpu_torch.rasterizer.primitives import (  # noqa: F401
    make_camera_frustum, make_capsule, make_checkerboard, make_cylinder, make_grid_lines,
    make_sphere, rasterize_capsules, rasterize_character, rasterize_circles_2d,
    rasterize_cylinders, rasterize_lines_2d, rasterize_skeleton, rasterize_spheres,
    rasterize_wireframe, subdivide_mesh)
from momentum_tpu_torch.rasterizer.text import (  # noqa: F401
    measure_text, rasterize_text, rasterize_text_2d)
from momentum_tpu_torch.rasterizer.overlays import (  # noqa: F401
    rasterize_circles, rasterize_lines, rasterize_splats)
from momentum_tpu_torch.rasterizer.utils import (  # noqa: F401
    alpha_matte, create_camera_for_body, create_camera_for_hand, create_index_buffer,
    create_rgb_buffer, create_shadow_projection_matrix, create_z_buffer,
    rasterize_camera_frustum, rasterize_checkerboard, rasterize_grid, rasterize_mesh,
    rasterize_transforms, triangulate)
