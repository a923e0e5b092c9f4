"""Software rasterizer: the planes path (kernels K4a/K4b), Lambert shading,
shadow maps and auto-framed cameras."""

from momentum_tpu_torch.rasterizer.render import (  # noqa: F401
    render_mesh, render_mesh_shadowed, render_shadow_map, shade_lambert, shadow_factor)
from momentum_tpu_torch.rasterizer.utils import create_camera_for_body  # noqa: F401
