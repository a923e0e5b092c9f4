"""axel, the spatial library (signed distance fields, mesh queries,
continuous collision detection, hole filling, SDF files), after
momentum_tpu/axel/ with its export list."""

from momentum_tpu_torch.axel.queries import (  # noqa: F401
    closest_point_on_mesh, knn, ray_mesh_intersect)
from momentum_tpu_torch.axel.sdf import (  # noqa: F401
    SignedDistanceField, mesh_to_sdf, morphological_cleanup, sdf_to_mesh, winding_number)
from momentum_tpu_torch.axel.grid import (  # noqa: F401
    TriangleGrid, build_triangle_grid, closest_point_on_mesh_grid, ray_mesh_intersect_grid)
from momentum_tpu_torch.axel.ccd import (  # noqa: F401
    ccd_edge_edge, ccd_vertex_triangle, distance_edge_edge, times_coplanar)
from momentum_tpu_torch.axel.hole_filling import (  # noqa: F401
    HoleBoundary, detect_mesh_holes, fill_hole, fill_mesh_holes, smooth_mesh_laplacian)
from momentum_tpu_torch.axel.hole_filling import fill_mesh_holes as fill_holes  # noqa: F401
from momentum_tpu_torch.axel.sdf import dual_contouring, triangulate_quads  # noqa: F401
from momentum_tpu_torch.axel.sdf_io import (  # noqa: F401
    load_sdf_from_msgpack, load_sdfs_from_msgpack, save_sdf_to_msgpack, save_sdfs_to_msgpack)
