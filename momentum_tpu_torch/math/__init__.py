"""Quaternion, skeleton-state, robust-loss and small linear-algebra math."""
from momentum_tpu_torch.math import euler, generalized_loss, quaternion, skel_state  # noqa: F401
from momentum_tpu_torch.math import support_polygon  # noqa: F401
from momentum_tpu_torch.math.support_polygon import (  # noqa: F401
    SupportPlane,
    convex_hull_2d,
    cross2d,
    support_polygon_from_world_points,
)
