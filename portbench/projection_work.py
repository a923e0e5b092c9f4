"""The least work of one launch of K6's projection form
(projection_jacobian_kernel): the bytes it must move and the float32
operations it must do for B frames of K cameras seeing C points on a rig of
nJ joints and P parameters.

  bytes   J written once, 4·B·2KC·P; each frame's inputs read once, its
          joints' axes and positions (21 floats a joint), its points (3 a
          point) and its row scales (K·C); the launch's tables once, the
          ancestor mask (nJ²), the parameter transform (7nJ·P) and the
          cameras (24 floats each).
  flops   the chain of every (camera, point) pair, s·dπ/dp_eye·R (CHAIN_FLOPS:
          the eye-space point, the OpenCV model's derivative at it, the
          product with R), and 5 for each entry of J (the 2 × 3 factor times
          the point's 3-row Jacobian column: 3 products, 2 sums).
"""

from __future__ import annotations

CHAIN_FLOPS = 129  # counted from camera/models.py's derivative and the kernel's product


def projection_jacobian_work(batch: int, cameras: int, points: int, joints: int,
                             params: int) -> tuple:
    """(bytes, flops) of one launch."""
    rows = 2 * cameras * points
    nbytes = 4 * (batch * (rows * params + 21 * joints + 3 * points + cameras * points)
                  + joints * joints + 7 * joints * params + 24 * cameras)
    flops = batch * (cameras * points * CHAIN_FLOPS + 5 * rows * params)
    return nbytes, flops
