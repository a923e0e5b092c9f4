"""Batched similarity-transform ("skeleton state") algebra on tensors.

A skeleton state packs a uniform-scale rigid transform into 8 floats
``(tx, ty, tz, rx, ry, rz, rw, s)``, the layout of
momentum_tpu/math/skel_state.py. Composition (math/transform.h:119-129):

    (A * B).t = A.t + A.R · (A.s · B.t)
    (A * B).R = A.R · B.R
    (A * B).s = A.s · B.s
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.math import quaternion as quat

__all__ = ["identity", "split", "join", "multiply", "transform_points"]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    s = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    s[..., 6] = 1.0
    s[..., 7] = 1.0
    return s


def split(s: torch.Tensor):
    """-> (t (..., 3), q (..., 4), scale (..., 1))."""
    if s.shape[-1] != 8:
        raise ValueError(f"expected last dim 8 for skel_state, got {tuple(s.shape)}")
    return s[..., 0:3], s[..., 3:7], s[..., 7:8]


def join(t: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if s.ndim == t.ndim - 1:
        s = s[..., None]
    batch = torch.broadcast_shapes(t.shape[:-1], q.shape[:-1], s.shape[:-1])
    return torch.cat([t.expand(batch + (3,)), q.expand(batch + (4,)),
                      s.expand(batch + (1,))], dim=-1)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: apply b first, then a (matrix convention A·B)."""
    ta, qa, sa = split(a)
    tb, qb, sb = split(b)
    t = ta + quat.rotate_vector(qa, sa * tb)
    return join(t, quat.multiply(qa, qb), sa * sb)


def transform_points(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply transform(s) to point(s): t + R·(s·p)."""
    t, q, s = split(a)
    return t + quat.rotate_vector(q, s * p)
