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

__all__ = ["identity", "split", "join", "from_translation", "multiply", "inverse",
           "transform_points", "rotate_vectors", "to_matrix", "blend"]


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


def from_translation(t: torch.Tensor) -> torch.Tensor:
    q = quat.identity(t.shape[:-1], dtype=t.dtype, device=t.device)
    return join(t, q, torch.ones(t.shape[:-1] + (1,), dtype=t.dtype, device=t.device))


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


def inverse(a: torch.Tensor) -> torch.Tensor:
    t, q, s = split(a)
    qi = quat.conjugate(q)
    si = 1.0 / s
    return join(-quat.rotate_vector(qi, si * t), qi, si)


def rotate_vectors(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotation only (directions): R·v."""
    return quat.rotate_vector(a[..., 3:7], v)


def to_matrix(a: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix [s·R | t]."""
    t, q, s = split(a)
    top = torch.cat([quat.to_rotation_matrix(q) * s[..., None], t[..., None]], dim=-1)
    bottom = torch.zeros(a.shape[:-1] + (1, 4), dtype=a.dtype, device=a.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def blend(states: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted blend over the second-to-last axis: t and s averaged linearly,
    q by `quaternion.blend`."""
    if weights is None:
        weights = torch.ones(states.shape[:-1], dtype=states.dtype, device=states.device)
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-12)
    t, q, s = split(states)
    return join((t * w[..., None]).sum(dim=-2), quat.blend(q, w),
                (s * w[..., None]).sum(dim=-2))
