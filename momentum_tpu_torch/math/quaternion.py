"""Batched quaternion algebra on tensors.

Quaternions are tensors whose last dimension has size 4, ordered
``(x, y, z, w)`` with identity ``(0, 0, 0, 1)`` — the layout of
momentum_tpu/math/quaternion.py. Every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import torch

__all__ = ["identity", "multiply", "rotate_vector", "euler_to_quaternion",
           "to_rotation_matrix"]


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) of shape ``(*shape, 4)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ∘ q2 (q2 applied first when rotating vectors)."""
    v1, w1 = q1[..., :3], q1[..., 3:]
    v2, w2 = q2[..., :3], q2[..., 3:]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + _cross(v1, v2)
    return torch.cat([v, w], dim=-1)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q:
    v + 2·qw·(qv × v) + 2·qv × (qv × v)."""
    qv, qw = q[..., :3], q[..., 3:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def _axis_quat(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """Quaternion for a rotation of `angle` about coordinate axis `axis`."""
    half = 0.5 * angle
    z = torch.zeros_like(angle)
    comps = [z, z, z]
    comps[axis] = torch.sin(half)
    return torch.stack(comps + [torch.cos(half)], dim=-1)


def euler_to_quaternion(angles: torch.Tensor, order: str = "ZYX") -> torch.Tensor:
    """Quaternion of R = Rz(a_z)·Ry(a_y)·Rx(a_x); `angles[..., i]` is the
    angle about axis i. Only the joint-rotation order "ZYX"
    (joint_state.cpp:50-58) is ported."""
    if order != "ZYX":
        raise NotImplementedError(f"euler order {order!r}: only 'ZYX' is ported")
    q = _axis_quat(angles[..., 2], 2)
    q = multiply(q, _axis_quat(angles[..., 1], 1))
    return multiply(q, _axis_quat(angles[..., 0], 0))


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix from unit quaternion(s)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))
