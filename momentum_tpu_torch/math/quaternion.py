"""Batched quaternion algebra on tensors.

Quaternions are tensors whose last dimension has size 4, ordered
``(x, y, z, w)`` with identity ``(0, 0, 0, 1)`` — the layout of
momentum_tpu/math/quaternion.py. Every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import torch

__all__ = ["identity", "check", "split", "multiply", "conjugate", "inverse", "normalize",
           "rotate_vector", "from_axis_angle", "to_axis_angle", "from_rotation_matrix",
           "to_rotation_matrix", "euler_to_quaternion", "slerp", "blend", "blend_nlerp",
           "from_two_vectors", "multiply_assume_normalized", "rotate_vector_assume_normalized",
           "to_rotation_matrix_assume_normalized", "euler_xyz_to_quaternion",
           "euler_zyx_to_quaternion", "quaternion_to_xyz_euler",
           "check_and_normalize_weights"]

_EPS = 1e-12


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion(s) of shape ``(*shape, 4)``."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def check(q: torch.Tensor) -> None:
    if q.shape[-1] != 4:
        raise ValueError(f"expected last dim 4 for quaternion, got {tuple(q.shape)}")


def split(q: torch.Tensor):
    """(vector xyz (..., 3), scalar w (..., 1))."""
    check(q)
    return q[..., :3], q[..., 3:]


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


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inverse(q: torch.Tensor) -> torch.Tensor:
    """Multiplicative inverse (the conjugate for unit quaternions)."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return conjugate(q) / torch.clamp(n2, min=_EPS)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by unit quaternion(s) q:
    v + 2·qw·(qv × v) + 2·qv × (qv × v)."""
    qv, qw = q[..., :3], q[..., 3:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def from_axis_angle(axis_angle: torch.Tensor) -> torch.Tensor:
    """Quaternion of a rotation vector (axis · angle); sin(a/2)/a → 1/2 as
    a → 0 by its series below 1e-6."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    k = torch.where(angle < 1e-6, 0.5 + angle * angle / 48.0,
                    torch.sin(0.5 * angle) / torch.clamp(angle, min=_EPS))
    return torch.cat([axis_angle * k, torch.cos(0.5 * angle)], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis · angle) of a unit quaternion, angle in [0, π]."""
    qv, qw = q[..., :3], q[..., 3:]
    sin_half = torch.linalg.norm(qv, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, torch.abs(qw))
    sign = torch.where(qw < 0, -1.0, 1.0)
    k = torch.where(sin_half < 1e-9, 2.0 * sign,
                    sign * angle / torch.clamp(sin_half, min=_EPS))
    return qv * k


def _axis_quat(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """Quaternion for a rotation of `angle` about coordinate axis `axis`."""
    half = 0.5 * angle
    z = torch.zeros_like(angle)
    comps = [z, z, z]
    comps[axis] = torch.sin(half)
    return torch.stack(comps + [torch.cos(half)], dim=-1)


def euler_to_quaternion(angles: torch.Tensor, order: str = "ZYX") -> torch.Tensor:
    """Quaternion of the product R = R_o0(a_o0)·R_o1(a_o1)·R_o2(a_o2) for
    the axes of `order`, left to right; `angles[..., i]` is the angle
    about axis i whatever the order. The joint rotation
    Rz(rz)·Ry(ry)·Rx(rx) is order "ZYX" (joint_state.cpp:50-58)."""
    axis_of = {"X": 0, "Y": 1, "Z": 2}
    q = None
    for ch in order:
        ax = axis_of[ch]
        qa = _axis_quat(angles[..., ax], ax)
        q = qa if q is None else multiply(q, qa)
    return q


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


def from_rotation_matrix(m: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from a (..., 3, 3) rotation matrix: Shepperd's method
    on all four candidates, selected with `where` (branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0

    s0 = root(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    q = torch.where((tr > 0.0)[..., None], q0,
                    torch.where(cond1, q1, torch.where((m11 > m22)[..., None], q2, q3)))
    return normalize(q)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation along the shorter arc (q1's sign
    flipped where q0·q1 < 0), the normalized lerp where sin θ < 1e-5. `t`
    broadcasts against the batch shape, or against (..., 1)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    theta = torch.acos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    lerp = sin_theta < 1e-5
    inv = 1.0 / torch.clamp(sin_theta, min=_EPS)
    w0 = torch.where(lerp, 1.0 - t, torch.sin((1.0 - t) * theta) * inv)
    w1 = torch.where(lerp, t, torch.sin(t * theta) * inv)
    return normalize(w0 * q0 + w1 * q1)


def blend(quats: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted blend over the second-to-last axis: the top eigenvector of
    M = Σ w_i·q_i·q_iᵀ with the weights clamped ≥ 0 and normalized to sum 1
    (Markley et al. 2007). Its sign is the eigensolver's: compare blends up
    to sign, or through their rotation matrices."""
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype, device=quats.device)
    weights = torch.clamp(weights, min=0.0)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=_EPS)
    m = torch.einsum("...ki,...kj,...k->...ij", quats, quats, weights)
    _, vecs = torch.linalg.eigh(m)  # ascending eigenvalues
    return vecs[..., :, 3]


def from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The shortest-arc quaternion turning direction a onto direction b;
    antiparallel directions turn by π about an axis orthogonal to a."""
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=_EPS)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=_EPS)
    w = 1.0 + torch.sum(a * b, dim=-1, keepdim=True)
    pick = torch.where(torch.abs(a[..., :1]) < 0.9, a.new_tensor([1.0, 0.0, 0.0]),
                       a.new_tensor([0.0, 1.0, 0.0]))
    q = torch.cat([_cross(a, b), w], dim=-1)
    q_anti = torch.cat([_cross(a, pick), torch.zeros_like(w)], dim=-1)
    return normalize(torch.where(w < 1e-6, q_anti, q))


def blend_nlerp(quats: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized-lerp blend over the second-to-last axis: each quaternion's
    sign matched to the first one's, the weighted sum normalized. First-order
    equal to `blend` for clustered quaternions."""
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype, device=quats.device)
    ref = quats[..., :1, :]
    sign = torch.where(torch.sum(quats * ref, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    return normalize(torch.sum(quats * sign * weights[..., None], dim=-2))


# pymomentum's *_assume_normalized names (quaternion_np.py:332-420): the base
# operations never normalize, so they are the same functions
multiply_assume_normalized = multiply
rotate_vector_assume_normalized = rotate_vector
to_rotation_matrix_assume_normalized = to_rotation_matrix


def euler_xyz_to_quaternion(euler_xyz: torch.Tensor) -> torch.Tensor:
    """[rx, ry, rz] applied X first, then Y, then Z: q = qz ⊗ qy ⊗ qx
    (quaternion_np.py:332-358)."""
    return euler_to_quaternion(euler_xyz, "ZYX")


def euler_zyx_to_quaternion(euler_zyx: torch.Tensor) -> torch.Tensor:
    """[yaw, pitch, roll] applied Z first, then Y, then X: the angles
    reversed and taken in order "XYZ" (quaternion_np.py:361-390)."""
    return euler_to_quaternion(euler_zyx.flip(-1), "XYZ")


def quaternion_to_xyz_euler(q: torch.Tensor) -> torch.Tensor:
    """(rx, ry, rz) with Rz(rz)·Ry(ry)·Rx(rx) = R(q), the inverse of
    euler_xyz_to_quaternion."""
    from momentum_tpu_torch.math.euler import quaternion_to_euler_zyx

    return quaternion_to_euler_zyx(q)


def check_and_normalize_weights(quats: torch.Tensor,
                                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Blend weights for (..., k, 4) quaternions (pymomentum/quaternion.py:353):
    uniform when absent, else normalized to sum 1 over k (a zero sum left
    as it is)."""
    k = quats.shape[-2]
    if quats.shape[-1] != 4:
        raise ValueError(f"expected (..., k, 4) quaternions, got {tuple(quats.shape)}")
    if weights is None:
        return torch.full(quats.shape[:-1], 1.0 / k, dtype=quats.dtype, device=quats.device)
    weights = torch.as_tensor(weights, dtype=quats.dtype, device=quats.device)
    if weights.shape[-1] != k:
        raise ValueError(f"weights last dim {weights.shape[-1]} != quaternion count {k}")
    total = torch.sum(weights, dim=-1, keepdim=True)
    return weights / torch.where(total == 0, 1.0, total)
