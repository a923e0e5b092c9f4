"""Euler-angle conversions on tensors, after momentum_tpu/math/euler.py.

Conventions mirror the reference (momentum/math/utility.h:153-175): an
*intrinsic* sequence "XYZ" means the matrix product Rx·Ry·Rz; the
*extrinsic* XYZ sequence is the intrinsic ZYX product with the angle order
reversed. The reference's joint rotation R = Rz(rz)·Ry(ry)·Rx(rx) is
intrinsic ZYX, i.e. extrinsic XYZ (joint_state.cpp:50-58).

The `rotation_matrix_to_euler_*` functions select their gimbal-lock
branches with `torch.where`, so they batch; at a lock the first angle is
pinned to zero as the reference does (utility.cpp:220-236, 265-280).
"""

from __future__ import annotations

import math

import torch

from momentum_tpu_torch.math import quaternion as quat

__all__ = [
    "euler_xyz_to_matrix",
    "euler_zyx_to_matrix",
    "rotation_matrix_to_euler_xyz",
    "rotation_matrix_to_euler_zyx",
    "quaternion_to_euler_zyx",
    "euler_to_matrix",
    "rotation_matrix_to_euler",
    "rotation_matrix_to_one_axis_euler",
    "rotation_matrix_to_two_axis_euler",
]

_TOL = 1e-6
_EVEN = {(0, 1, 2), (1, 2, 0), (2, 0, 1)}


def _axis_matrix(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == 0:
        rows = [one, zero, zero, zero, c, -s, zero, s, c]
    elif axis == 1:
        rows = [c, zero, s, zero, one, zero, -s, zero, c]
    else:
        rows = [c, -s, zero, s, c, zero, zero, zero, one]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def _d_axis_matrix(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """d R_axis(angle) / d angle."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(angle)
    if axis == 0:
        rows = [zero, zero, zero, zero, -s, -c, zero, c, -s]
    elif axis == 1:
        rows = [-s, zero, c, zero, zero, zero, -c, zero, -s]
    else:
        rows = [-s, -c, zero, c, -s, zero, zero, zero, zero]
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ: Rx(a0)·Ry(a1)·Rz(a2)."""
    return (_axis_matrix(angles[..., 0], 0) @ _axis_matrix(angles[..., 1], 1)
            @ _axis_matrix(angles[..., 2], 2))


def euler_zyx_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Intrinsic ZYX with the angles given as (rx, ry, rz): Rz(a2)·Ry(a1)·Rx(a0),
    the joint-rotation convention."""
    return (_axis_matrix(angles[..., 2], 2) @ _axis_matrix(angles[..., 1], 1)
            @ _axis_matrix(angles[..., 0], 0))


def rotation_matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """Intrinsic-XYZ angles (x, y, z) such that Rx·Ry·Rz == m."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    sy = torch.clamp(m02, -1.0, 1.0)
    x_r = torch.atan2(-m12, m[..., 2, 2])
    y_r = torch.asin(sy)
    z_r = torch.atan2(-m01, m00)
    # gimbal locks: sy == ∓1 pins x to 0; z comes from the same entries at both
    z_lock = torch.atan2(m10, m11)
    lo = sy <= -1.0 + _TOL
    hi = sy >= 1.0 - _TOL
    x = torch.where(lo | hi, 0.0, x_r)
    y = torch.where(lo, -math.pi / 2, torch.where(hi, math.pi / 2, y_r))
    z = torch.where(lo | hi, z_lock, z_r)
    return torch.stack([x, y, z], dim=-1)


def rotation_matrix_to_euler_zyx(m: torch.Tensor) -> torch.Tensor:
    """Angles (z, y, x) such that Rz(z)·Ry(y)·Rx(x) == m (the reference's ZYX
    order, utility.cpp:240-281: the first component is the Z angle)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    sy = torch.clamp(-m20, -1.0, 1.0)
    z_r = torch.atan2(m[..., 1, 0], m00)
    y_r = torch.asin(sy)
    x_r = torch.atan2(m21, m22)
    # locks: m20 == -1 → sin(y) = +1; m20 == +1 → sin(y) = -1; z pinned to 0
    hi = m20 <= -1.0 + _TOL
    lo = m20 >= 1.0 - _TOL
    x_hi = torch.atan2(m01, m02)
    x_lo = torch.atan2(-m01, -m02)
    z = torch.where(lo | hi, 0.0, z_r)
    y = torch.where(hi, math.pi / 2, torch.where(lo, -math.pi / 2, y_r))
    x = torch.where(hi, x_hi, torch.where(lo, x_lo, x_r))
    return torch.stack([z, y, x], dim=-1)


def quaternion_to_euler_zyx(q: torch.Tensor) -> torch.Tensor:
    """(rx, ry, rz) such that Rz(rz)·Ry(ry)·Rx(rx) == R(q): the inverse of
    the FK joint rotation."""
    return rotation_matrix_to_euler_zyx(quat.to_rotation_matrix(q)).flip(-1)


def euler_to_matrix(angles: torch.Tensor, axes=(0, 1, 2),
                    convention: str = "intrinsic") -> torch.Tensor:
    """General Euler composition (utility.h:153-175): intrinsic (i, j, k) is
    R_i(a0)·R_j(a1)·R_k(a2); extrinsic the reversed product
    R_k(a2)·R_j(a1)·R_i(a0). Proper Euler sequences (ZXZ) are allowed."""
    i, j, k = axes
    if convention == "extrinsic":
        return (_axis_matrix(angles[..., 2], k) @ _axis_matrix(angles[..., 1], j)
                @ _axis_matrix(angles[..., 0], i))
    if convention != "intrinsic":
        raise ValueError(f"unknown Euler convention {convention!r}")
    return (_axis_matrix(angles[..., 0], i) @ _axis_matrix(angles[..., 1], j)
            @ _axis_matrix(angles[..., 2], k))


def rotation_matrix_to_euler(m: torch.Tensor, axes=(0, 1, 2),
                             convention: str = "intrinsic") -> torch.Tensor:
    """Angles such that euler_to_matrix(angles, axes, convention) == m, for
    all 12 sequences, 6 Tait-Bryan and 6 proper Euler (utility.cpp:185-196;
    the reference's Eigen::eulerAngles may choose other branches, with the
    same recomposition)."""
    i, j, k = axes
    if convention == "extrinsic":
        return rotation_matrix_to_euler(m, (k, j, i), "intrinsic").flip(-1)
    if convention != "intrinsic":
        raise ValueError(f"unknown Euler convention {convention!r}")
    if i == j or j == k:
        raise ValueError("consecutive equal axes are degenerate")
    tol = _TOL if m.dtype == torch.float32 else 1e-12

    if i != k:  # Tait-Bryan
        eps = 1.0 if (i, j, k) in _EVEN else -1.0
        s1 = eps * m[..., i, k]
        # cos t1 ≥ 0 on the principal range, recovered from the (j,k)/(k,k)
        # pair so that t1 stays accurate up to the lock
        c1 = torch.sqrt(m[..., j, k] ** 2 + m[..., k, k] ** 2)
        t0 = torch.atan2(-eps * m[..., j, k], m[..., k, k])
        t1 = torch.atan2(s1, c1)
        t2 = torch.atan2(-eps * m[..., i, j], m[..., i, i])
        # at the exact lock every operand above vanishes: pin t2 = 0; the
        # rest is R_i(t0)·R_j(±π/2), m[j,j] = cos t0, m[k,j] = eps·sin t0
        locked = c1 <= tol
        t0 = torch.where(locked, torch.atan2(eps * m[..., k, j], m[..., j, j]), t0)
        t2 = torch.where(locked, 0.0, t2)
    else:  # proper Euler
        l = 3 - i - j  # noqa: E741 - the unused third axis
        eps = 1.0 if (i, j, l) in _EVEN else -1.0
        c1 = m[..., i, i]
        # sin t1 ≥ 0 on the principal range [0, π]
        s1 = torch.sqrt(m[..., j, i] ** 2 + m[..., l, i] ** 2)
        t0 = torch.atan2(m[..., j, i], -eps * m[..., l, i])
        t1 = torch.atan2(s1, c1)
        t2 = torch.atan2(m[..., i, j], eps * m[..., i, l])
        # at the lock the rotation is about axis i alone: pin t2 = 0
        locked = s1 <= tol
        t0 = torch.where(locked, torch.atan2(eps * m[..., l, j], m[..., j, j]), t0)
        t2 = torch.where(locked, 0.0, t2)
    return torch.stack([t0, t1, t2], dim=-1)


def rotation_matrix_to_one_axis_euler(m: torch.Tensor, axis: int) -> torch.Tensor:
    """The angle θ minimizing ‖R_axis(θ) − m‖_F (utility.cpp:822-843), in
    closed form: atan2(m[q,p] − m[p,q], m[p,p] + m[q,q]) over the plane
    (p, q) with (axis, p, q) cyclic."""
    p, q = (axis + 1) % 3, (axis + 2) % 3
    return torch.atan2(m[..., q, p] - m[..., p, q], m[..., p, p] + m[..., q, q])


def rotation_matrix_to_two_axis_euler(m: torch.Tensor, axis0: int, axis1: int,
                                      num_iterations: int = 20) -> torch.Tensor:
    """The angles (t0, t1) of R = R_axis1(t1)·R_axis0(t0) nearest m in the
    Frobenius norm (utility.cpp:845-857): Gauss-Newton on the 9 entries from
    the one-axis fits, a fixed number of iterations."""
    if axis0 == axis1:
        raise ValueError("two-axis fit requires distinct axes")
    angles = torch.stack([rotation_matrix_to_one_axis_euler(m, axis0),
                          rotation_matrix_to_one_axis_euler(m, axis1)], dim=-1)
    flat = m.shape[:-2] + (9,)
    for _ in range(num_iterations):
        t0, t1 = angles[..., 0], angles[..., 1]
        r0, r1 = _axis_matrix(t0, axis0), _axis_matrix(t1, axis1)
        resid = (r1 @ r0 - m).reshape(flat)
        j0 = (r1 @ _d_axis_matrix(t0, axis0)).reshape(flat)
        j1 = (_d_axis_matrix(t1, axis1) @ r0).reshape(flat)
        jtj00, jtj01, jtj11 = (j0 * j0).sum(-1), (j0 * j1).sum(-1), (j1 * j1).sum(-1)
        g0, g1 = (j0 * resid).sum(-1), (j1 * resid).sum(-1)
        det = jtj00 * jtj11 - jtj01 * jtj01
        safe = torch.abs(det) > 1e-12
        det = torch.where(safe, det, 1.0)
        d0 = torch.where(safe, -(jtj11 * g0 - jtj01 * g1) / det, 0.0)
        d1 = torch.where(safe, -(jtj00 * g1 - jtj01 * g0) / det, 0.0)
        angles = angles + torch.stack([d0, d1], dim=-1)
    return angles
