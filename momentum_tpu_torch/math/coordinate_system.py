"""Coordinate-system conversions (up axis, handedness, length unit), the
port's own copy of momentum_tpu/math/coordinate_system.py on tensors.

Reference: momentum/math/coordinate_system.{h,cpp}: CoordinateSystem
{UpAxis, Handedness, LengthUnit}, the canonical Momentum system (Y-up,
right-handed, centimeters), scaleFactor, and change{Vector,Quaternion,
Matrix} through the signed permutation P = toAxes · fromAxesᵀ, where each
axes matrix maps semantic (right, forward, up) to world (x, y, z); a
left-handed system flips only the forward axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = [
    "UP_X", "UP_Y", "UP_Z",
    "HAND_LEFT", "HAND_RIGHT",
    "UNIT_METER", "UNIT_DECIMETER", "UNIT_CENTIMETER", "UNIT_MILLIMETER",
    "CoordinateSystem",
    "MOMENTUM_COORDINATE_SYSTEM",
    "scale_factor",
    "permutation_matrix",
    "change_vector",
    "change_quaternion",
    "change_matrix",
]

UP_X, UP_Y, UP_Z = "x", "y", "z"
HAND_LEFT, HAND_RIGHT = "left", "right"
UNIT_METER, UNIT_DECIMETER, UNIT_CENTIMETER, UNIT_MILLIMETER = "m", "dm", "cm", "mm"

_UNIT_IN_METERS = {"m": 1.0, "dm": 0.1, "cm": 0.01, "mm": 0.001}


@dataclasses.dataclass(frozen=True)
class CoordinateSystem:
    up: str = UP_Y
    hand: str = HAND_RIGHT
    unit: str = UNIT_CENTIMETER


#: Momentum's canonical system: Y-up, right-handed, centimeters.
MOMENTUM_COORDINATE_SYSTEM = CoordinateSystem()


def scale_factor(src: CoordinateSystem, dst: CoordinateSystem) -> float:
    """The length scale from src's unit to dst's (m → cm = 100)."""
    return _UNIT_IN_METERS[src.unit] / _UNIT_IN_METERS[dst.unit]


def _axes(up: str, hand: str) -> np.ndarray:
    """Columns: the world directions of (right, forward, up)."""
    m = np.zeros((3, 3))
    r = 1.0 if hand == HAND_RIGHT else -1.0
    if up == UP_Y:  # OpenGL-style
        m[:, 0], m[:, 1], m[:, 2] = [1, 0, 0], [0, 0, -r], [0, 1, 0]
    elif up == UP_Z:  # Blender/robotics-style
        m[:, 0], m[:, 1], m[:, 2] = [1, 0, 0], [0, r, 0], [0, 0, 1]
    elif up == UP_X:
        m[:, 0], m[:, 1], m[:, 2] = [0, 1, 0], [0, 0, r], [1, 0, 0]
    else:
        raise ValueError(f"unknown up axis {up!r}")
    return m


def permutation_matrix(src: CoordinateSystem, dst: CoordinateSystem,
                       device="cuda") -> torch.Tensor:
    """The signed permutation P with v_dst = P · v_src (float32), on
    `device` (the card unless the caller asks for the CPU)."""
    p = _axes(dst.up, dst.hand) @ _axes(src.up, src.hand).T
    return torch.as_tensor(p, dtype=torch.float32,
                           device=resolve(device, "permutation_matrix"))


def change_vector(v: torch.Tensor, src: CoordinateSystem,
                  dst: CoordinateSystem) -> torch.Tensor:
    """Positions and directions: axis permutation, handedness, unit scale."""
    p = permutation_matrix(src, dst, v.device).to(v.dtype)
    return scale_factor(src, dst) * torch.einsum("ij,...j->...i", p, v)


def change_matrix(r: torch.Tensor, src: CoordinateSystem,
                  dst: CoordinateSystem) -> torch.Tensor:
    """Rotation matrices: P·R·Pᵀ (a proper rotation; no unit scale)."""
    p = permutation_matrix(src, dst, r.device).to(r.dtype)
    return torch.einsum("ij,...jk,lk->...il", p, r, p)


def change_quaternion(q: torch.Tensor, src: CoordinateSystem,
                      dst: CoordinateSystem) -> torch.Tensor:
    """Quaternions, through the rotation matrix so that a handedness flip
    is handled (coordinate_system.cpp changeQuaternion)."""
    from momentum_tpu_torch.math import quaternion as quat

    return quat.from_rotation_matrix(change_matrix(quat.to_rotation_matrix(q), src, dst))
