"""TRS (translation, rotation matrix, scale) transforms on tensors, after
momentum_tpu/math/trs.py (pymomentum/trs.py): a transform is the tuple
``(t (..., 3), r (..., 3, 3), s (..., 1))`` mapping ``x → t + r @ (s·x)``,
and converts to and from the 8-float skel_state both ways.

Composition (trs.py:180-206): (A·B).t = A.t + A.R (A.s · B.t),
(A·B).R = A.R·B.R, (A·B).s = A.s·B.s (math/transform.h:119-129).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from momentum_tpu_torch.math import quaternion as quat

__all__ = ["TRSTransform", "from_translation", "from_rotation_matrix", "from_scale",
           "identity", "multiply", "inverse", "transform_points", "to_matrix", "from_matrix",
           "from_skeleton_state", "to_skeleton_state", "slerp", "blend", "rotmat_inverse",
           "rotmat_multiply", "rotmat_rotate_vector", "rotmat_from_euler_xyz", "index_select",
           "where"]

TRSTransform = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _eye(batch, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(tuple(batch) + (3, 3))


def from_translation(translation: torch.Tensor) -> TRSTransform:
    """A pure translation (trs.py:74)."""
    batch = translation.shape[:-1]
    return translation, _eye(batch, translation), translation.new_ones(batch + (1,))


def from_rotation_matrix(rotation_matrix: torch.Tensor) -> TRSTransform:
    """A pure rotation (trs.py:98)."""
    batch = rotation_matrix.shape[:-2]
    return (rotation_matrix.new_zeros(batch + (3,)), rotation_matrix,
            rotation_matrix.new_ones(batch + (1,)))


def from_scale(scale: torch.Tensor) -> TRSTransform:
    """A pure uniform scale, `scale` (..., 1) (trs.py:120)."""
    batch = scale.shape[:-1]
    return scale.new_zeros(batch + (3,)), _eye(batch, scale), scale


def identity(batch_shape=(), dtype=torch.float32, device=None) -> TRSTransform:
    """The identity with the given leading batch shape (trs.py:144)."""
    batch = tuple(batch_shape)
    t = torch.zeros(batch + (3,), dtype=dtype, device=device)
    return t, _eye(batch, t), torch.ones(batch + (1,), dtype=dtype, device=device)


def multiply(trs1: TRSTransform, trs2: TRSTransform) -> TRSTransform:
    """trs2 applied first, then trs1 (trs.py:180-206)."""
    t1, r1, s1 = trs1
    t2, r2, s2 = trs2
    return t1 + rotmat_rotate_vector(r1, s1 * t2), rotmat_multiply(r1, r2), s1 * s2


def inverse(trs: TRSTransform) -> TRSTransform:
    """The inverse; the rotation inverts by its transpose (trs.py:209-233)."""
    t, r, s = trs
    r_inv = r.transpose(-2, -1)
    s_inv = 1.0 / s
    return -rotmat_rotate_vector(r_inv, s_inv * t), r_inv, s_inv


def transform_points(trs: TRSTransform, points: torch.Tensor) -> torch.Tensor:
    """t + r @ (s·points) (trs.py:235-256)."""
    if points.shape[-1] != 3:
        raise ValueError("points must have last dimension 3")
    t, r, s = trs
    return t + rotmat_rotate_vector(r, s * points)


def to_matrix(trs: TRSTransform) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrices (trs.py:257-283)."""
    t, r, s = trs
    affine = torch.cat([r * s[..., None, :], t[..., :, None]], dim=-1)
    last = t.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(t.shape[:-1] + (1, 4))
    return torch.cat([affine, last], dim=-2)


def from_matrix(matrices: torch.Tensor) -> TRSTransform:
    """(..., 4, 4) uniform-scale affine matrices decomposed by SVD: the
    scale the largest singular value, R = U·Vᵀ (trs.py:285-327)."""
    if matrices.shape[-2:] != (4, 4):
        raise ValueError("expected (..., 4, 4) matrices")
    u, sv, vt = torch.linalg.svd(matrices[..., :3, :3])
    return matrices[..., :3, 3], u @ vt, sv[..., :1]


def from_skeleton_state(skeleton_state: torch.Tensor) -> TRSTransform:
    """(tx, ty, tz, qx, qy, qz, qw, s) skel_states → TRS (trs.py:329-351)."""
    if skeleton_state.shape[-1] != 8:
        raise ValueError("expected skeleton state with last dimension 8")
    return (skeleton_state[..., :3], quat.to_rotation_matrix(skeleton_state[..., 3:7]),
            skeleton_state[..., 7:])


def to_skeleton_state(trs: TRSTransform) -> torch.Tensor:
    """TRS → 8-float skel_states (trs.py:353-370)."""
    t, r, s = trs
    return torch.cat([t, quat.from_rotation_matrix(r), s], dim=-1)


def slerp(trs0: TRSTransform, trs1: TRSTransform, t) -> TRSTransform:
    """t and s interpolated linearly, the rotation by quaternion slerp
    (trs.py:373-400)."""
    t0, r0, s0 = trs0
    t1, r1, s1 = trs1
    t = torch.as_tensor(t, dtype=t0.dtype, device=t0.device)
    w1 = t[..., None]
    w0 = 1.0 - w1
    q = quat.slerp(quat.from_rotation_matrix(r0), quat.from_rotation_matrix(r1), t)
    return w0 * t0 + w1 * t1, quat.to_rotation_matrix(q), w0 * s0 + w1 * s1


def blend(trs_transforms: Sequence[TRSTransform],
          weights: Optional[torch.Tensor] = None) -> TRSTransform:
    """Weighted blend: t and s linearly, the rotation by the quaternion
    eigen-average (trs.py:402-455)."""
    if len(trs_transforms) == 0:
        raise ValueError("cannot blend an empty list of transforms")
    if len(trs_transforms) == 1:
        return trs_transforms[0]
    ts = torch.stack([x[0] for x in trs_transforms], dim=-2)
    rs = torch.stack([x[1] for x in trs_transforms], dim=-3)
    ss = torch.stack([x[2] for x in trs_transforms], dim=-2)
    n = len(trs_transforms)
    if weights is None:
        weights = torch.full((n,), 1.0 / n, dtype=ts.dtype, device=ts.device)
    weights = torch.as_tensor(weights, dtype=ts.dtype, device=ts.device)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    qs = quat.from_rotation_matrix(rs)
    return (torch.sum(weights[..., None] * ts, dim=-2),
            quat.to_rotation_matrix(quat.blend(qs, weights)),
            torch.sum(weights[..., None] * ss, dim=-2))


def rotmat_inverse(r: torch.Tensor) -> torch.Tensor:
    """The transpose (trs.py:458-470)."""
    return r.transpose(-2, -1)


def rotmat_multiply(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Batched matrix product (trs.py:472-484)."""
    return r1 @ r2


def rotmat_rotate_vector(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vectors rotated by (..., 3, 3) matrices (trs.py:486-498)."""
    return torch.einsum("...ij,...j->...i", r, v)


def rotmat_from_euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    """Joint-convention Euler (rx, ry, rz) → Rz·Ry·Rx (trs.py:574-609)."""
    from momentum_tpu_torch.math.euler import euler_zyx_to_matrix

    return euler_zyx_to_matrix(euler)


def index_select(trs: TRSTransform, dim: int, indices) -> TRSTransform:
    """Select along a leading batch dimension (trs.py:500-537)."""
    if dim < 0:
        raise ValueError("dim must index a leading batch dimension")
    t, r, s = trs
    idx = torch.as_tensor(indices, dtype=torch.int64, device=t.device)
    return t.index_select(dim, idx), r.index_select(dim, idx), s.index_select(dim, idx)


def where(condition: torch.Tensor, trs1: TRSTransform, trs2: TRSTransform) -> TRSTransform:
    """Elementwise choice between two transforms; `condition` broadcasts
    against the batch shape (trs.py:539-572)."""
    c = torch.as_tensor(condition, device=trs1[0].device)
    t1, r1, s1 = trs1
    t2, r2, s2 = trs2
    return (torch.where(c[..., None], t1, t2), torch.where(c[..., None, None], r1, r2),
            torch.where(c[..., None], s1, s2))
