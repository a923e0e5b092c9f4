"""Blend-shape and pose-shape binary IO.

Reference: momentum/io/shape/blend_shape_io.cpp (u64 rows, u64 cols header,
then [mean shape: rows f32 for BlendShape] + column-major f32 shape-vector
matrix) and pose_shape_io.cpp (u64 rows, u64 numJoints; length-prefixed base
joint name + driver joint names; mean-shape DELTA of rows f32 — vertices are
added back at load; column-major (rows, 4·numJoints) shape vectors).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = [
    "load_blend_shape_base",
    "load_blend_shape",
    "save_blend_shape",
    "load_pose_shape",
    "save_pose_shape",
]

_MAX_DIM = 10_000_000


def _read_dims(f):
    rows, cols = struct.unpack("<QQ", f.read(16))
    if rows > _MAX_DIM or cols > _MAX_DIM:
        raise ValueError(f"unreasonable shape dimensions {rows}x{cols}")
    return rows, cols


def _trim(mat, expected_shapes, expected_vertices):
    if expected_shapes and expected_shapes > 0:
        mat = mat[:, : expected_shapes]
    if expected_vertices and expected_vertices > 0:
        mat = mat[: expected_vertices * 3]
    return mat


def _vectors(mat) -> np.ndarray:
    """(rows, K) column matrix → (K, V, 3) shape vectors."""
    return np.array(mat.T).reshape(mat.shape[1], -1, 3)


def load_blend_shape_base(path, expected_shapes: int = -1, expected_vertices: int = -1,
                          device="cuda"):
    """→ shape_vectors (K, V, 3) on `device` (the card unless the caller
    asks for the CPU) (BlendShapeBase: no mean shape)."""
    device = resolve(device, "load_blend_shape_base")
    with open(path, "rb") as f:
        rows, cols = _read_dims(f)
        mat = np.frombuffer(f.read(4 * rows * cols), "<f4").reshape(cols, rows).T
    return torch.as_tensor(_vectors(_trim(mat, expected_shapes, expected_vertices)),
                           device=device)


def load_blend_shape(path, expected_shapes: int = -1, expected_vertices: int = -1,
                     device="cuda"):
    """→ character.BlendShape (mean + shape vectors) on `device` (the card
    unless the caller asks for the CPU)."""
    from momentum_tpu_torch.character.blend_shape import BlendShape

    device = resolve(device, "load_blend_shape")
    with open(path, "rb") as f:
        rows, cols = _read_dims(f)
        mean = np.frombuffer(f.read(4 * rows), "<f4").reshape(-1, 3)
        mat = np.frombuffer(f.read(4 * rows * cols), "<f4").reshape(cols, rows).T
    mat = _trim(mat, expected_shapes, expected_vertices)
    if expected_vertices and expected_vertices > 0:
        mean = mean[:expected_vertices]
    return BlendShape(base_shape=torch.as_tensor(np.array(mean), device=device),
                      shape_vectors=torch.as_tensor(_vectors(mat), device=device))


def save_blend_shape(path, blend_shape) -> None:
    """Inverse of load_blend_shape (saveBlendShape)."""
    base = to_host(blend_shape.base_shape).astype(np.float32)
    vecs = to_host(blend_shape.shape_vectors).astype(np.float32)  # (K, V, 3)
    rows = base.size
    cols = vecs.shape[0]
    mat = vecs.reshape(cols, rows).T  # (rows, cols)
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", rows, cols))
        f.write(base.tobytes())
        f.write(np.asfortranarray(mat).tobytes(order="F"))


def _read_name(f, max_len: int = 10_000) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    if n > max_len:
        raise ValueError("invalid name length")
    return f.read(n).decode("ascii", "replace")


def load_pose_shape(path, character):
    """→ character.PoseShape resolved against `character`'s skeleton/mesh,
    on the character's device (pose_shape_io.cpp loadPoseShape). The stored
    mean shape is a DELTA from the character's rest vertices."""
    from momentum_tpu_torch.character.pose_shape import PoseShape

    if character.mesh is None:
        raise ValueError("pose shapes need the character mesh")
    with open(path, "rb") as f:
        rows, n_joints = _read_dims(f)
        base_name = _read_name(f)
        names = [_read_name(f) for _ in range(n_joints)]
        mean = np.frombuffer(f.read(4 * rows), "<f4")
        mat = np.frombuffer(f.read(4 * rows * n_joints * 4), "<f4").reshape(
            n_joints * 4, rows).T  # column-major (rows, 4*nJoints)
    verts = to_host(character.mesh.vertices).astype(np.float32)
    if verts.size != rows:
        raise ValueError(f"pose shape rows {rows} != mesh size {verts.size}")
    device = character.mesh.vertices.device
    base_joint = character.skeleton.joint_index(base_name)
    return PoseShape(
        base_rot=character.skeleton.pre_rotation[base_joint],
        base_shape=torch.as_tensor(mean.reshape(-1, 3) + verts, device=device),
        shape_vectors=torch.as_tensor(np.array(mat).reshape(-1, 3, n_joints * 4),
                                      device=device),
        base_joint=int(base_joint),
        joint_map=tuple(character.skeleton.joint_index(n) for n in names),
    )


def save_pose_shape(path, pose_shape, character) -> None:
    """Inverse of load_pose_shape."""
    if character.mesh is None:
        raise ValueError("pose shapes need the character mesh")
    verts = to_host(character.mesh.vertices).astype(np.float32)
    base = to_host(pose_shape.base_shape).astype(np.float32).reshape(-1) - verts.reshape(-1)
    vecs = to_host(pose_shape.shape_vectors).astype(np.float32)  # (V, 3, 4D)
    rows = base.size
    n_joints = vecs.shape[-1] // 4
    names = character.skeleton.joint_names
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", rows, n_joints))
        bj = names[pose_shape.base_joint].encode()
        f.write(struct.pack("<Q", len(bj)) + bj)
        for j in pose_shape.joint_map:
            nm = names[j].encode()
            f.write(struct.pack("<Q", len(nm)) + nm)
        f.write(base.tobytes())
        f.write(np.asfortranarray(vecs.reshape(rows, n_joints * 4)).tobytes(order="F"))
