"""Wavefront OBJ export (the reference's export_objs example +
rasterizer mesh dumps)."""

from __future__ import annotations

from momentum_tpu_torch.device import to_host

__all__ = ["save_obj", "export_motion_objs"]


def save_obj(path, vertices, faces, normals=None) -> None:
    """Write a mesh (tensors on any device, or arrays) as OBJ text."""
    vertices, faces = to_host(vertices), to_host(faces)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for n in to_host(normals):
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for tri in faces + 1:
            if normals is not None:
                f.write(f"f {tri[0]}//{tri[0]} {tri[1]}//{tri[1]} {tri[2]}//{tri[2]}\n")
            else:
                f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def export_motion_objs(prefix, character, motion, stride: int = 1) -> list:
    """Write one OBJ per (strided) frame of a model-parameter motion
    (examples/export_objs equivalent), posed on the motion's device (FK
    through kernel K1 and skinning on the card). Returns written paths."""
    import torch

    from momentum_tpu_torch.compat import skin_points_from_model_parameters

    if not isinstance(motion, torch.Tensor):
        motion = torch.as_tensor(motion, dtype=torch.float32,
                                 device=character.mesh.vertices.device)
    posed = to_host(skin_points_from_model_parameters(character, motion[::stride]))
    faces = to_host(character.mesh.faces)
    paths = []
    for i in range(posed.shape[0]):
        p = f"{prefix}_{i * stride:05d}.obj"
        save_obj(p, posed[i], faces)
        paths.append(p)
    return paths
