"""The pymomentum-style convenience surface on tensors, after
momentum_tpu/compat.py: the array operations of `pymomentum.geometry`
(geometry_pybind.cpp:159-268, array_*.cpp) under their names, batched over
leading dims. FK runs through K1 for CUDA tensors. The loaders of markers
and motions read their files through momentum_tpu_torch/io.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.inverse_fk import (
    joint_parameters_from_local_skel_states, joint_parameters_from_skeleton_states)
from momentum_tpu_torch.character.skinning import (  # noqa: F401
    apply_ssd, skin_points, skinning_matrices)
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math import skel_state as ss

__all__ = [
    "apply_parameter_transform",
    "model_parameters_to_skeleton_state",
    "joint_parameters_to_skeleton_state",
    "skeleton_state_to_joint_parameters",
    "model_parameters_to_positions",
    "joint_parameters_to_positions",
    "skin_points_from_model_parameters",
    "uniform_random_to_model_parameters",
    "reduce_to_selected_model_parameters",
    "bones_to_vertices",
    "reduce_mesh_to_bones",
    "compare_skeleton_states",
    "find_closest_points",
    "find_closest_points_on_mesh",
    "compute_vertex_normals",
    "replace_rest_mesh",
    "map_model_parameters",
    "map_joint_parameters",
    "model_parameters_to_blend_shape_coefficients",
    "model_parameters_to_face_expression_coefficients",
    "model_parameters_to_local_skeleton_state",
    "joint_parameters_to_local_skeleton_state",
    "local_skeleton_state_to_joint_parameters",
    "strip_lower_body_vertices",
    "strip_joints",
    "replace_skeleton_hierarchy",
    "reduce_mesh_by_faces",
    "reduce_mesh_by_vertices",
    "classify_triangles_by_texture",
    "split_mesh_by_texture_region",
    "load_markers",
    "load_markers_from_bytes",
    "load_motion",
    "is_fbxsdk_available",
]


def _index(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def _tensor(values, device, dtype=None) -> torch.Tensor:
    """`values` as a tensor: a tensor stays on its device, an array goes to
    `device`."""
    if isinstance(values, torch.Tensor):
        return values if dtype is None else values.to(dtype)
    return torch.as_tensor(values, dtype=dtype, device=device)


def _array_device(values, device, entry):
    """The device an array input goes to: a tensor's own, else `device`
    resolved by the port's rule (the card, or a raise without one)."""
    return values.device if isinstance(values, torch.Tensor) else resolve(device, entry)


def _on_character(values, character) -> torch.Tensor:
    """`values` as a tensor, an array on the character's device."""
    return _tensor(values, character.parameter_transform.transform.device)


def apply_parameter_transform(character, model_parameters: torch.Tensor) -> torch.Tensor:
    """(..., P) → (..., nJ*7)."""
    return character.parameter_transform.apply(model_parameters)


def model_parameters_to_skeleton_state(character, model_parameters: torch.Tensor) -> torch.Tensor:
    """(..., P) → (..., nJ, 8) global skel_states."""
    return character.skeleton_states(model_parameters)


def joint_parameters_to_skeleton_state(character, joint_parameters: torch.Tensor) -> torch.Tensor:
    return fk.global_skel_states(character.skeleton, joint_parameters)


def skeleton_state_to_joint_parameters(character, skeleton_state: torch.Tensor) -> torch.Tensor:
    return joint_parameters_from_skeleton_states(character.skeleton, skeleton_state)


def model_parameters_to_positions(character, model_parameters: torch.Tensor) -> torch.Tensor:
    """World positions of all locators, (..., L, 3)."""
    return character.locators.world_positions(character.skeleton_states(model_parameters))


def joint_parameters_to_positions(character, joint_parameters: torch.Tensor) -> torch.Tensor:
    states = fk.global_skel_states(character.skeleton, joint_parameters)
    return character.locators.world_positions(states)


def skin_points_from_model_parameters(character, model_parameters: torch.Tensor) -> torch.Tensor:
    """Posed mesh vertices (..., V, 3): linear blend skinning, after the body
    blend shapes where the rig drives them."""
    char = character.with_inverse_bind_pose()
    states = char.skeleton_states(model_parameters)
    rest = char.mesh.vertices
    if char.blend_shape is not None and char.blend_shape_param_index is not None:
        coeffs = model_parameters.index_select(
            -1, _index(char.blend_shape_param_index, model_parameters.device))
        rest = char.blend_shape.apply(coeffs)
    return skin_points(char.skin_weights, states, char.inverse_bind_pose, rest)


def uniform_random_to_model_parameters(character, unit_samples: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1] samples mapped onto each parameter's MinMax range,
    [−π, π] where it has none (array_parameter_transform.cpp)."""
    p = character.num_model_parameters
    lo = np.full(p, -np.pi, np.float32)
    hi = np.full(p, np.pi, np.float32)
    lim = character.limits
    bounds = lim.minmax_bounds.cpu().numpy()
    for i, pi in enumerate(lim.minmax_index.cpu().numpy()):
        lo[pi], hi[pi] = bounds[i]
    lo_t = torch.as_tensor(lo, device=unit_samples.device)
    hi_t = torch.as_tensor(hi, device=unit_samples.device)
    return lo_t + unit_samples * (hi_t - lo_t)


def compare_skeleton_states(state_a: torch.Tensor, state_b: torch.Tensor) -> dict:
    """SkeletonStateT::compare (skeleton_state.h:520-566): the largest and
    mean position error and rotation angle (radians) between two states."""
    ta, qa, _ = ss.split(state_a)
    tb, qb, _ = ss.split(state_b)
    pos_err = torch.linalg.vector_norm(ta - tb, dim=-1)
    ang_err = 2.0 * torch.acos(torch.clamp(torch.abs(torch.sum(qa * qb, dim=-1)), 0.0, 1.0))
    return dict(max_position_error=pos_err.max(), mean_position_error=pos_err.mean(),
                max_rotation_error=ang_err.max(), mean_rotation_error=ang_err.mean())


def reduce_to_selected_model_parameters(character, enabled):
    """The rig reduced to the enabled parameters (a boolean mask)."""
    from momentum_tpu_torch.character.utility import simplify_parameter_transform

    return simplify_parameter_transform(character, enabled)


def bones_to_vertices(character, joints_to_keep) -> np.ndarray:
    """bool (V,): the vertices whose largest skin weight is on one of
    `joints_to_keep` (momentum_geometry.cpp bonesToVertices)."""
    if character.skin_weights is None:
        raise ValueError("character has no skin weights")
    keep = np.zeros(character.num_joints, bool)
    keep[np.asarray(joints_to_keep, np.int64)] = True
    idx = character.skin_weights.index.cpu().numpy()
    w = character.skin_weights.weight.cpu().numpy()
    return keep[idx[np.arange(idx.shape[0]), w.argmax(axis=1)]]


def reduce_mesh_to_bones(character, joints_to_keep):
    """The mesh reduced to the vertices skinned to the given joints
    (momentum_geometry.cpp:515-524)."""
    from momentum_tpu_torch.character.utility import reduce_mesh_by_vertices

    return reduce_mesh_by_vertices(character, bones_to_vertices(character, joints_to_keep))


def find_closest_points(points_source, points_target, max_dist=None, normals_source=None,
                        normals_target=None, max_normal_dot=0.0, device="cuda"):
    """Each source point's closest target point by brute force over
    (S, T) (geometry_pybind.cpp:1445-1481); with normals, only targets with
    n_src·n_tgt > max_normal_dot qualify; a tie takes the first index.
    → (points (..., S, D), index (..., S) int32, -1 where none qualifies,
    valid (..., S)), on the source tensor's device, or for an array source
    on `device` (the card unless the caller asks for the CPU)."""
    src = _tensor(points_source, _array_device(points_source, device, "find_closest_points"),
                  torch.float32)
    tgt = torch.as_tensor(points_target, dtype=torch.float32, device=src.device)
    d2 = torch.sum((src[..., :, None, :] - tgt[..., None, :, :]) ** 2, dim=-1)
    if normals_source is not None and normals_target is not None:
        ns = torch.as_tensor(normals_source, dtype=torch.float32, device=src.device)
        nt = torch.as_tensor(normals_target, dtype=torch.float32, device=src.device)
        d2 = torch.where(torch.einsum("...si,...ti->...st", ns, nt) > max_normal_dot, d2,
                         torch.inf)
    if max_dist is not None:
        d2 = torch.where(d2 <= max_dist * max_dist, d2, torch.inf)
    idx = torch.argmin(d2, dim=-1)
    valid = torch.isfinite(torch.gather(d2, -1, idx[..., None])[..., 0])
    tgt_b = tgt.expand(idx.shape[:-1] + tgt.shape[-2:])
    pts = torch.gather(tgt_b, -2, idx[..., None].expand(idx.shape + (tgt.shape[-1],)))
    return (torch.where(valid[..., None], pts, 0.0),
            torch.where(valid, idx, -1).to(torch.int32), valid)


def find_closest_points_on_mesh(points_source, vertices_target, faces_target, device="cuda"):
    """Each source point's closest point on a triangle mesh
    (geometry_pybind.cpp:1484-1499) → (valid, points, face index int32,
    barycentrics), on the source tensor's device, or for an array source on
    `device` (the card unless the caller asks for the CPU)."""
    from momentum_tpu_torch.axel.queries import closest_point_on_mesh

    src = _tensor(points_source,
                  _array_device(points_source, device, "find_closest_points_on_mesh"),
                  torch.float32)
    cp, fi, bary, d2 = closest_point_on_mesh(
        src, torch.as_tensor(vertices_target, dtype=torch.float32, device=src.device),
        torch.as_tensor(faces_target, device=src.device))
    return torch.isfinite(d2), cp, fi.to(torch.int32), bary


def compute_vertex_normals(vertex_positions, triangles, device="cuda") -> torch.Tensor:
    """Area-weighted vertex normals, on the positions tensor's device, or
    for an array on `device` (the card unless the caller asks for the CPU)."""
    from momentum_tpu_torch.character.skinning import update_normals

    v = _tensor(vertex_positions,
                _array_device(vertex_positions, device, "compute_vertex_normals"), torch.float32)
    return update_normals(v, torch.as_tensor(triangles, device=v.device))


def replace_rest_mesh(character, rest_vertex_positions):
    """The character with new rest positions, topology unchanged."""
    mesh = character.mesh
    v = torch.as_tensor(rest_vertex_positions, dtype=torch.float32,
                        device=mesh.vertices.device)
    if v.shape != mesh.vertices.shape:
        raise ValueError("replace_rest_mesh cannot change topology: "
                         f"{tuple(v.shape)} vs {tuple(mesh.vertices.shape)}")
    return dataclasses.replace(character, mesh=dataclasses.replace(mesh, vertices=v))


def _by_name(values: torch.Tensor, src_names, tgt_names, width: int) -> torch.Tensor:
    """(..., len(src)·width) → (..., len(tgt)·width), matched by name, 0 where
    a target name has no source."""
    src_idx = {n: i for i, n in enumerate(src_names)}
    m = np.asarray([src_idx.get(n, -1) for n in tgt_names], np.int64)
    cols = (m[:, None] * width + np.arange(width)[None, :]).reshape(-1)
    valid = torch.as_tensor(np.repeat(m >= 0, width), device=values.device)
    gathered = values.index_select(-1, _index(np.maximum(cols, 0), values.device))
    return torch.where(valid, gathered, 0.0)


def map_model_parameters(motion, source_character, target_character,
                         verbose: bool = False) -> torch.Tensor:
    """(..., P_src) model parameters in the target's parameter order, by
    name; a target parameter with no source is 0
    (array_parameter_transform.cpp:557-713)."""
    motion = _on_character(motion, source_character)
    src = source_character.parameter_transform.names
    tgt = target_character.parameter_transform.names
    if verbose:
        missing = [n for n in tgt if n not in set(src)]
        if missing:
            print(f"map_model_parameters: {len(missing)} unmatched target parameters: "
                  f"{missing[:8]}...")
    return _by_name(motion, src, tgt, 1)


def map_joint_parameters(joint_params, source_character, target_character) -> torch.Tensor:
    """(..., nJ_src*7) joint parameters in the target's joint order, by name."""
    return _by_name(_on_character(joint_params, source_character),
                    source_character.skeleton.joint_names,
                    target_character.skeleton.joint_names, 7)


def model_parameters_to_blend_shape_coefficients(character, model_parameters) -> torch.Tensor:
    if character.blend_shape_param_index is None:
        raise ValueError("character has no blend-shape parameters")
    mp = _on_character(model_parameters, character)
    return mp.index_select(-1, _index(character.blend_shape_param_index, mp.device))


def model_parameters_to_face_expression_coefficients(character,
                                                     model_parameters) -> torch.Tensor:
    if character.face_expression_param_index is None:
        raise ValueError("character has no face-expression parameters")
    mp = _on_character(model_parameters, character)
    return mp.index_select(-1, _index(character.face_expression_param_index, mp.device))


def model_parameters_to_local_skeleton_state(character, model_parameters) -> torch.Tensor:
    """(..., P) → (..., nJ, 8) joint-local skel_states."""
    return fk.local_skel_states(character.skeleton,
                                character.parameter_transform.apply(model_parameters))


def joint_parameters_to_local_skeleton_state(character, joint_parameters) -> torch.Tensor:
    return fk.local_skel_states(character.skeleton, joint_parameters)


def local_skeleton_state_to_joint_parameters(character, local_state) -> torch.Tensor:
    """Local states back to seven parameters a joint (the ZYX extraction)."""
    return joint_parameters_from_local_skel_states(character.skeleton, local_state)


def strip_lower_body_vertices(character, upper_body_root=None):
    """The vertices skinned below the waist dropped, the skeleton kept
    (momentum_geometry.cpp:480-524): the upper body is the spine root's
    ancestor chain and all its descendants."""
    names = character.skeleton.joint_names
    if upper_body_root is None:
        for cand in ("b_spine0", "c_spine0"):
            if cand in names:
                upper_body_root = names.index(cand)
                break
        else:
            spines = [i for i, n in enumerate(names) if "spine" in n.lower()]
            if not spines:
                raise ValueError("no spine joint found; pass upper_body_root")
            upper_body_root = min(spines)
    parent = character.skeleton.parents_np
    nj = len(names)
    keep = np.zeros(nj, bool)
    cur = upper_body_root
    while cur >= 0:
        keep[cur] = True
        cur = parent[cur]
    for j in range(nj):  # the root's descendants
        cur = j
        while cur >= 0 and not (keep[cur] and cur == upper_body_root):
            cur = parent[cur]
        if cur == upper_body_root:
            keep[j] = True
    return reduce_mesh_to_bones(character, np.nonzero(keep)[0])


def strip_joints(character, joint_names):
    """The named joints and everything under them removed
    (character_utility.cpp:758-840 removeJoints); an unknown name raises."""
    from momentum_tpu_torch.character.utility import remove_joints

    names = character.skeleton.joint_names
    for j in joint_names:
        if isinstance(j, str) and j not in names:
            raise ValueError(f"joint '{j}' not in skeleton")
    return remove_joints(character, joint_names)


def replace_skeleton_hierarchy(source_character, target_character, source_root, target_root):
    """See character.utility.replace_skeleton_hierarchy."""
    from momentum_tpu_torch.character.utility import replace_skeleton_hierarchy as impl

    return impl(source_character, target_character, source_root, target_root)


def reduce_mesh_by_faces(character, active_faces):
    from momentum_tpu_torch.character.utility import reduce_mesh_by_faces as impl

    return impl(character, active_faces)


def reduce_mesh_by_vertices(character, active_vertices):
    from momentum_tpu_torch.character.utility import reduce_mesh_by_vertices as impl

    return impl(character, active_vertices)


def classify_triangles_by_texture(*args, **kwargs):
    """See character.texture_classification.classify_triangles_by_texture."""
    from momentum_tpu_torch.character.texture_classification import (
        classify_triangles_by_texture as impl)

    return impl(*args, **kwargs)


def split_mesh_by_texture_region(*args, **kwargs):
    """See character.texture_classification.split_mesh_by_texture_region."""
    from momentum_tpu_torch.character.texture_classification import (
        split_mesh_by_texture_region as impl)

    return impl(*args, **kwargs)


def load_markers(path, main_subject_only=True, up="y"):
    """pymomentum.geometry.load_markers (geometry_pybind.cpp:970): one
    io.RawMarkerData a subject; `.to_marker_sequence()` puts one on the
    card."""
    from momentum_tpu_torch.io.markers import load_markers as _impl

    return _impl(path, main_subject_only=main_subject_only, up=up)


def load_markers_from_bytes(data, format, main_subject_only=True, up="y"):
    """pymomentum.geometry.load_markers_from_bytes."""
    from momentum_tpu_torch.io.markers import load_markers_from_bytes as _impl

    return _impl(data, format, main_subject_only=main_subject_only, up=up)


def load_motion(gltf_filename):
    """pymomentum.geometry.load_motion: motion-only GLB read →
    (motion, parameter_names, identity, joint_names) as numpy."""
    from momentum_tpu_torch.io.gltf import load_motion_glb

    return load_motion_glb(gltf_filename)


def is_fbxsdk_available() -> bool:
    """pymomentum.geometry.is_fbxsdk_available: True, as momentum_tpu's (it
    ships its own FBX writer)."""
    return True
