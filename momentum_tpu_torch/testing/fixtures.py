"""The synthetic rigs of momentum_tpu/testing/fixtures.py, rebuilt from the
same numpy arithmetic so the skeleton, parameter transform, limits,
locators, skinned mesh and inverse bind pose are bit-equal to the JAX
fixtures': `create_test_character` (a chain of joints) and
`create_fullbody_character` (the 51-joint humanoid).
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.character import (
    Character, Locators, Mesh, ParameterTransform, SkinWeights, make_limits, make_skeleton)
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT
from momentum_tpu_torch.device import resolve

__all__ = ["create_test_character", "create_fullbody_character"]


def create_test_character(num_joints: int = 3, dtype=torch.float32,
                          device="cuda") -> Character:
    """A chain of `num_joints` joints 1 apart along +Y: root translation and
    rotation, a global scale, joint 1's x rotation, a shared z rotation of
    joints 1 and 2 at half weight each, and the x rotation of every further
    joint (num_joints + 7 parameters); one locator per joint; a skinned
    ribbon mesh (5 segments per bone, 2 vertices each); a MinMax limit on
    parameter 0; on `device` (the card unless the caller asks for the CPU).
    The JAX fixture's collision capsules are left out: the port's Character
    holds no collision geometry yet."""
    if num_joints < 3:
        raise ValueError("num_joints must be >= 3")
    device = resolve(device, "create_test_character")
    parents = [-1] + list(range(num_joints - 1))
    offsets = np.zeros((num_joints, 3), np.float64)
    offsets[1:, 1] = 1.0
    names = ["root"] + [f"joint{i}" for i in range(1, num_joints)]
    skeleton = make_skeleton(parents, translation_offsets=offsets, names=names, dtype=dtype,
                             device=device)

    pnames = ["root_tx", "root_ty", "root_tz", "root_rx", "root_ry", "root_rz",
              "scale_global", "joint1_rx", "shared_rz"]
    pnames += [f"joint{k}_rx" for k in range(2, num_joints)]
    n_jp = num_joints * PARAMS_PER_JOINT
    mat = np.zeros((n_jp, len(pnames)), np.float64)
    for i in range(6):
        mat[i, i] = 1.0  # root tx..rz
    mat[6, 6] = 1.0  # root scale <- scale_global
    mat[1 * PARAMS_PER_JOINT + 3, 7] = 1.0  # joint1_rx
    mat[1 * PARAMS_PER_JOINT + 5, 8] = 0.5  # shared_rz
    mat[2 * PARAMS_PER_JOINT + 5, 8] = 0.5  # shared_rz
    for k in range(2, num_joints):
        mat[k * PARAMS_PER_JOINT + 3, 9 + k - 2] = 1.0
    pt = ParameterTransform(transform=torch.as_tensor(mat, dtype=dtype, device=device),
                            offsets=torch.zeros(n_jp, dtype=dtype, device=device),
                            names=tuple(pnames))

    rng = np.random.default_rng(10001)
    locators = Locators(
        parent=torch.arange(num_joints, dtype=torch.int32, device=device),
        offset=torch.as_tensor(rng.uniform(-1.0, 1.0, size=(num_joints, 3)), dtype=dtype,
                               device=device),
        weight=torch.ones(num_joints, dtype=dtype, device=device),
        names=tuple(f"l{i}" for i in range(num_joints)))

    # mesh: 5 segments per bone, 2 vertices each, skinned to (bone, next)
    seg_per = 5
    verts, sidx, swgt = [], [], []
    for b in range(num_joints):
        nxt = min(b + 1, num_joints - 1)
        for s in range(seg_per):
            frac = s / seg_per
            for x in (-0.5, 0.5):
                verts.append([x, b + frac, 0.0])
                row_i = np.zeros(8, np.int32)
                row_w = np.zeros(8, np.float32)
                if frac > 0.5 and nxt != b:
                    row_i[0], row_i[1] = nxt, b
                    row_w[0], row_w[1] = frac, 1.0 - frac
                else:
                    row_i[0], row_i[1] = b, nxt
                    row_w[0] = 1.0 - frac if nxt != b else 1.0
                    row_w[1] = frac if nxt != b else 0.0
                sidx.append(row_i)
                swgt.append(row_w)
    faces = []
    for i in range(seg_per * num_joints - 1):
        faces.append([2 * i + 0, 2 * i + 2, 2 * i + 1])
        faces.append([2 * i + 1, 2 * i + 2, 2 * i + 3])
    mesh = Mesh(vertices=torch.as_tensor(np.asarray(verts), dtype=dtype, device=device),
                faces=torch.as_tensor(np.asarray(faces), dtype=torch.int32, device=device))
    skin = SkinWeights(index=torch.as_tensor(np.stack(sidx), device=device),
                       weight=torch.as_tensor(np.stack(swgt), dtype=dtype, device=device))
    char = Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(minmax=[(0, -0.1, 0.1, 1.0)], device=device),
                     locators=locators, name=f"test_character_{num_joints}",
                     mesh=mesh, skin_weights=skin)
    return char.with_inverse_bind_pose()


def create_fullbody_character(dtype=torch.float32, device="cuda") -> Character:
    """51 joints in a humanoid tree (spine/neck/head, clavicle/arm/hand and
    hip/leg/foot chains per side), root translation + rotation, global scale
    and 3 rotation parameters per non-root joint (157 parameters), 80
    locators, MinMax limits on every rotation parameter and the scale, and a
    skinned tube mesh (612 vertices, 612 faces) with its inverse bind pose,
    and the parameter set "scaling" (the global scale), on `device` (the
    card unless the caller asks for the CPU)."""
    device = resolve(device, "create_fullbody_character")
    names = ["root"]
    parents = [-1]
    offsets = [[0.0, 0.0, 0.0]]

    def chain(base_name, parent_idx, count, offset):
        idx = parent_idx
        for i in range(count):
            names.append(f"{base_name}{i}")
            parents.append(idx)
            offsets.append(list(offset))
            idx = len(names) - 1
        return idx

    spine_end = chain("spine", 0, 6, [0.0, 0.25, 0.0])
    neck_end = chain("neck", spine_end, 2, [0.0, 0.12, 0.0])
    chain("head", neck_end, 2, [0.0, 0.15, 0.0])
    for side, sx in (("l", 1.0), ("r", -1.0)):
        clav = chain(f"{side}_clav", spine_end, 1, [sx * 0.1, 0.05, 0.0])
        arm = chain(f"{side}_arm", clav, 4, [sx * 0.28, 0.0, 0.0])
        chain(f"{side}_hand", arm, 7, [sx * 0.06, 0.0, 0.0])
        hip = chain(f"{side}_hip", 0, 1, [sx * 0.12, -0.05, 0.0])
        leg = chain(f"{side}_leg", hip, 4, [0.0, -0.32, 0.0])
        chain(f"{side}_foot", leg, 3, [0.0, -0.08, 0.08])
    nj = len(names)

    skeleton = make_skeleton(parents, translation_offsets=np.asarray(offsets),
                             names=names, dtype=dtype, device=device)

    pnames = ["root_tx", "root_ty", "root_tz", "root_rx", "root_ry", "root_rz",
              "scale_global"]
    mat = np.zeros((nj * PARAMS_PER_JOINT, 7 + 3 * (nj - 1)), np.float64)
    for i in range(7):
        mat[i, i] = 1.0  # root tx..rz, root scale <- scale_global
    for j in range(1, nj):
        for k, axis in enumerate("xyz"):
            pnames.append(f"{names[j]}_r{axis}")
            mat[j * PARAMS_PER_JOINT + 3 + k, len(pnames) - 1] = 1.0
    pt = ParameterTransform(
        transform=torch.as_tensor(mat, dtype=dtype, device=device),
        offsets=torch.zeros(mat.shape[0], dtype=dtype, device=device),
        names=tuple(pnames),
        parameter_sets={"scaling": (6,)},
    )

    rng = np.random.default_rng(20002)
    n_loc = 80
    loc_parent = rng.integers(0, nj, n_loc)
    locators = Locators(
        parent=torch.as_tensor(loc_parent.astype(np.int32), device=device),
        offset=torch.as_tensor(rng.uniform(-0.12, 0.12, (n_loc, 3)), dtype=dtype,
                               device=device),
        weight=torch.ones(n_loc, dtype=dtype, device=device),
        names=tuple(f"m{i}" for i in range(n_loc)),
    )

    # skinned tube mesh: a ring of 6 vertices at each end of every bone,
    # blended between the bone and its parent
    ring = 6
    verts, sidx, swgt = [], [], []
    joint_pos = np.zeros((nj, 3))
    for j in range(1, nj):
        joint_pos[j] = joint_pos[parents[j]] + np.asarray(offsets[j])
    for j in range(nj):
        p_idx = parents[j] if parents[j] >= 0 else j
        for end, (anchor, other, w) in enumerate([(j, p_idx, 1.0), (j, p_idx, 0.6)]):
            center = joint_pos[j] if end == 0 else 0.5 * (joint_pos[j] + joint_pos[p_idx])
            for r in range(ring):
                a = 2 * np.pi * r / ring
                verts.append(center + 0.04 * np.asarray([np.cos(a), 0.0, np.sin(a)]))
                row_i = np.zeros(8, np.int32)
                row_w = np.zeros(8, np.float32)
                row_i[0], row_i[1] = anchor, other
                row_w[0], row_w[1] = w, 1.0 - w
                sidx.append(row_i)
                swgt.append(row_w)
    faces = []
    for j in range(nj):
        base = j * 2 * ring
        for r in range(ring):
            a, b = base + r, base + (r + 1) % ring
            c, d = a + ring, b + ring
            faces.append([a, b, c])
            faces.append([b, d, c])
    mesh = Mesh(vertices=torch.as_tensor(np.asarray(verts), dtype=dtype, device=device),
                faces=torch.as_tensor(np.asarray(faces, np.int32), device=device))
    skin = SkinWeights(index=torch.as_tensor(np.stack(sidx), device=device),
                       weight=torch.as_tensor(np.stack(swgt), dtype=dtype, device=device))

    mm = [(6, -0.5, 0.5, 1.0)] + [(i, -1.2, 1.2, 1.0) for i in range(7, len(pnames))]
    char = Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(minmax=mm, device=device),
                     locators=locators, name="fullbody_synthetic",
                     mesh=mesh, skin_weights=skin)
    return char.with_inverse_bind_pose()
