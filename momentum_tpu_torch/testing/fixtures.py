"""The full-body synthetic rig of momentum_tpu/testing/fixtures.py::
create_fullbody_character, rebuilt from the same numpy arithmetic so the
skeleton, parameter transform, limits and locators are bit-equal to the JAX
fixture's. Its mesh and skinning come with ROADMAP M4.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.character import (
    Character, Locators, ParameterTransform, make_limits, make_skeleton)
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT

__all__ = ["create_fullbody_character"]


def create_fullbody_character(dtype=torch.float32, device=None) -> Character:
    """51 joints in a humanoid tree (spine/neck/head, clavicle/arm/hand and
    hip/leg/foot chains per side), root translation + rotation, global scale
    and 3 rotation parameters per non-root joint (157 parameters), 80
    locators, MinMax limits on every rotation parameter and the scale."""
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

    mm = [(6, -0.5, 0.5, 1.0)] + [(i, -1.2, 1.2, 1.0) for i in range(7, len(pnames))]
    return Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(minmax=mm, device=device),
                     locators=locators, name="fullbody_synthetic")
