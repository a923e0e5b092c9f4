"""A CMU/Vicon 41-marker-set humanoid for tracking marker clips without a
model asset, after momentum_tpu/tracking/cmu.py: a body-scale rig (mm, z-up,
the C3D convention of the CMU takes) whose locators carry the standard Vicon
marker names, so `calibrate_model` can estimate the scale and the locator
offsets from a clip and `track_poses_per_frame` can track it. The joint and
marker tables are this package's own copies of the JAX module's.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.character import (
    Character, Locators, ParameterTransform, make_limits, make_skeleton)
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT
from momentum_tpu_torch.device import resolve

__all__ = ["create_cmu_character", "CMU_MARKER_MAP"]

# joint name -> (parent name, local translation offset in mm, z-up, x-left)
_JOINTS = [
    ("root", None, (0.0, 0.0, 0.0)),
    ("spine", "root", (0.0, 0.0, 100.0)),
    ("chest", "spine", (0.0, 0.0, 180.0)),
    ("neck", "chest", (0.0, 0.0, 200.0)),
    ("head", "neck", (0.0, 0.0, 130.0)),
    ("l_clav", "chest", (30.0, 0.0, 160.0)),
    ("l_sho", "l_clav", (150.0, 0.0, 0.0)),
    ("l_elb", "l_sho", (0.0, 0.0, -280.0)),
    ("l_wri", "l_elb", (0.0, 0.0, -250.0)),
    ("l_hand", "l_wri", (0.0, 0.0, -80.0)),
    ("r_clav", "chest", (-30.0, 0.0, 160.0)),
    ("r_sho", "r_clav", (-150.0, 0.0, 0.0)),
    ("r_elb", "r_sho", (0.0, 0.0, -280.0)),
    ("r_wri", "r_elb", (0.0, 0.0, -250.0)),
    ("r_hand", "r_wri", (0.0, 0.0, -80.0)),
    ("l_hip", "root", (95.0, 0.0, -60.0)),
    ("l_knee", "l_hip", (0.0, 0.0, -420.0)),
    ("l_ank", "l_knee", (0.0, 0.0, -430.0)),
    ("l_toe", "l_ank", (0.0, 140.0, -70.0)),
    ("r_hip", "root", (-95.0, 0.0, -60.0)),
    ("r_knee", "r_hip", (0.0, 0.0, -420.0)),
    ("r_ank", "r_knee", (0.0, 0.0, -430.0)),
    ("r_toe", "r_ank", (0.0, 140.0, -70.0)),
]

# Vicon/CMU marker name -> (joint, rough local offset in mm). Offsets are
# starting points; calibrate_locators refines them against the clip.
CMU_MARKER_MAP = {
    "LFWT": ("root", (110.0, 90.0, 0.0)),
    "RFWT": ("root", (-110.0, 90.0, 0.0)),
    "LBWT": ("root", (70.0, -110.0, 20.0)),
    "RBWT": ("root", (-70.0, -110.0, 20.0)),
    "STRN": ("chest", (0.0, 100.0, 0.0)),
    "T10": ("spine", (0.0, -110.0, 60.0)),
    "CLAV": ("chest", (0.0, 90.0, 170.0)),
    "C7": ("chest", (0.0, -100.0, 190.0)),
    "RBAC": ("chest", (-90.0, -110.0, 120.0)),
    "LFHD": ("head", (60.0, 90.0, 60.0)),
    "RFHD": ("head", (-60.0, 90.0, 60.0)),
    "LBHD": ("head", (60.0, -70.0, 60.0)),
    "RBHD": ("head", (-60.0, -70.0, 60.0)),
    "LSHO": ("l_sho", (20.0, 0.0, 40.0)),
    "LUPA": ("l_sho", (40.0, 0.0, -140.0)),
    "LELB": ("l_elb", (40.0, 0.0, 0.0)),
    "LFRM": ("l_elb", (40.0, 0.0, -120.0)),
    "LWRA": ("l_wri", (30.0, 30.0, 0.0)),
    "LWRB": ("l_wri", (30.0, -30.0, 0.0)),
    "LFIN": ("l_hand", (10.0, 0.0, -40.0)),
    "RSHO": ("r_sho", (-20.0, 0.0, 40.0)),
    "RUPA": ("r_sho", (-40.0, 0.0, -140.0)),
    "RELB": ("r_elb", (-40.0, 0.0, 0.0)),
    "RFRM": ("r_elb", (-40.0, 0.0, -120.0)),
    "RWRA": ("r_wri", (-30.0, 30.0, 0.0)),
    "RWRB": ("r_wri", (-30.0, -30.0, 0.0)),
    "RFIN": ("r_hand", (-10.0, 0.0, -40.0)),
    "LTHI": ("l_hip", (70.0, 30.0, -200.0)),
    "LKNE": ("l_knee", (60.0, 0.0, 0.0)),
    "LSHN": ("l_knee", (40.0, 30.0, -200.0)),
    "LANK": ("l_ank", (50.0, 0.0, 10.0)),
    "LHEE": ("l_ank", (0.0, -60.0, -30.0)),
    "LTOE": ("l_toe", (0.0, 60.0, -20.0)),
    "LMT5": ("l_toe", (50.0, 10.0, -20.0)),
    "RTHI": ("r_hip", (-70.0, 30.0, -200.0)),
    "RKNE": ("r_knee", (-60.0, 0.0, 0.0)),
    "RSHN": ("r_knee", (-40.0, 30.0, -200.0)),
    "RANK": ("r_ank", (-50.0, 0.0, 10.0)),
    "RHEE": ("r_ank", (0.0, -60.0, -30.0)),
    "RTOE": ("r_toe", (0.0, 60.0, -20.0)),
    "RMT5": ("r_toe", (-50.0, 10.0, -20.0)),
}


def create_cmu_character(dtype=torch.float32, device="cuda") -> Character:
    """Humanoid rig (23 joints, mm, z-up) with the CMU 41-marker locator set,
    on `device` (the card unless the caller asks for the CPU).

    Parameters: root tx/ty/tz (mm) and rx/ry/rz, scale_global (log2), and 3
    rotations per non-root joint (73 in all); the "scaling" set holds
    scale_global; no limits."""
    device = resolve(device, "create_cmu_character")
    names = [j[0] for j in _JOINTS]
    index = {n: i for i, n in enumerate(names)}
    parents = [-1 if j[1] is None else index[j[1]] for j in _JOINTS]
    offsets = np.asarray([j[2] for j in _JOINTS], np.float64)
    skeleton = make_skeleton(parents, translation_offsets=offsets, names=names, dtype=dtype,
                             device=device)
    nj = len(names)

    pnames = ["root_tx", "root_ty", "root_tz", "root_rx", "root_ry", "root_rz",
              "scale_global"]
    rows = [(i, i, 1.0) for i in range(6)]
    rows.append((6, 6, 1.0))  # root scale <- scale_global
    for j in range(1, nj):
        for k, axis in enumerate("xyz"):
            pnames.append(f"{names[j]}_r{axis}")
            rows.append((j * PARAMS_PER_JOINT + 3 + k, len(pnames) - 1, 1.0))
    mat = np.zeros((nj * PARAMS_PER_JOINT, len(pnames)), np.float64)
    for r, c, v in rows:
        mat[r, c] = v
    pt = ParameterTransform(
        transform=torch.as_tensor(mat, dtype=dtype, device=device),
        offsets=torch.zeros(nj * PARAMS_PER_JOINT, dtype=dtype, device=device),
        names=tuple(pnames), parameter_sets={"scaling": (6,)})

    mnames = tuple(CMU_MARKER_MAP.keys())
    loc_parent = np.asarray([index[CMU_MARKER_MAP[m][0]] for m in mnames], np.int32)
    loc_offset = np.asarray([CMU_MARKER_MAP[m][1] for m in mnames], np.float64)
    locators = Locators(parent=torch.as_tensor(loc_parent, device=device),
                        offset=torch.as_tensor(loc_offset, dtype=dtype, device=device),
                        weight=torch.ones(len(mnames), dtype=dtype, device=device),
                        names=mnames)
    return Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(device=device), locators=locators,
                     name="cmu_41_marker_humanoid")
