"""Shared JSON schema for per-joint physical mass bodies.

Reference: momentum/io/common/json_utils.cpp:310-374 — one object per body:
{"mass": float, "centerOfMass": [x,y,z], "inertia": {ixx,ixy,ixz,iyy,iyz,izz},
 "inertiaRotation": [w,x,y,z]}. Used by GLB node extensions
(gltf_builder.cpp:751), FBX custom string properties
(openfbx_loader.cpp:138-143), and USD momentum:physicalProperties attributes
(usd_io.cpp:241+).
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["body_to_json", "body_from_json", "rows_to_physical_properties",
           "physical_properties_by_joint"]


def body_to_json(mass, com, inertia, quat_xyzw) -> dict:
    """One body → the reference JSON object (quaternion stored [w,x,y,z],
    normalized in float64)."""
    q = np.asarray(to_host(quat_xyzw), np.float64)
    q = q / max(float(np.linalg.norm(q)), 1e-30)
    inertia = to_host(inertia)
    return {
        "mass": float(mass),
        "centerOfMass": [float(x) for x in to_host(com)],
        "inertia": {"ixx": float(inertia[0, 0]), "ixy": float(inertia[0, 1]),
                    "ixz": float(inertia[0, 2]), "iyy": float(inertia[1, 1]),
                    "iyz": float(inertia[1, 2]), "izz": float(inertia[2, 2])},
        "inertiaRotation": [float(q[3]), float(q[0]), float(q[1]), float(q[2])],
    }


def body_from_json(j: dict):
    """JSON object → (mass, com(3,), inertia(3,3), quat_xyzw(4,)) numpy."""
    inj = j.get("inertia", {})
    inertia = np.array(
        [[inj.get("ixx", 0.0), inj.get("ixy", 0.0), inj.get("ixz", 0.0)],
         [inj.get("ixy", 0.0), inj.get("iyy", 0.0), inj.get("iyz", 0.0)],
         [inj.get("ixz", 0.0), inj.get("iyz", 0.0), inj.get("izz", 0.0)]],
        np.float32)
    qwxyz = j.get("inertiaRotation", [1.0, 0.0, 0.0, 0.0])
    return (float(j.get("mass", 0.0)),
            np.asarray(j.get("centerOfMass", [0.0, 0.0, 0.0]), np.float32),
            inertia,
            np.asarray([qwxyz[1], qwxyz[2], qwxyz[3], qwxyz[0]], np.float32))


def physical_properties_by_joint(character) -> dict:
    """{joint index: body JSON} of the character's bodies (empty without)."""
    pp = character.physical_properties
    if pp is None:
        return {}
    pj, pm, pc, pi, pq = (to_host(a) for a in (pp.joint_index, pp.mass,
                                               pp.center_of_mass_offset, pp.inertia,
                                               pp.inertia_rotation))
    return {int(pj[b]): body_to_json(pm[b], pc[b], pi[b], pq[b]) for b in range(pp.num_bodies)}


def rows_to_physical_properties(rows, device="cuda"):
    """rows of (joint_index, mass, com, inertia, quat_xyzw, joint_name) →
    PhysicalProperties on `device` (None when empty)."""
    from momentum_tpu_torch.character import PhysicalProperties

    if not rows:
        return None
    device = resolve(device, "rows_to_physical_properties")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PhysicalProperties(
        joint_index=t([r[0] for r in rows], torch.int32),
        mass=t(np.asarray([r[1] for r in rows], np.float32)),
        center_of_mass_offset=t(np.stack([np.asarray(r[2], np.float32) for r in rows])),
        inertia=t(np.stack([np.asarray(r[3], np.float32) for r in rows])),
        inertia_rotation=t(np.stack([np.asarray(r[4], np.float32) for r in rows])),
        joint_names=tuple(r[5] for r in rows),
    )
