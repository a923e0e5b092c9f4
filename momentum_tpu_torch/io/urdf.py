"""URDF robot-model import.

Reference: momentum/io/urdf/urdf_io.{h,cpp} — builds a momentum character
from a URDF link/joint tree: each URDF joint becomes a momentum joint whose
preRotation comes from the origin rpy and translationOffset from origin xyz;
revolute/continuous/prismatic joints contribute one model parameter each,
driving the joint parameter that matches the motion axis. Arbitrary
(non-axis-aligned) axes are handled by folding an axis-alignment rotation
into the preRotation so the motion happens about the local X axis (the
reference performs the same alignment). Joint limits become MinMax parameter
limits. Link <inertial> elements become per-joint PhysicalProperties bodies
(urdf_io.cpp:93-111); lengths are kept in the URDF's own units, consistent
with this loader's handling of link origins.

The XML is parsed on the host; the character, its limits and bodies are
built on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["load_urdf"]


def _rpy_to_quat(rpy):
    """URDF rpy = extrinsic XYZ = Rz(y)·Ry(p)·Rx(r) (xyzw quaternion)."""
    r, p, y = rpy

    def axis_q(angle, axis):
        q = [0.0, 0.0, 0.0, math.cos(angle / 2)]
        q[axis] = math.sin(angle / 2)
        return np.asarray(q)

    def qmul(a, b):
        x1, y1, z1, w1 = a
        x2, y2, z2, w2 = b
        return np.asarray([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])

    return qmul(axis_q(y, 2), qmul(axis_q(p, 1), axis_q(r, 0)))


def _align_x_to(axis):
    """Quaternion rotating local +X onto `axis` (unit)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x = np.asarray([1.0, 0.0, 0.0])
    c = np.cross(x, axis)
    d = float(np.dot(x, axis))
    if d > 1.0 - 1e-9:
        return np.asarray([0.0, 0.0, 0.0, 1.0])
    if d < -1.0 + 1e-9:
        return np.asarray([0.0, 0.0, 1.0, 0.0])  # 180° about z
    q = np.asarray([c[0], c[1], c[2], 1.0 + d])
    return q / np.linalg.norm(q)


def _floats(s, default):
    if s is None:
        return list(default)
    return [float(x) for x in s.split()]


def load_urdf(source, device="cuda"):
    """→ Character with its ParameterLimits attached, on `device` (the card
    unless the caller asks for the CPU). `source` = path or XML string."""
    from momentum_tpu_torch.character import Character, make_limits, make_skeleton
    from momentum_tpu_torch.character.parameter_transform import ParameterTransform
    from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT
    from momentum_tpu_torch.io._physical import rows_to_physical_properties

    device = resolve(device, "load_urdf")

    text = source
    if not str(source).lstrip().startswith("<"):
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)

    links = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")
    child_of = {}
    for j in joints:
        child = j.find("child").get("link")
        child_of[child] = j
    root_links = [n for n in links if n not in child_of]
    if not root_links:
        raise ValueError("URDF has no root link")

    # momentum joint per link, in topological order from the root(s)
    order = []
    children = {}
    for j in joints:
        children.setdefault(j.find("parent").get("link"), []).append(j)

    names, parents, pre, offs = [], [], [], []
    triplets = []  # (row, param_index, weight)
    param_names = []
    limit_rows = []
    name_to_idx = {}
    phys_rows = []  # per-link <inertial> bodies (urdf_io.cpp:93-111)

    def _parse_inertial(link_name, idx):
        link = links.get(link_name)
        inertial = link.find("inertial") if link is not None else None
        if inertial is None:
            return
        mass_el = inertial.find("mass")
        mass = float(mass_el.get("value", "0")) if mass_el is not None else 0.0
        if mass <= 0.0:
            return
        origin = inertial.find("origin")
        com = _floats(origin.get("xyz") if origin is not None else None, (0, 0, 0))
        rpy = _floats(origin.get("rpy") if origin is not None else None, (0, 0, 0))
        ine = inertial.find("inertia")

        def g(k):
            return float(ine.get(k, "0")) if ine is not None else 0.0

        m = np.asarray([[g("ixx"), g("ixy"), g("ixz")],
                        [g("ixy"), g("iyy"), g("iyz")],
                        [g("ixz"), g("iyz"), g("izz")]], np.float32)
        phys_rows.append((idx, mass, com, m, list(_rpy_to_quat(rpy)), link_name))

    def visit(link_name, parent_idx, jelem):
        idx = len(names)
        names.append(link_name)
        name_to_idx[link_name] = idx
        parents.append(parent_idx)
        _parse_inertial(link_name, idx)
        if jelem is None:
            pre.append([0.0, 0.0, 0.0, 1.0])
            offs.append([0.0, 0.0, 0.0])
        else:
            origin = jelem.find("origin")
            xyz = _floats(origin.get("xyz") if origin is not None else None, (0, 0, 0))
            rpy = _floats(origin.get("rpy") if origin is not None else None, (0, 0, 0))
            q = _rpy_to_quat(rpy)
            jtype = jelem.get("type", "fixed")
            if jtype in ("revolute", "continuous", "prismatic"):
                axis_el = jelem.find("axis")
                axis = _floats(axis_el.get("xyz") if axis_el is not None else None,
                               (1, 0, 0))
                q_align = _align_x_to(axis)
                # fold axis alignment into the pre-rotation: motion about local X
                x1, y1, z1, w1 = q
                x2, y2, z2, w2 = q_align
                q = np.asarray([
                    w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                    w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                    w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                ])
                pname = jelem.get("name")
                pidx = len(param_names)
                param_names.append(pname)
                attr = 3 if jtype in ("revolute", "continuous") else 0  # rx or tx
                triplets.append((idx * PARAMS_PER_JOINT + attr, pidx, 1.0))
                lim = jelem.find("limit")
                if lim is not None and jtype != "continuous":
                    lo = float(lim.get("lower", "0"))
                    hi = float(lim.get("upper", "0"))
                    limit_rows.append((pidx, lo, hi, 1.0))
            pre.append(list(q))
            offs.append(xyz)
        for cj in children.get(link_name, []):
            visit(cj.find("child").get("link"), idx, cj)

    for rl in root_links:
        visit(rl, -1, None)

    n_jp = len(names) * PARAMS_PER_JOINT
    mat = np.zeros((n_jp, len(param_names)), np.float32)
    for r, c, v in triplets:
        mat[r, c] = v
    skeleton = make_skeleton(parents, np.asarray(pre), np.asarray(offs), names, device=device)
    pt = ParameterTransform(
        transform=torch.as_tensor(mat, device=device),
        offsets=torch.zeros(n_jp, dtype=torch.float32, device=device),
        names=tuple(param_names),
    )
    return Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(minmax=limit_rows, device=device),
                     physical_properties=rows_to_physical_properties(phys_rows, device),
                     name=root.get("name", ""))
