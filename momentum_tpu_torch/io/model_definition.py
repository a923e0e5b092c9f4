"""Momentum sectioned-text model definitions (.model / .cfg).

Reference: momentum/io/skeleton/parameter_transform_io.cpp +
parameter_limits_io.cpp. File layout (loadMomentumModelCommon,
parameter_transform_io.cpp:47-110): `[Section]` headers with the known
sections ParameterTransform / ParameterSets / PoseConstraints /
ParameterLimits; `#` comments.

Grammar:
  [ParameterTransform]   (parameter_transform_io.cpp:288-360,164-250)
    <joint>.<attr> = w1 * param1 + w2 * param2 + ...
    attr ∈ {tx,ty,tz,rx,ry,rz,sc} (kJointParameterNames, character/types.h:24).
    A bare number sets the constant offset; a term referencing
    <joint2>.<attr2> copies that joint-parameter's existing terms scaled by w.
    New parameter names are appended in first-appearance order.
  [ParameterSets]        (:389-443)
    parameterset <name> <param> <param> ...
  [PoseConstraints]      (:460-...)
    poseconstraint <name> <param> <value> ... — stored as (index, value) lists
  [ParameterLimits]      (parameter_limits_io.cpp:297-640)
    limit <param> minmax [lo, hi] <w?>
    limit <joint>.<attr> minmax [lo, hi] <w?>          (MinMaxJoint)
    limit <joint>.<attr> minmax_passive [lo, hi] <w?>
    limit <param> linear <param2> [s, o, end]... [s, o] <w?>  (piecewise)
    limit <joint>.<attr> linear <joint2>.<attr2> [...]        (LinearJoint)
    limit <p1> halfplane <p2> [nx, ny] offset <w?>
    limit <joint> ellipsoid [offset3] <parent> [t3] [eulerZYX3(deg)] [s3] <w?>

Each table is built on the device of the skeleton it is parsed against.
"""

from __future__ import annotations

import io as _io
import math
import re

import numpy as np
import torch

from momentum_tpu_torch.character.limits import ParameterLimits, make_limits
from momentum_tpu_torch.character.parameter_transform import ParameterTransform
from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT, Skeleton
from momentum_tpu_torch.device import to_host

__all__ = [
    "JOINT_PARAMETER_NAMES",
    "load_momentum_model",
    "parse_parameter_transform",
    "parse_parameter_sets",
    "parse_pose_constraints",
    "parse_parameter_limits",
    "load_model_definition",
    "write_model_definition",
]

JOINT_PARAMETER_NAMES = ("tx", "ty", "tz", "rx", "ry", "rz", "sc")

_SECTIONS = ("ParameterTransform", "ParameterSets", "PoseConstraints", "ParameterLimits")


def load_momentum_model(source) -> dict:
    """Split a sectioned model file into {section_name: text}
    (loadMomentumModel, parameter_transform_io.cpp:255-270). `source` is a
    path, a file object or the text itself."""
    if hasattr(source, "read"):
        text = source.read()
    else:
        try:
            with open(source, "r") as f:
                text = f.read()
        except (OSError, ValueError):
            text = str(source)
    sections: dict[str, list[str]] = {}
    current = None
    header = re.compile(r"^\[(\w+)\]\s*$")
    for line in text.splitlines():
        m = header.match(line.strip())
        if m:
            name = m.group(1)
            current = name if name in _SECTIONS else None
            if current is not None:
                sections.setdefault(current, [])
            continue
        if current is not None:
            sections[current].append(line)
    return {k: "\n".join(v) for k, v in sections.items()}


def _strip(line: str) -> str:
    return line.split("#", 1)[0].strip()


def parse_parameter_transform(text: str, skeleton: Skeleton) -> ParameterTransform:
    n_jp = skeleton.num_joints * PARAMS_PER_JOINT
    names: list[str] = []
    triplets: list[tuple[int, int, float]] = []
    offsets = np.zeros(n_jp, np.float64)

    joint_idx = {n: i for i, n in enumerate(skeleton.joint_names)}
    attr_idx = {n: i for i, n in enumerate(JOINT_PARAMETER_NAMES)}

    for raw in text.splitlines():
        line = _strip(raw)
        if not line or "=" not in line:
            continue
        lhs, rhs = (s.strip() for s in line.split("=", 1))
        if "." not in lhs:
            raise ValueError(f"bad channel expression: {line}")
        jname, aname = (s.strip() for s in lhs.split(".", 1))
        if jname not in joint_idx:
            raise ValueError(f"unknown joint {jname!r} in: {line}")
        if aname not in attr_idx:
            raise ValueError(f"unknown channel {aname!r} in: {line}")
        row = joint_idx[jname] * PARAMS_PER_JOINT + attr_idx[aname]

        for term in rhs.split("+"):
            factors = [t.strip() for t in term.split("*")]
            if len(factors) == 1:
                if factors[0]:
                    offsets[row] = float(factors[0])
                continue
            if len(factors) != 2:
                continue
            weight = float(factors[0])
            pname = factors[1]
            # joint-parameter reference: copy referenced rows scaled
            ref_j = pname.split(".", 1)[0]
            if pname not in names and ref_j in joint_idx and "." in pname:
                ref_a = pname.split(".", 1)[1]
                if ref_a in attr_idx:
                    ref_row = joint_idx[ref_j] * PARAMS_PER_JOINT + attr_idx[ref_a]
                    triplets.extend(
                        (row, c, v * weight) for (r, c, v) in list(triplets) if r == ref_row)
                    continue
            if pname not in names:
                names.append(pname)
            triplets.append((row, names.index(pname), weight))

    mat = np.zeros((n_jp, len(names)), np.float64)
    for r, c, v in triplets:
        mat[r, c] += v
    device = skeleton.joint_parent.device
    return ParameterTransform(
        transform=torch.as_tensor(mat.astype(np.float32), device=device),
        offsets=torch.as_tensor(offsets.astype(np.float32), device=device),
        names=tuple(names),
    )


def parse_parameter_sets(text: str, pt: ParameterTransform) -> dict:
    result = {}
    name_idx = {n: i for i, n in enumerate(pt.names)}
    for raw in text.splitlines():
        line = _strip(raw)
        if not line or not line.startswith("parameterset"):
            continue
        toks = line.split()
        if len(toks) < 2:
            raise ValueError(f"bad parameterset line: {line}")
        idx = []
        for p in toks[2:]:
            if p not in name_idx:
                raise ValueError(f"unknown parameter {p!r} in parameterset {toks[1]}")
            idx.append(name_idx[p])
        result[toks[1]] = tuple(idx)
    return result


def parse_pose_constraints(text: str, pt: ParameterTransform) -> dict:
    """poseconstraint <name> <param> <value> ... → {name: ((idx, val), ...)}"""
    result = {}
    name_idx = {n: i for i, n in enumerate(pt.names)}
    for raw in text.splitlines():
        line = _strip(raw)
        if not line or not line.startswith("poseconstraint"):
            continue
        toks = line.split()
        result[toks[1]] = tuple((name_idx[toks[i]], float(toks[i + 1]))
                                for i in range(2, len(toks) - 1, 2))
    return result


class _Tok:
    """Bracket-vector tokenizer matching the reference's Tokenizer
    (parameter_limits_io.cpp)."""

    def __init__(self, s: str):
        self.toks = re.findall(r"\[|\]|,|[^\s\[\],]+", s)
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.toks)

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def ident(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def number(self) -> float:
        return float(self.ident())

    def vec(self):
        if self.ident() != "[":
            raise ValueError(f"expected '[' in: {' '.join(self.toks)}")
        out = []
        while self.peek() != "]":
            t = self.ident()
            if t != ",":
                out.append(float(t))
        self.ident()  # ]
        return out


def _euler_zyx_deg_matrix(euler_zyx_deg):
    """Rotation from the file's [z, y, x] degree triple
    (parameter_limits_io.cpp:602-605: extrinsic XYZ of (rad(z), rad(y), rad(x))
    reversed — net effect Rz(z)·Ry(y)·Rx(x))."""
    z, y, x = (math.radians(v) for v in euler_zyx_deg)
    cz, sz = math.cos(z), math.sin(z)
    cy, sy = math.cos(y), math.sin(y)
    cx, sx = math.cos(x), math.sin(x)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return rz @ ry @ rx


def parse_parameter_limits(text: str, skeleton: Skeleton,
                           pt: ParameterTransform) -> ParameterLimits:
    name_idx = {n: i for i, n in enumerate(pt.names)}
    joint_idx = {n: i for i, n in enumerate(skeleton.joint_names)}
    attr_idx = {n: i for i, n in enumerate(JOINT_PARAMETER_NAMES)}
    inf = float("inf")

    minmax, minmax_joint, linear, linear_joint, halfplane, ellipsoid = [], [], [], [], [], []

    def jp_flat(name):
        j, a = name.split(".", 1)
        return joint_idx[j], attr_idx[a]

    for raw in text.splitlines():
        line = _strip(raw)
        if not line or not line.startswith("limit"):
            continue
        tok = _Tok(line)
        tok.ident()  # "limit"
        pname = tok.ident()
        typ = tok.ident()
        if typ == "minmax":
            lo, hi = tok.vec()
            w = tok.number() if not tok.eof() else 1.0
            if "." in pname:
                j, a = jp_flat(pname)
                minmax_joint.append((j, a, lo, hi, w, 0.0))
            else:
                minmax.append((name_idx[pname], lo, hi, w))
        elif typ == "minmax_passive":
            lo, hi = tok.vec()
            w = tok.number() if not tok.eof() else 1.0
            j, a = jp_flat(pname)
            minmax_joint.append((j, a, lo, hi, w, 1.0))
        elif typ == "linear":
            tgt = tok.ident()
            segs = []
            while tok.peek() == "[":
                segs.append(tok.vec())
            w = tok.number() if not tok.eof() else 1.0
            prev_end = -inf
            rows = []
            for s in segs:
                end = s[2] if len(s) == 3 else inf
                rows.append((s[0], s[1], prev_end, end))
                prev_end = end
            if "." in pname:
                rj, ra = jp_flat(pname)
                tj, ta = jp_flat(tgt)
                for sc, off, rmin, rmax in rows:
                    linear_joint.append((rj * 7 + ra, tj * 7 + ta, sc, off, rmin, rmax, w))
            else:
                for sc, off, rmin, rmax in rows:
                    linear.append((name_idx[pname], name_idx[tgt], sc, off, rmin, rmax, w))
        elif typ == "halfplane":
            p2 = tok.ident()
            nx, ny = tok.vec()
            off = tok.number()
            w = tok.number() if not tok.eof() else 1.0
            norm = math.hypot(nx, ny)
            halfplane.append((name_idx[pname], name_idx[p2], nx / norm, ny / norm, off / norm, w))
        elif typ in ("ellipsoid", "elipsoid"):
            offset3 = tok.vec()
            eparent = tok.ident()
            t3 = tok.vec()
            euler3 = tok.vec()
            s3 = tok.vec()
            w = tok.number() if not tok.eof() else 1.0
            mat = np.eye(4)
            mat[:3, :3] = _euler_zyx_deg_matrix(euler3) @ np.diag(s3)
            mat[:3, 3] = t3
            ellipsoid.append((joint_idx[pname], joint_idx[eparent], offset3, mat, w))
        else:
            raise ValueError(f"unknown limit type {typ!r} in: {line}")

    return make_limits(minmax=minmax, minmax_joint=minmax_joint, linear=linear,
                       linear_joint=linear_joint, halfplane=halfplane, ellipsoid=ellipsoid,
                       device=skeleton.joint_parent.device)


def load_model_definition(source, skeleton: Skeleton):
    """(ParameterTransform, ParameterLimits) from a .model/.cfg file or text
    (loadModelDefinition, parameter_transform_io.cpp:125-162), on the
    skeleton's device."""
    sections = load_momentum_model(source)
    pt = parse_parameter_transform(sections.get("ParameterTransform", ""), skeleton)
    psets = parse_parameter_sets(sections.get("ParameterSets", ""), pt)
    pcons = parse_pose_constraints(sections.get("PoseConstraints", ""), pt)
    if psets or pcons:
        pt = ParameterTransform(transform=pt.transform, offsets=pt.offsets, names=pt.names,
                                parameter_sets=psets, pose_constraints=pcons)
    limits = parse_parameter_limits(sections.get("ParameterLimits", ""), skeleton, pt)
    return pt, limits


def write_model_definition(pt: ParameterTransform, skeleton: Skeleton,
                           limits: ParameterLimits | None = None) -> str:
    """Serialize back to the sectioned text format (writeParameterLimits /
    the transform writer in parameter_transform_io.cpp)."""
    out = _io.StringIO()
    out.write("Momentum Model Definition V1.0\n\n[ParameterTransform]\n")
    mat = to_host(pt.transform)
    offs = to_host(pt.offsets)
    for row in range(mat.shape[0]):
        j, a = divmod(row, PARAMS_PER_JOINT)
        terms = [f"{mat[row, c]:g} * {pt.names[c]}" for c in np.nonzero(mat[row])[0]]
        if offs[row] != 0:
            terms.append(f"{offs[row]:g}")
        if terms:
            out.write(f"{skeleton.joint_names[j]}.{JOINT_PARAMETER_NAMES[a]} = "
                      + " + ".join(terms) + "\n")
    if pt.parameter_sets:
        out.write("\n[ParameterSets]\n")
        for name, idx in pt.parameter_sets.items():
            out.write(f"parameterset {name} " + " ".join(pt.names[i] for i in idx) + "\n")
    if limits is not None:
        out.write("\n[ParameterLimits]\n")
        mm, mm_b, mm_w = (to_host(a) for a in (limits.minmax_index, limits.minmax_bounds,
                                               limits.minmax_weight))
        for i in range(mm.shape[0]):
            lo, hi = mm_b[i]
            out.write(f"limit {pt.names[int(mm[i])]} minmax [{lo:g}, {hi:g}] "
                      f"{float(mm_w[i]):g}\n")
        mj, mj_b, mj_w, mj_p = (to_host(a) for a in (
            limits.minmax_joint_index, limits.minmax_joint_bounds,
            limits.minmax_joint_weight, limits.minmax_joint_passive))
        for i in range(mj.shape[0]):
            j, a = divmod(int(mj[i]), PARAMS_PER_JOINT)
            lo, hi = mj_b[i]
            kind = "minmax_passive" if float(mj_p[i]) > 0 else "minmax"
            out.write(f"limit {skeleton.joint_names[j]}.{JOINT_PARAMETER_NAMES[a]} "
                      f"{kind} [{lo:g}, {hi:g}] {float(mj_w[i]):g}\n")
    return out.getvalue()
