"""BVH mocap IO (hierarchy + motion).

Reference: momentum/io/bvh/bvh_io.{h,cpp} — loads a BVH skeleton into a
momentum character (one joint per BVH node, channels mapped onto the 7
joint parameters) and the motion as per-frame joint parameters. BVH rotations
are intrinsic in file channel order; momentum joints only support the
ZYX composition, so arbitrary channel orders are converted through a rotation
matrix before extraction (the reference does the same via Euler conversion,
math/utility.h:153-175).

The file is parsed on the host, where the rotations are re-extracted in
float32 as momentum_tpu's does; the loader builds the character and the
motion on `device`, the card unless the caller asks for the CPU. The writer
takes joint parameters on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["load_bvh", "save_bvh"]

_CHANNEL_AXIS = {
    "Xposition": 0, "Yposition": 1, "Zposition": 2,
    "Xrotation": 3, "Yrotation": 4, "Zrotation": 5,
}


def load_bvh(path, dtype=None, device="cuda"):
    """→ (Character, joint_params (F, nJ*7) float32, fps) on `device` (the
    card unless the caller asks for the CPU)."""
    from momentum_tpu_torch.character import Character, make_empty_limits, make_skeleton
    from momentum_tpu_torch.character.parameter_transform import make_identity_transform
    from momentum_tpu_torch.math import euler as eu

    device = resolve(device, "load_bvh")

    with open(path, "r") as f:
        toks = f.read().split()

    pos = 0

    def next_tok():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    names, parents, offsets, channels = [], [], [], []

    def parse_joint(parent):
        nonlocal pos
        kind = next_tok()  # ROOT / JOINT / End
        if kind == "End":
            next_tok()  # Site
            assert next_tok() == "{"
            assert next_tok() == "OFFSET"
            off = [float(next_tok()) for _ in range(3)]
            assert next_tok() == "}"
            names.append(f"{names[parent]}_end")
            parents.append(parent)
            offsets.append(off)
            channels.append([])
            return
        name = next_tok()
        assert next_tok() == "{"
        idx = len(names)
        names.append(name)
        parents.append(parent)
        offsets.append([0.0, 0.0, 0.0])
        channels.append([])
        while True:
            t = next_tok()
            if t == "OFFSET":
                offsets[idx] = [float(next_tok()) for _ in range(3)]
            elif t == "CHANNELS":
                n = int(next_tok())
                channels[idx] = [next_tok() for _ in range(n)]
            elif t in ("JOINT", "End"):
                pos -= 1
                parse_joint(idx)
            elif t == "}":
                return

    assert next_tok() == "HIERARCHY"
    parse_joint(-1)
    assert next_tok() == "MOTION"
    assert next_tok() == "Frames:"
    n_frames = int(next_tok())
    assert next_tok() == "Frame" and next_tok() == "Time:"
    frame_time = float(next_tok())
    values = np.asarray([float(t) for t in toks[pos:]], np.float64)

    nj = len(names)
    skeleton = make_skeleton(parents, translation_offsets=np.asarray(offsets),
                             names=names, device=device)
    total_ch = sum(len(c) for c in channels)
    values = values[: n_frames * total_ch].reshape(n_frames, total_ch)

    jp = np.zeros((n_frames, nj, 7), np.float64)
    col = 0
    for j in range(nj):
        chs = channels[j]
        rot_order = [c[0] for c in chs if c.endswith("rotation")]
        rot_cols = {}
        for c in chs:
            v = values[:, col]
            if c.endswith("position"):
                jp[:, j, _CHANNEL_AXIS[c]] = v
            else:
                rot_cols[c[0]] = np.radians(v)
            col += 1
        if rot_cols:
            # compose rotations in channel order, re-extract as ZYX
            m = np.broadcast_to(np.eye(3), (n_frames, 3, 3)).copy()
            for axis_ch in rot_order:
                ax = {"X": 0, "Y": 1, "Z": 2}[axis_ch]
                ang = rot_cols[axis_ch]
                m = np.einsum("fij,fjk->fik", m, _axis_mats(ang, ax))
            zyx = eu.rotation_matrix_to_euler_zyx(torch.as_tensor(m, dtype=torch.float32)).numpy()
            jp[:, j, 3] = zyx[:, 2]
            jp[:, j, 4] = zyx[:, 1]
            jp[:, j, 5] = zyx[:, 0]

    character = Character(skeleton=skeleton,
                          parameter_transform=make_identity_transform(nj, device=device),
                          limits=make_empty_limits(device=device))
    fps = 1.0 / frame_time if frame_time > 0 else 120.0
    return character, torch.as_tensor(jp.reshape(n_frames, -1).astype(np.float32),
                                      device=device), fps


def _axis_mats(ang, axis):
    c, s = np.cos(ang), np.sin(ang)
    n = len(ang)
    m = np.zeros((n, 3, 3))
    if axis == 0:
        m[:, 0, 0] = 1
        m[:, 1, 1] = c; m[:, 1, 2] = -s
        m[:, 2, 1] = s; m[:, 2, 2] = c
    elif axis == 1:
        m[:, 1, 1] = 1
        m[:, 0, 0] = c; m[:, 0, 2] = s
        m[:, 2, 0] = -s; m[:, 2, 2] = c
    else:
        m[:, 2, 2] = 1
        m[:, 0, 0] = c; m[:, 0, 1] = -s
        m[:, 1, 0] = s; m[:, 1, 1] = c
    return m


def save_bvh(path, character, joint_params, fps=120.0) -> None:
    """Write skeleton + per-frame joint parameters (on any device) as BVH
    (bvh_io.cpp save). Channels: root gets 6 (pos+rot), others 3 rotations,
    ZYX order."""
    skel = character.skeleton
    parents = skel.parents_np
    offsets = to_host(skel.translation_offset)
    names = skel.joint_names
    nj = len(parents)
    children = [[] for _ in range(nj)]
    roots = []
    for j, p in enumerate(parents):
        if p < 0:
            roots.append(j)
        else:
            children[p].append(j)

    jp = to_host(joint_params).astype(np.float64).reshape(len(joint_params), nj, 7)
    lines = ["HIERARCHY"]
    channel_joints = []

    def emit(j, indent, kind):
        pad = "  " * indent
        lines.append(f"{pad}{kind} {names[j]}")
        lines.append(pad + "{")
        o = offsets[j]
        lines.append(f"{pad}  OFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}")
        if kind == "ROOT":
            lines.append(f"{pad}  CHANNELS 6 Xposition Yposition Zposition "
                         "Zrotation Yrotation Xrotation")
        else:
            lines.append(f"{pad}  CHANNELS 3 Zrotation Yrotation Xrotation")
        channel_joints.append((j, kind == "ROOT"))
        if children[j]:
            for c in children[j]:
                emit(c, indent + 1, "JOINT")
        else:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.000000 0.000000 0.000000")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    for r in roots:
        emit(r, 0, "ROOT")

    lines.append("MOTION")
    lines.append(f"Frames: {len(jp)}")
    lines.append(f"Frame Time: {1.0 / fps:.8f}")
    for f_i in range(len(jp)):
        vals = []
        for j, is_root in channel_joints:
            if is_root:
                vals += [jp[f_i, j, 0], jp[f_i, j, 1], jp[f_i, j, 2]]
            vals += [np.degrees(jp[f_i, j, 5]), np.degrees(jp[f_i, j, 4]),
                     np.degrees(jp[f_i, j, 3])]
        lines.append(" ".join(f"{v:.6f}" for v in vals))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
