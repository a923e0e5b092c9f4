"""Legacy full-character JSON IO.

Reference: momentum/io/legacy_json/legacy_json_io.cpp — skeleton under
"Skeleton"/"BodySkeleton" with a "Bones" array ({Name, Parent, PreRotation
(x,y,z,w), TranslationOffset}), locators as {name, parent, offset, weight}.
Quaternion arrays follow the reference's (x, y, z, w) JSON order.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["load_legacy_json", "save_legacy_json"]

_INVALID = 0xFFFFFFFFFFFFFFFF


def load_legacy_json(source, device="cuda"):
    """A Character from a legacy JSON file, or its text or bytes, on
    `device` (the card unless the caller asks for the CPU)."""
    from momentum_tpu_torch.character import (
        Character, Locators, make_empty_limits, make_identity_transform, make_skeleton)

    device = resolve(device, "load_legacy_json")
    if isinstance(source, (str, bytes)) and str(source).lstrip().startswith("{"):
        doc = json.loads(source)
    else:
        with open(source) as f:
            doc = json.load(f)

    skel_json = None
    for key in ("Skeleton", "BodySkeleton", "skeleton"):
        if key in doc:
            skel_json = doc[key]
            break
    if skel_json is None:
        raise ValueError("legacy JSON missing Skeleton")
    names, parents, pre, offs = [], [], [], []
    for b in skel_json["Bones"]:
        names.append(b.get("Name", f"bone{len(names)}"))
        p = b.get("Parent", _INVALID)
        parents.append(-1 if p in (_INVALID, None, -1) else int(p))
        pre.append(b.get("PreRotation", [0.0, 0.0, 0.0, 1.0]))
        offs.append(b.get("TranslationOffset", [0.0, 0.0, 0.0]))
    skeleton = make_skeleton(parents, np.asarray(pre), np.asarray(offs), names, device=device)

    locators = None
    loc_json = doc.get("Locators") or doc.get("locators")
    if loc_json:
        lp, lo, lw, ln = [], [], [], []
        name_idx = {n: i for i, n in enumerate(names)}
        for loc in loc_json:
            parent = loc.get("parent", loc.get("Parent", 0))
            if isinstance(parent, str):
                parent = name_idx.get(parent, 0)
            lp.append(int(parent))
            lo.append(loc.get("offset", loc.get("Offset", [0.0, 0.0, 0.0])))
            lw.append(float(loc.get("weight", loc.get("Weight", 1.0))))
            ln.append(loc.get("name", loc.get("Name", f"l{len(ln)}")))
        locators = Locators(
            parent=torch.as_tensor(np.asarray(lp, np.int32), device=device),
            offset=torch.as_tensor(np.asarray(lo, np.float32), device=device),
            weight=torch.as_tensor(np.asarray(lw, np.float32), device=device),
            names=tuple(ln))

    return Character(skeleton=skeleton,
                     parameter_transform=make_identity_transform(skeleton.num_joints,
                                                                 device=device),
                     limits=make_empty_limits(device=device), locators=locators)


def legacy_json_text(character) -> str:
    """The legacy JSON document of a character, as text."""
    skel = character.skeleton
    parents, pre, offs = (to_host(a) for a in (skel.joint_parent, skel.pre_rotation,
                                               skel.translation_offset))
    bones = [{"Name": skel.joint_names[j],
              "Parent": _INVALID if parents[j] < 0 else int(parents[j]),
              "PreRotation": [float(x) for x in pre[j]],
              "TranslationOffset": [float(x) for x in offs[j]]}
             for j in range(skel.num_joints)]
    doc = {"Skeleton": {"Bones": bones}}
    if character.locators is not None:
        loc = character.locators
        lp, lo, lw = (to_host(a) for a in (loc.parent, loc.offset, loc.weight))
        doc["Locators"] = [
            {"name": loc.names[i] if i < len(loc.names) else f"l{i}",
             "parent": int(lp[i]),
             "offset": [float(x) for x in lo[i]],
             "weight": float(lw[i])}
            for i in range(loc.num_locators)
        ]
    return json.dumps(doc, indent=1)


def save_legacy_json(path, character) -> None:
    text = legacy_json_text(character)
    with open(path, "w") as f:
        f.write(text)
