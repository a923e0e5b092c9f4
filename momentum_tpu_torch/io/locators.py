"""`.locators` JSON file IO.

Reference: momentum/io/skeleton/locator_io.cpp — a JSON document
{"locators": [{...}]} where each entry carries name, parent (index) or
parentName, a local offset (offsetX/Y/Z) or bind-pose global position
(globalX/Y/Z, converted to a parent-frame offset through the bind-pose
skeleton state, locator_io.cpp:180-187), per-axis lock flags (lockX/Y/Z),
weight, optional limit weights (limitWeightX/Y/Z, written only when nonzero,
locator_io.cpp:240-248), and skin attachment (attachedToSkin, skinOffset).
Locators with no resolvable parent are skipped; duplicate names raise
(locator_io.cpp:203-204). limitOrigin is set to the loaded offset
(locator_io.cpp:197).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host
from momentum_tpu_torch.io.limits_json import character_device

__all__ = ["load_locators", "save_locators", "locators_from_json",
           "locators_to_json"]


def locators_from_json(doc: dict, character, device=None):
    """Parse the reference JSON document into Locators on `device` (the
    character's when None); None when the document has no valid
    locators."""
    from momentum_tpu_torch.character import Locators
    from momentum_tpu_torch.math import skel_state as ss

    entries = doc.get("locators")
    if not isinstance(entries, list):
        return None
    device = resolve(character_device(character) if device is None else device,
                     "locators_from_json")

    skel = character.skeleton
    name_to_idx = {n: i for i, n in enumerate(skel.joint_names)}
    bind = character.bind_pose().cpu()  # (nJ, 8) global bind states

    rows = []
    for e in entries:
        parent = e.get("parent", -1)
        if "parentName" in e:
            parent = name_to_idx.get(e["parentName"], -1)
        if not (0 <= parent < skel.num_joints):
            continue  # skipped with a warning in the reference
        if {"globalX", "globalY", "globalZ"} & e.keys():
            g = torch.as_tensor([e.get("globalX", 0.0), e.get("globalY", 0.0),
                                 e.get("globalZ", 0.0)], dtype=torch.float32)
            offset = ss.transform_points(ss.inverse(bind[parent]), g).numpy()
        else:
            offset = np.asarray([e.get("offsetX", 0.0), e.get("offsetY", 0.0),
                                 e.get("offsetZ", 0.0)], np.float32)
        rows.append(dict(
            name=e.get("name", ""),
            parent=parent,
            offset=offset,
            weight=float(e.get("weight", 1.0)),
            locked=[int(e.get("lockX", 0)), int(e.get("lockY", 0)), int(e.get("lockZ", 0))],
            limit_weight=[float(e.get("limitWeightX", 0.0)),
                          float(e.get("limitWeightY", 0.0)),
                          float(e.get("limitWeightZ", 0.0))],
            attached_to_skin=int(bool(e.get("attachedToSkin", 0))),
            skin_offset=float(e.get("skinOffset", 0.0)),
        ))
    if not rows:
        return None

    names = [r["name"] for r in rows]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(f"duplicated locator {sorted(dup)[0]!r} found")

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.asarray([r[key] for r in rows]), dtype=dtype, device=device)

    offs = torch.as_tensor(np.stack([r["offset"] for r in rows]), dtype=torch.float32,
                           device=device)
    return Locators(
        parent=t("parent", torch.int32),
        offset=offs,
        weight=t("weight"),
        names=tuple(names),
        locked=t("locked"),
        limit_weight=t("limit_weight"),
        limit_origin=offs.clone(),  # limitOrigin = offset on load
        attached_to_skin=t("attached_to_skin"),
        skin_offset=t("skin_offset"),
    )


def locators_to_json(character, space: str = "local") -> dict:
    """Locators → the reference JSON document. `space` is "local" (offsets)
    or "global" (bind-pose world positions, locator_io.cpp:225-233)."""
    loc = character.locators
    if loc is None:
        return {"locators": []}
    skel = character.skeleton
    parent, offset, weight = (to_host(a) for a in (loc.parent, loc.offset, loc.weight))
    nl = loc.num_locators

    def opt(arr, shape):
        return np.zeros(shape, np.float32) if arr is None else to_host(arr)

    locked = opt(loc.locked, (nl, 3))
    limit_weight = opt(loc.limit_weight, (nl, 3))
    attached = opt(loc.attached_to_skin, (nl,))
    skin_offset = opt(loc.skin_offset, (nl,))

    if space == "global":
        from momentum_tpu_torch.math import skel_state as ss

        bind = character.bind_pose().cpu()
        world = ss.transform_points(bind[torch.as_tensor(parent, dtype=torch.int64)],
                                    torch.as_tensor(offset)).numpy()
    elif space != "local":
        raise ValueError(f"unknown locator space {space!r}")

    out = []
    for i in range(nl):
        e = {"name": loc.names[i] if i < len(loc.names) else f"locator{i}"}
        if space == "global":
            e["globalX"], e["globalY"], e["globalZ"] = (
                float(world[i, 0]), float(world[i, 1]), float(world[i, 2]))
        else:
            e["offsetX"], e["offsetY"], e["offsetZ"] = (
                float(offset[i, 0]), float(offset[i, 1]), float(offset[i, 2]))
        e["lockX"], e["lockY"], e["lockZ"] = (
            int(locked[i, 0]), int(locked[i, 1]), int(locked[i, 2]))
        e["weight"] = float(weight[i])
        for a, key in enumerate(("limitWeightX", "limitWeightY", "limitWeightZ")):
            if limit_weight[i, a] != 0.0:
                e[key] = float(limit_weight[i, a])
        if attached[i]:
            e["attachedToSkin"] = 1
        if skin_offset[i] != 0.0:
            e["skinOffset"] = float(skin_offset[i])
        p = int(parent[i])
        if 0 <= p < skel.num_joints:
            e["parentName"] = skel.joint_names[p]
        out.append(e)
    return {"locators": out}


def load_locators(source, character, device=None):
    """Load a .locators file (path, bytes, or str JSON) → Locators on
    `device` (the character's when None)."""
    if isinstance(source, (bytes, bytearray)):
        text = bytes(source).decode("utf-8")
    elif isinstance(source, str) and source.lstrip().startswith("{"):
        text = source
    else:
        with open(source, "r", encoding="utf-8") as f:
            text = f.read()
    return locators_from_json(json.loads(text), character, device)


def save_locators(path, character, space: str = "local") -> None:
    """Save character.locators as a .locators JSON file."""
    doc = locators_to_json(character, space)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
