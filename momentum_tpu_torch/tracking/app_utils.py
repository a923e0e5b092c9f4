"""App-level plumbing (marker_tracking/app_utils.{h,cpp}).

`load_character_with_identity` mirrors the reference helper used by the CLI
apps: load a character (GLB/FBX/URDF/USDA by extension), optionally override
the rig from a .model/.cfg definition, and optionally read a calibrated
identity (a saved parameter vector: .mmo first frame or a JSON list or
name → value object) that per-frame tracking starts from. Everything is
built on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["load_character", "load_character_with_identity"]


def load_character(path, device="cuda"):
    """The character of a .glb, .fbx, .urdf or .usda file on `device`."""
    import momentum_tpu_torch.io as mio

    device = resolve(device, "load_character")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".glb":
        character, _, _ = mio.load_character_glb(path, device=device)
        return character
    if ext == ".fbx":
        return mio.load_fbx(path, device=device)
    if ext == ".urdf":
        return mio.load_urdf(path, device=device)
    if ext == ".usda":
        character, _ = mio.load_usda(path, device=device)
        return character
    raise ValueError(f"unsupported character format: {ext}")


def load_character_with_identity(character_path, model_path=None, identity_path=None,
                                 device="cuda"):
    """→ (character, identity params (P,) float32) on `device`; the identity
    is zero when no identity file is given."""
    import momentum_tpu_torch.io as mio

    character = load_character(character_path, device=device)
    if model_path:
        pt, limits = mio.load_model_definition(model_path, character.skeleton)
        character = dataclasses.replace(character, parameter_transform=pt, limits=limits)

    p = character.num_model_parameters
    vec = np.zeros(p, np.float32)
    if identity_path:
        name_idx = {n: i for i, n in enumerate(character.parameter_transform.names)}
        ext = os.path.splitext(identity_path)[1].lower()
        if ext == ".mmo":
            poses, _, names, _ = mio.load_mmo(identity_path)
            for i, n in enumerate(names):
                if n in name_idx:
                    vec[name_idx[n]] = poses[0, i]
        elif ext == ".json":
            with open(identity_path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                for n, v in data.items():
                    if n in name_idx:
                        vec[name_idx[n]] = v
            else:
                vec = np.asarray(data, np.float32)[:p]
        else:
            raise ValueError(f"unsupported identity format: {ext}")
    return character, torch.as_tensor(vec, device=character.skeleton.joint_parent.device)
