"""High-level character load/save dispatch by file extension.

Reference: momentum/io/character_io.h loadFullCharacter / saveCharacter —
one entry point that picks the format from the extension, then composes the
optional side-car files: a `.model`/`.cfg` parameter-transform definition
(parametersPath) and a `.locators` JSON (locatorsPath). The reference
supports glb/fbx/usd for characters; this adds the formats the rest of the
package reads (urdf, bvh, legacy json, usda/usdc), and writes OBJ and .mmo.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["load_full_character", "save_character", "character_format"]

_LOAD_EXTS = (".glb", ".gltf", ".fbx", ".usd", ".usda", ".usdc", ".urdf",
              ".bvh", ".json")


def character_format(path: str) -> str:
    """'gltf' | 'fbx' | 'usd' | 'urdf' | 'bvh' | 'json' | 'unknown'
    (character_io.h CharacterFormat)."""
    ext = os.path.splitext(str(path))[1].lower()
    return {".glb": "gltf", ".gltf": "gltf", ".fbx": "fbx", ".usd": "usd",
            ".usda": "usd", ".usdc": "usd", ".urdf": "urdf", ".bvh": "bvh",
            ".json": "json"}.get(ext, "unknown")


def load_full_character(character_path, parameters_path=None, locators_path=None,
                        device="cuda"):
    """Load a character from any supported format, then overlay an optional
    `.model` parameter definition and an optional `.locators` file
    (character_io.h:37-41 loadFullCharacter), on `device` (the card unless
    the caller asks for the CPU)."""
    device = resolve(device, "load_full_character")
    fmt = character_format(character_path)
    if fmt == "gltf":
        from momentum_tpu_torch.io.gltf import load_character_glb

        character, _, _ = load_character_glb(str(character_path), device=device)
    elif fmt == "fbx":
        from momentum_tpu_torch.io.fbx import load_fbx

        character = load_fbx(str(character_path), device=device)
    elif fmt == "usd":
        from momentum_tpu_torch.io.usd import load_usd

        character, _ = load_usd(str(character_path), device=device)
    elif fmt == "urdf":
        from momentum_tpu_torch.io.urdf import load_urdf

        character = load_urdf(str(character_path), device=device)
    elif fmt == "bvh":
        from momentum_tpu_torch.io.bvh import load_bvh

        character, _, _ = load_bvh(str(character_path), device=device)
    elif fmt == "json":
        from momentum_tpu_torch.io.legacy_json import load_legacy_json

        character = load_legacy_json(str(character_path), device=device)
    else:
        raise ValueError(f"unsupported character format: {character_path} "
                         f"(expected one of {_LOAD_EXTS})")

    if parameters_path:
        from momentum_tpu_torch.io.model_definition import load_model_definition

        pt, limits = load_model_definition(str(parameters_path), character.skeleton)
        character = dataclasses.replace(character, parameter_transform=pt, limits=limits)
    if locators_path:
        from momentum_tpu_torch.io.locators import load_locators

        character = dataclasses.replace(
            character, locators=load_locators(str(locators_path), character))
    return character


def save_character(path, character, motion=None, fps: float = 120.0) -> None:
    """Save a character (+ optional model-parameter motion) in the format
    implied by the extension (character_io.h saveCharacter: glb/fbx/usd;
    plus bvh/obj/json/mmo from this package)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".glb", ".gltf"):
        from momentum_tpu_torch.io.gltf import save_character_glb

        save_character_glb(str(path), character, motion=motion, fps=fps)
    elif ext == ".fbx":
        from momentum_tpu_torch.io.fbx_writer import save_fbx

        save_fbx(str(path), character, motion=motion, fps=fps)
    elif ext in (".usd", ".usda", ".usdc"):
        from momentum_tpu_torch.io.usd import save_usd

        save_usd(str(path), character, motion=motion, fps=fps)
    elif ext == ".bvh":
        from momentum_tpu_torch.io.bvh import save_bvh

        pt = character.parameter_transform
        if motion is not None:
            jp = pt.apply(torch.as_tensor(motion, dtype=torch.float32).to(pt.transform.device))
        else:
            jp = np.zeros((1, character.skeleton.num_joint_parameters), np.float32)
        save_bvh(str(path), character, jp, fps=fps)
    elif ext == ".obj":
        from momentum_tpu_torch.io.obj import save_obj

        if character.mesh is None:
            raise ValueError("character has no mesh to export as OBJ")
        save_obj(str(path), character.mesh.vertices, character.mesh.faces)
    elif ext == ".json":
        from momentum_tpu_torch.io.legacy_json import save_legacy_json

        save_legacy_json(str(path), character)
    elif ext == ".mmo":
        from momentum_tpu_torch.io.motion import save_mmo

        if motion is None:
            raise ValueError(".mmo requires motion")
        save_mmo(str(path), to_host(motion).astype(np.float32),
                 np.zeros(character.num_joints, np.float32),
                 list(character.parameter_transform.names),
                 list(character.skeleton.joint_names))
    else:
        raise ValueError(f"unsupported save format: {ext}")
