"""The rigs the configurations name, as plain arrays.

A rig file under `portbench/rigs/` holds the skeleton (parents, translation
offsets), the parameter transform as (joint-parameter row, model-parameter
column) pairs of weight 1, the parameter sets, the MinMax limits and the
named locators. `load_rig` reads it into numpy; `port_character` builds the port's
Character from those arrays through the port's public constructors (the
system under test); `reference_rig` gives the plain reference the same
arrays as tensors. Neither side takes anything the other has made.
"""

from __future__ import annotations

import json
import pathlib
from typing import NamedTuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARAMS_PER_JOINT = 7


class Rig(NamedTuple):
    joint_names: tuple
    parents: np.ndarray  # (J,) int, -1 for the root; every parent precedes its child
    translation_offsets: np.ndarray  # (J, 3)
    parameter_names: tuple
    transform: np.ndarray  # (J*7, P) 0/1
    parameter_sets: dict
    minmax: list  # (parameter, lo, hi, weight)
    locator_names: tuple
    locator_parents: np.ndarray  # (L,) int
    locator_offsets: np.ndarray  # (L, 3)

    @property
    def num_parameters(self) -> int:
        return self.transform.shape[1]


def load_rig(path: str) -> Rig:
    """The rig of a file named relative to the root of the checkout."""
    d = json.loads((ROOT / path).read_text())
    parents = np.asarray(d["joint_parents"], np.int64)
    if np.any(parents >= np.arange(parents.size)):
        raise ValueError(f"{path}: every joint's parent must precede it")
    nj = parents.size
    pmap = np.asarray(d["parameter_map"], np.int64)
    transform = np.zeros((nj * PARAMS_PER_JOINT, len(d["parameter_names"])))
    transform[pmap[:, 0], pmap[:, 1]] = 1.0
    return Rig(joint_names=tuple(d["joint_names"]), parents=parents,
               translation_offsets=np.asarray(d["translation_offsets"], np.float64),
               parameter_names=tuple(d["parameter_names"]), transform=transform,
               parameter_sets={k: tuple(v) for k, v in d["parameter_sets"].items()},
               minmax=[tuple(r) for r in d["minmax"]],
               locator_names=tuple(d["locator_names"]),
               locator_parents=np.asarray(d["locator_parents"], np.int64),
               locator_offsets=np.asarray(d["locator_offsets"], np.float64))


def port_character(rig: Rig, device):
    """The port's Character of `rig` on `device`, from its public
    constructors (no mesh: the configurations' modules read none)."""
    from momentum_tpu_torch.character import (
        Character, Locators, ParameterTransform, make_limits, make_skeleton)

    skeleton = make_skeleton(rig.parents.tolist(), translation_offsets=rig.translation_offsets,
                             names=rig.joint_names, device=device)
    pt = ParameterTransform(
        transform=torch.as_tensor(rig.transform, dtype=torch.float32, device=device),
        offsets=torch.zeros(rig.transform.shape[0], dtype=torch.float32, device=device),
        names=rig.parameter_names, parameter_sets=dict(rig.parameter_sets))
    n = rig.locator_parents.size
    locators = Locators(
        parent=torch.as_tensor(rig.locator_parents.astype(np.int32), device=device),
        offset=torch.as_tensor(rig.locator_offsets, dtype=torch.float32, device=device),
        weight=torch.ones(n, dtype=torch.float32, device=device),
        names=rig.locator_names)
    return Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_limits(minmax=rig.minmax, device=device),
                     locators=locators, name="portbench_" + str(len(rig.parents)))


def universal_mask(rig: Rig, set_name: str) -> np.ndarray:
    """(P,) bool: the parameters of the named set."""
    mask = np.zeros(rig.num_parameters, bool)
    mask[list(rig.parameter_sets.get(set_name, ()))] = True
    return mask


def sync(device):
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
