"""Shared helpers of the tests/test_torch_port_*.py parity tests (this file
holds no tests): pull the numpy arrays out of momentum_tpu objects in the
layout that momentum_tpu_torch.bridge reads, and out of port objects for
comparison."""

from __future__ import annotations

import numpy as np


def character_to_numpy(char) -> dict:
    """The arrays of a Character (JAX or port) that bridge.character_from_numpy
    reads, as numpy."""
    lim = char.limits
    d = dict(
        joint_parent=char.skeleton.joint_parent,
        pre_rotation=char.skeleton.pre_rotation,
        translation_offset=char.skeleton.translation_offset,
        transform=char.parameter_transform.transform,
        offsets=char.parameter_transform.offsets,
        minmax_index=lim.minmax_index,
        minmax_bounds=lim.minmax_bounds,
        minmax_weight=lim.minmax_weight,
        minmax_joint_index=lim.minmax_joint_index,
        minmax_joint_bounds=lim.minmax_joint_bounds,
        minmax_joint_weight=lim.minmax_joint_weight,
        minmax_joint_passive=lim.minmax_joint_passive,
    )
    if char.locators is not None:
        d.update(locator_parent=char.locators.parent,
                 locator_offset=char.locators.offset,
                 locator_weight=char.locators.weight)
    return {k: to_numpy(v) for k, v in d.items()}


def position_error_to_numpy(ef) -> dict:
    """The arrays of a PositionErrorFunction (JAX or port) as numpy."""
    d = {k: to_numpy(getattr(ef, k))
         for k in ("parent", "offset", "target", "cweight", "weight")}
    d.update(loss_alpha=np.float64(ef.loss.alpha), loss_c=np.float64(ef.loss.c))
    return d


def to_numpy(x) -> np.ndarray:
    """numpy copy of a jax array, torch tensor or array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_fullbody_character():
    from momentum_tpu.testing.fixtures import create_fullbody_character

    return create_fullbody_character()


def port_fullbody_character():
    """The JAX full-body rig carried into the port through bridge.py."""
    from momentum_tpu_torch.bridge import character_from_numpy

    return character_from_numpy(character_to_numpy(jax_fullbody_character()))
