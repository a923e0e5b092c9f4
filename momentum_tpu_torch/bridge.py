"""Build port objects from plain numpy arrays, so the port and the JAX
package can compute on identical inputs.

The dicts hold exactly the arrays of a `momentum_tpu` Character or
PositionErrorFunction (as `np.asarray` gives them); the side that extracts
them from JAX objects lives with the tests, since this package imports no
jax.

character_from_numpy keys (shapes as in momentum_tpu):
    joint_parent (nJ,) int32, pre_rotation (nJ, 4), translation_offset (nJ, 3),
    transform (nJ*7, P), offsets (nJ*7,),
    minmax_index (M,), minmax_bounds (M, 2), minmax_weight (M,),
    minmax_joint_index (MJ,), minmax_joint_bounds (MJ, 2),
    minmax_joint_weight (MJ,), minmax_joint_passive (MJ,),
    optional locator_parent (L,), locator_offset (L, 3), locator_weight (L,)
position_error_from_numpy keys:
    parent (C,), offset (C, 3), target (..., C, 3), cweight (C,), weight (),
    optional loss_alpha, loss_c
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.character import (
    Character, Locators, ParameterLimits, ParameterTransform, Skeleton)
from momentum_tpu_torch.errors import PositionErrorFunction
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["character_from_numpy", "position_error_from_numpy"]

_LIMIT_KEYS = ("minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
               "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive")


def _t(d, key, device):
    return torch.as_tensor(np.array(d[key]), device=device)  # a writable copy


def character_from_numpy(d: dict, device=None) -> Character:
    skeleton = Skeleton(joint_parent=_t(d, "joint_parent", device).to(torch.int32),
                        pre_rotation=_t(d, "pre_rotation", device),
                        translation_offset=_t(d, "translation_offset", device))
    pt = ParameterTransform(transform=_t(d, "transform", device),
                            offsets=_t(d, "offsets", device))
    limits = ParameterLimits(**{k: _t(d, k, device) for k in _LIMIT_KEYS})
    locators = None
    if "locator_parent" in d:
        locators = Locators(parent=_t(d, "locator_parent", device).to(torch.int32),
                            offset=_t(d, "locator_offset", device),
                            weight=_t(d, "locator_weight", device))
    return Character(skeleton=skeleton, parameter_transform=pt, limits=limits,
                     locators=locators)


def position_error_from_numpy(d: dict, device=None) -> PositionErrorFunction:
    loss = GeneralizedLoss(alpha=float(d.get("loss_alpha", 2.0)),
                           c=float(d.get("loss_c", 1.0)))
    return PositionErrorFunction(
        parent=_t(d, "parent", device).to(torch.int32), offset=_t(d, "offset", device),
        target=_t(d, "target", device), cweight=_t(d, "cweight", device),
        weight=_t(d, "weight", device), loss=loss)
