"""Parameter limits as padded per-type tables (parameter_limits.h:20-138).

Only the record types the marker-IK path reads are ported: MinMax over model
parameters (carried with the character) and MinMaxJoint over joint parameters,
whose passive records `apply_passive` clamps before FK. Linear, LinearJoint,
HalfPlane and Ellipsoid records come with the rest of the error catalog
(ROADMAP M3); `bridge.character_from_numpy` refuses a character that holds
any.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["ParameterLimits", "make_limits"]


@dataclasses.dataclass(frozen=True, eq=False)
class ParameterLimits:
    """minmax:       model-parameter index (M,) int32, bounds (M, 2), weight (M,)
    minmax_joint: flat joint-parameter index (MJ,) int32, bounds (MJ, 2),
                  weight (MJ,), passive flag (MJ,) (passive records are
                  clamped pre-FK, not penalized: parameter_limits.h:141-144)"""

    minmax_index: torch.Tensor
    minmax_bounds: torch.Tensor
    minmax_weight: torch.Tensor
    minmax_joint_index: torch.Tensor
    minmax_joint_bounds: torch.Tensor
    minmax_joint_weight: torch.Tensor
    minmax_joint_passive: torch.Tensor

    @property
    def counts(self) -> dict:
        return dict(minmax=self.minmax_index.shape[0],
                    minmax_joint=self.minmax_joint_index.shape[0])

    def apply_passive(self, joint_params: torch.Tensor) -> torch.Tensor:
        """Clamp joint params for passive MinMaxJoint records
        (applyPassiveJointParameterLimits, parameter_limits.h:141-144).
        With duplicate indices the write order is unspecified."""
        if self.minmax_joint_index.shape[0] == 0:
            return joint_params
        idx = self.minmax_joint_index.long()
        vals = joint_params.index_select(-1, idx)
        lo = self.minmax_joint_bounds[:, 0]
        hi = self.minmax_joint_bounds[:, 1]
        active = (self.minmax_joint_passive > 0) & (self.minmax_joint_weight > 0)
        clamped = torch.where(active, torch.minimum(torch.maximum(vals, lo), hi), vals)
        out = joint_params.clone()
        out[..., idx] = clamped
        return out


def make_limits(minmax=None, minmax_joint=None, device="cuda") -> ParameterLimits:
    """minmax: list of (param_index, lo, hi, weight); minmax_joint: list of
    (joint_index, joint_param, lo, hi, weight, passive)."""
    device = resolve(device, "make_limits")
    mm = np.asarray(minmax or [], np.float32).reshape(-1, 4)
    mj = np.asarray(minmax_joint or [], np.float32).reshape(-1, 6)
    mj_index = np.asarray([int(r[0]) * 7 + int(r[1]) for r in (minmax_joint or [])],
                          np.int32)

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    return ParameterLimits(
        minmax_index=i(mm[:, 0]), minmax_bounds=f(mm[:, 1:3]), minmax_weight=f(mm[:, 3]),
        minmax_joint_index=i(mj_index), minmax_joint_bounds=f(mj[:, 2:4]),
        minmax_joint_weight=f(mj[:, 4]), minmax_joint_passive=f(mj[:, 5]))

