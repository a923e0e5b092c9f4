"""Parameter limits as padded per-type tables (parameter_limits.h:20-138),
after momentum_tpu/character/limits.py: the reference's tagged-union list
grouped by record type into fixed tables.

LimitErrorFunction (errors/limit.py) penalizes every record type but the
passive MinMaxJoint records, which `apply_passive` clamps before FK.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["ParameterLimits", "make_limits", "concat_limits", "create_minmax",
           "create_minmax_joint", "create_linear", "create_linear_joint", "create_halfplane",
           "create_ellipsoid"]


@dataclasses.dataclass(frozen=True, eq=False)
class ParameterLimits:
    """minmax:       model-parameter index (M,) int32, bounds (M, 2), weight (M,)
    minmax_joint: flat joint-parameter index (MJ,) int32, bounds (MJ, 2),
                  weight (MJ,), passive flag (MJ,) (passive records are
                  clamped pre-FK, not penalized: parameter_limits.h:141-144)
    linear:       p_ref = s·p_tgt − o while p_tgt ∈ [range_min, range_max)
                  (parameter_limits.h:46-57): ref, tgt (L,) int32, scale,
                  offset (L,), range (L, 2), weight (L,)
    linear_joint: the same over flat joint-parameter indices (LJ,)
    halfplane:    (p1, p2)·n − o ≥ 0 (parameter_limits.h:86-92): idx1, idx2
                  (H,) int32, normal (H, 2), offset (H,), weight (H,)
    ellipsoid:    a point (offset in the `parent` frame) held inside an
                  ellipsoid in the `frame_parent` frame (parameter_limits.h:
                  75-84): parent, frame_parent (E,) int32, point_offset
                  (E, 3), mat and its inverse inv (E, 4, 4), weight (E,)"""

    minmax_index: torch.Tensor
    minmax_bounds: torch.Tensor
    minmax_weight: torch.Tensor
    minmax_joint_index: torch.Tensor
    minmax_joint_bounds: torch.Tensor
    minmax_joint_weight: torch.Tensor
    minmax_joint_passive: torch.Tensor
    linear_ref: torch.Tensor
    linear_tgt: torch.Tensor
    linear_scale: torch.Tensor
    linear_offset: torch.Tensor
    linear_range: torch.Tensor
    linear_weight: torch.Tensor
    linear_joint_ref: torch.Tensor
    linear_joint_tgt: torch.Tensor
    linear_joint_scale: torch.Tensor
    linear_joint_offset: torch.Tensor
    linear_joint_range: torch.Tensor
    linear_joint_weight: torch.Tensor
    halfplane_idx1: torch.Tensor
    halfplane_idx2: torch.Tensor
    halfplane_normal: torch.Tensor
    halfplane_offset: torch.Tensor
    halfplane_weight: torch.Tensor
    ellipsoid_parent: torch.Tensor
    ellipsoid_frame_parent: torch.Tensor
    ellipsoid_point_offset: torch.Tensor
    ellipsoid_mat: torch.Tensor
    ellipsoid_inv: torch.Tensor
    ellipsoid_weight: torch.Tensor

    @property
    def counts(self) -> dict:
        return dict(minmax=self.minmax_index.shape[0],
                    minmax_joint=self.minmax_joint_index.shape[0],
                    linear=self.linear_ref.shape[0],
                    linear_joint=self.linear_joint_ref.shape[0],
                    halfplane=self.halfplane_idx1.shape[0],
                    ellipsoid=self.ellipsoid_parent.shape[0])

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


def make_limits(minmax=None, minmax_joint=None, linear=None, linear_joint=None,
                halfplane=None, ellipsoid=None, device="cuda") -> ParameterLimits:
    """minmax: (param_index, lo, hi, weight) records; minmax_joint:
    (joint_index, joint_param, lo, hi, weight, passive); linear: (ref_idx,
    tgt_idx, scale, offset, range_min, range_max, weight); linear_joint: the
    same over flat joint-parameter indices; halfplane: (idx1, idx2, nx, ny,
    offset, weight); ellipsoid: (parent, ellipsoid_parent, offset3,
    mat4x4, weight)."""
    device = resolve(device, "make_limits")

    def arr(rows, cols):
        return np.asarray(rows or [], np.float32).reshape(-1, cols)

    mm, mj, li, lj, hp = (arr(minmax, 4), arr(minmax_joint, 6), arr(linear, 7),
                          arr(linear_joint, 7), arr(halfplane, 6))
    ell = ellipsoid or []

    def f(x, shape=None):
        x = np.asarray(x, np.float32)
        return torch.as_tensor(np.ascontiguousarray(x if shape is None else x.reshape(shape)),
                               device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    mats = [np.asarray(e[3]) for e in ell]  # inverted at their own precision, as in JAX
    return ParameterLimits(
        minmax_index=i(mm[:, 0]), minmax_bounds=f(mm[:, 1:3]), minmax_weight=f(mm[:, 3]),
        minmax_joint_index=i([int(r[0]) * 7 + int(r[1]) for r in (minmax_joint or [])]),
        minmax_joint_bounds=f(mj[:, 2:4]), minmax_joint_weight=f(mj[:, 4]),
        minmax_joint_passive=f(mj[:, 5]),
        linear_ref=i(li[:, 0]), linear_tgt=i(li[:, 1]), linear_scale=f(li[:, 2]),
        linear_offset=f(li[:, 3]), linear_range=f(li[:, 4:6]), linear_weight=f(li[:, 6]),
        linear_joint_ref=i(lj[:, 0]), linear_joint_tgt=i(lj[:, 1]),
        linear_joint_scale=f(lj[:, 2]), linear_joint_offset=f(lj[:, 3]),
        linear_joint_range=f(lj[:, 4:6]), linear_joint_weight=f(lj[:, 6]),
        halfplane_idx1=i(hp[:, 0]), halfplane_idx2=i(hp[:, 1]),
        halfplane_normal=f(hp[:, 2:4]), halfplane_offset=f(hp[:, 4]),
        halfplane_weight=f(hp[:, 5]),
        ellipsoid_parent=i([e[0] for e in ell]),
        ellipsoid_frame_parent=i([e[1] for e in ell]),
        ellipsoid_point_offset=f([np.asarray(e[2]).reshape(3) for e in ell], (-1, 3)),
        ellipsoid_mat=f(mats, (-1, 4, 4)),
        ellipsoid_inv=f([np.linalg.inv(m) for m in mats], (-1, 4, 4)),
        ellipsoid_weight=f([e[4] for e in ell]))


def concat_limits(a: ParameterLimits, b: ParameterLimits) -> ParameterLimits:
    """The records of a, then b's, on a's device (the reference's
    mergeVectors over ParameterLimits, character_utility.cpp:274-280)."""
    return ParameterLimits(**{
        fld.name: torch.cat([getattr(a, fld.name),
                             getattr(b, fld.name).to(getattr(a, fld.name).device)])
        for fld in dataclasses.fields(ParameterLimits)})


# one-record tables (pymomentum ParameterLimit.create_*, limit_pybind.cpp:165-336);
# combine them with concat_limits
_FMAX = 3.0e38


def create_minmax(model_parameter_index: int, min: float, max: float, weight: float = 1.0,
                  device="cuda") -> ParameterLimits:
    return make_limits(minmax=[(model_parameter_index, min, max, weight)], device=device)


def create_minmax_joint(joint_index: int, joint_parameter: int, min: float, max: float,
                        weight: float = 1.0, passive: bool = False,
                        device="cuda") -> ParameterLimits:
    return make_limits(minmax_joint=[(joint_index, joint_parameter, min, max, weight,
                                      float(passive))], device=device)


def create_linear(reference_model_parameter_index: int, target_model_parameter_index: int,
                  scale: float, offset: float, weight: float = 1.0,
                  range_min: float | None = None, range_max: float | None = None,
                  device="cuda") -> ParameterLimits:
    """p_ref = scale·p_tgt − offset over [range_min, range_max)
    (limit_pybind.cpp:208-241)."""
    return make_limits(linear=[(
        reference_model_parameter_index, target_model_parameter_index, scale, offset,
        -_FMAX if range_min is None else range_min, _FMAX if range_max is None else range_max,
        weight)], device=device)


def create_linear_joint(reference_joint_index: int, reference_joint_parameter: int,
                        target_joint_index: int, target_joint_parameter: int, scale: float,
                        offset: float, weight: float = 1.0, device="cuda") -> ParameterLimits:
    ref = reference_joint_index * 7 + reference_joint_parameter
    tgt = target_joint_index * 7 + target_joint_parameter
    return make_limits(linear_joint=[(ref, tgt, scale, offset, -_FMAX, _FMAX, weight)],
                       device=device)


def create_halfplane(param1_index: int, param2_index: int, normal, offset: float = 0.0,
                     weight: float = 1.0, device="cuda") -> ParameterLimits:
    n = np.asarray(normal, np.float32).reshape(2)
    return make_limits(halfplane=[(param1_index, param2_index, n[0], n[1], offset, weight)],
                       device=device)


def create_ellipsoid(ellipsoid_parent: int, parent: int, offset, ellipsoid,
                     weight: float = 1.0, device="cuda") -> ParameterLimits:
    return make_limits(ellipsoid=[(parent, ellipsoid_parent, offset, ellipsoid, weight)],
                       device=device)
