"""Joint-to-joint residual modules, after momentum_tpu/errors/joint_pair.py
(momentum/character_solver/):

  JointToJointPositionErrorFunction (joint_to_joint_position_error_function.cpp:86-104)
      f = R_refᵀ·(T_src·srcOffset − T_ref·refOffset) − target   (3 rows)
  JointToJointDistanceErrorFunction (joint_to_joint_distance_error_function.cpp:60-76;
      kDistanceWeight = 1e-2, .h:117)
      f = ‖p_src − p_ref‖ − target                              (1 row)
  JointToJointOrientationErrorFunction (joint_to_joint_orientation_error_function.cpp:88-96)
      f = R_refᵀ·R_src − R_target (flattened)                    (9 rows)

Each has its analytic joint-space Jacobian.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction, pad_rows
from momentum_tpu_torch.errors.geometric import _dot_j, _finish, clamped
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["JointToJointPositionErrorFunction", "JointToJointDistanceErrorFunction",
           "JointToJointOrientationErrorFunction", "K_J2J_DISTANCE_WEIGHT"]

K_J2J_DISTANCE_WEIGHT = 1e-2  # joint_to_joint_distance_error_function.h:117


def _create(cls, device, source, reference, cweight, weight, loss, capacity, tables,
            quats=()):
    """cls(...) with the float `tables` (name -> (array, row shape)) and the
    joint indices and weights padded to `capacity` rows, quaternion tables
    padded with the identity rotation."""
    device = resolve(device, f"{cls.__name__}.create")
    source = np.asarray(source, np.int32)
    n = source.shape[0]
    cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
    cap = capacity or n

    def t(x):
        return torch.as_tensor(pad_rows(x, cap), device=device)

    fields = {}
    for k, (v, shape) in tables.items():
        v = np.asarray(v, np.float32).reshape((n,) + shape)
        if k in quats:
            out = np.tile(np.asarray([0, 0, 0, 1], np.float32), (cap, 1))
            out[:n] = v
            fields[k] = torch.as_tensor(out, device=device)
        else:
            fields[k] = t(v)
    return cls(source=t(source), reference=t(np.asarray(reference, np.int32)),
               cweight=t(cweight), weight=torch.tensor(weight, dtype=torch.float32,
                                                       device=device),
               loss=loss or GeneralizedLoss(), **fields)


class _Pair(VectorErrorFunction):
    has_analytic_jacobian = True

    def constraint_count(self) -> int:
        return self.source.shape[0]

    def _joints(self, ctx: EvalContext):
        """(source, reference) clamped, and their global states."""
        src, ref = clamped(self.source, ctx), clamped(self.reference, ctx)
        return (src, ref, ctx.skel_states.index_select(-2, src),
                ctx.skel_states.index_select(-2, ref))


@dataclasses.dataclass(frozen=True, eq=False)
class _PairPoints(_Pair):
    source: torch.Tensor  # (C,) int32
    reference: torch.Tensor  # (C,) int32
    source_offset: torch.Tensor  # (C, 3)
    reference_offset: torch.Tensor  # (C, 3)
    target: torch.Tensor
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    def _points(self, ctx: EvalContext):
        src, ref, s_src, s_ref = self._joints(ctx)
        return (src, ref, s_ref, ss.transform_points(s_src, self.source_offset),
                ss.transform_points(s_ref, self.reference_offset))

    @classmethod
    def create(cls, source, reference, source_offset, reference_offset, target,
               cweight=None, weight=1.0, loss=None, capacity=None, device="cuda"):
        return _create(cls, device, source, reference, cweight, weight, loss, capacity,
                       dict(source_offset=(source_offset, (3,)),
                            reference_offset=(reference_offset, (3,)),
                            target=(target, cls._target_shape)))


@dataclasses.dataclass(frozen=True, eq=False)
class JointToJointPositionErrorFunction(_PairPoints):
    """target (..., C, 3) in the reference joint's frame."""

    D = 3
    _target_shape = (3,)

    def raw(self, character, ctx: EvalContext):
        _, _, s_ref, p_src, p_ref = self._points(ctx)
        rel = quat.rotate_vector(quat.conjugate(s_ref[..., 3:7]), p_src - p_ref)
        return rel - self.target, self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """rel = R_refᵀ(p_s − p_r); d rel = R_refᵀ(dp_s − dp_r − ω_ref × (p_s − p_r)),
        the last term the vector Jacobian of the world difference attached
        to the reference joint."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian, vector_jacobian

        src, ref, s_ref, p_src, p_ref = self._points(ctx)
        q_ref = s_ref[..., 3:7]
        diff = p_src - p_ref
        j_world = (point_jacobian(jc, p_src, src) - point_jacobian(jc, p_ref, ref)
                   - vector_jacobian(jc, diff, ref))
        r_ref_t = quat.to_rotation_matrix(q_ref).transpose(-1, -2)
        j = torch.einsum("...cij,...cjk->...cik", r_ref_t, j_world)
        f = quat.rotate_vector(quat.conjugate(q_ref), diff) - self.target
        return _finish(self, f, j, self.cweight)


@dataclasses.dataclass(frozen=True, eq=False)
class JointToJointDistanceErrorFunction(_PairPoints):
    """target (..., C) distances."""

    D = 1
    _target_shape = ()

    def raw(self, character, ctx: EvalContext):
        _, _, _, p_src, p_ref = self._points(ctx)
        dist = torch.linalg.vector_norm(p_src - p_ref + 1e-20, dim=-1)
        return (dist - self.target)[..., None], self.cweight * K_J2J_DISTANCE_WEIGHT

    def jacobian(self, character, ctx: EvalContext, jc):
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        src, ref, _, p_src, p_ref = self._points(ctx)
        dvec = p_src - p_ref
        dist = torch.linalg.vector_norm(dvec + 1e-20, dim=-1)
        dhat = dvec / torch.clamp(dist, min=1e-12)[..., None]
        j = _dot_j(dhat, point_jacobian(jc, p_src, src) - point_jacobian(jc, p_ref, ref))
        return _finish(self, (dist - self.target)[..., None], j[..., None, :],
                       self.cweight * K_J2J_DISTANCE_WEIGHT)


@dataclasses.dataclass(frozen=True, eq=False)
class JointToJointOrientationErrorFunction(_Pair):
    source: torch.Tensor
    reference: torch.Tensor
    target: torch.Tensor  # (..., C, 4) target relative rotation quaternion
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 9

    def _rotations(self, ctx: EvalContext):
        """(source, reference, R_src, R_refᵀ, R_refᵀ·R_src − R_target)."""
        src, ref, s_src, s_ref = self._joints(ctx)
        r_src = quat.to_rotation_matrix(s_src[..., 3:7])
        r_ref_t = quat.to_rotation_matrix(s_ref[..., 3:7]).transpose(-1, -2)
        rel = torch.einsum("...cij,...cjk->...cik", r_ref_t, r_src)
        return src, ref, r_src, r_ref_t, rel - quat.to_rotation_matrix(self.target)

    def raw(self, character, ctx: EvalContext):
        diff = self._rotations(ctx)[-1]
        return diff.reshape(diff.shape[:-2] + (9,)), self.cweight

    def jacobian(self, character, ctx: EvalContext, jc):
        """Column c_j = R_refᵀ·w_j with w_j = R_src·e_j:
        d c_j = R_refᵀ(dw_j − ω_ref × w_j)."""
        from momentum_tpu_torch.solver.analytic_jacobian import vector_jacobian

        src, ref, r_src, r_ref_t, diff = self._rotations(ctx)
        cols = []
        for k in range(3):
            w = r_src[..., k]
            jw = vector_jacobian(jc, w, src) - vector_jacobian(jc, w, ref)
            cols.append(torch.einsum("...cij,...cjk->...cik", r_ref_t, jw))
        j = torch.stack(cols, dim=-2)  # (..., C, 3 rows, 3 cols, nJ·7)
        j = j.reshape(j.shape[:-3] + (9, j.shape[-1]))
        return _finish(self, diff.reshape(diff.shape[:-2] + (9,)), j, self.cweight)

    @classmethod
    def create(cls, source, reference, target, cweight=None, weight=1.0, loss=None,
               capacity=None, device="cuda"):
        return _create(cls, device, source, reference, cweight, weight, loss, capacity,
                       dict(target=(target, (4,))), quats=("target",))
