"""StateErrorFunction: match a full target skeleton state, after
momentum_tpu/errors/state.py (state_error_function.{h,cpp}:199-262). Per
joint i:

    position  ‖t_i − t*_i‖² · kPositionWeight (1e-3) · pos_wgt · position_weight_i
    rotation  ‖R_i − R*_i‖² · kOrientationWeight (1) · rot_wgt · rotation_weight_i
              ("matrix", the default), or ‖log(q*⁻¹·q)‖² ("logmap")

Rows: 3 position rows per joint, then 9 (or 3) rotation rows per joint.
The analytic Jacobian covers the "matrix" type, as in JAX; the "logmap"
type's rows reach the solver by forward mode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import ErrorFunction, EvalContext
from momentum_tpu_torch.math import quaternion as quat

__all__ = ["StateErrorFunction"]

K_STATE_POSITION_WEIGHT = 1e-3  # state_error_function.h:115
K_STATE_ORIENTATION_WEIGHT = 1.0  # state_error_function.h:116


@dataclasses.dataclass(frozen=True, eq=False)
class StateErrorFunction(ErrorFunction):
    target_state: torch.Tensor  # (..., nJ, 8) target global skeleton states
    position_weight: torch.Tensor  # (nJ,)
    rotation_weight: torch.Tensor  # (nJ,)
    pos_wgt: torch.Tensor  # scalar posWgt_
    rot_wgt: torch.Tensor  # scalar rotWgt_
    weight: torch.Tensor
    rotation_error_type: str = "matrix"  # "matrix" | "logmap"

    @property
    def has_analytic_jacobian(self) -> bool:
        return self.rotation_error_type == "matrix"

    def _parts(self, ctx: EvalContext):
        """(position differences (..., nJ, 3), rotation differences (..., nJ, 9 or 3))."""
        t, q = ctx.skel_states[..., :3], ctx.skel_states[..., 3:7]
        t_tgt, q_tgt = self.target_state[..., :3], self.target_state[..., 3:7]
        if self.rotation_error_type == "logmap":
            rot_diff = quat.to_axis_angle(quat.multiply(quat.conjugate(q_tgt), q))
        else:
            rot_diff = quat.to_rotation_matrix(q) - quat.to_rotation_matrix(q_tgt)
            rot_diff = rot_diff.reshape(rot_diff.shape[:-2] + (9,))
        return t - t_tgt, rot_diff

    def _scales(self):
        """(position row scales (nJ,), rotation row scales (nJ,))."""
        pos = torch.sqrt(torch.clamp(self.weight * K_STATE_POSITION_WEIGHT * self.pos_wgt
                                     * self.position_weight, min=0.0))
        rot = torch.sqrt(torch.clamp(self.weight * K_STATE_ORIENTATION_WEIGHT * self.rot_wgt
                                     * self.rotation_weight, min=0.0))
        return pos, rot

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        pos_diff, rot_diff = self._parts(ctx)
        pos_e = torch.sum(self.position_weight * torch.sum(pos_diff ** 2, dim=-1), dim=-1)
        rot_e = torch.sum(self.rotation_weight * torch.sum(rot_diff ** 2, dim=-1), dim=-1)
        return self.weight * (K_STATE_POSITION_WEIGHT * self.pos_wgt * pos_e
                              + K_STATE_ORIENTATION_WEIGHT * self.rot_wgt * rot_e)

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        pos_diff, rot_diff = self._parts(ctx)
        pos_s, rot_s = self._scales()
        return torch.cat([(pos_s[..., None] * pos_diff).flatten(-2),
                          (rot_s[..., None] * rot_diff).flatten(-2)], dim=-1)

    def num_rows(self) -> int:
        return self.target_state.shape[-2] * (3 + (3 if self.rotation_error_type == "logmap"
                                                   else 9))

    def jacobian(self, character, ctx: EvalContext, jc):
        """The "matrix" type's rows: joint origins are world points of their
        own joints, rotation-matrix columns world directions."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian, vector_jacobian

        nj = self.target_state.shape[-2]
        idx = torch.arange(nj, dtype=torch.int32, device=ctx.skel_states.device)
        pos_diff, rot_diff = self._parts(ctx)
        r = quat.to_rotation_matrix(ctx.skel_states[..., 3:7])
        j_pos = point_jacobian(jc, ctx.skel_states[..., :3], idx)  # (..., nJ, 3, nJ·7)
        j_rot = torch.stack([vector_jacobian(jc, r[..., k], idx) for k in range(3)], dim=-2)
        j_rot = j_rot.reshape(j_rot.shape[:-4] + (nj, 9, j_rot.shape[-1]))
        pos_s, rot_s = self._scales()
        rows = torch.cat([(pos_s[:, None] * pos_diff).flatten(-2),
                          (rot_s[:, None] * rot_diff).flatten(-2)], dim=-1)
        j = torch.cat([(pos_s[:, None, None] * j_pos).flatten(-3, -2),
                       (rot_s[:, None, None] * j_rot).flatten(-3, -2)], dim=-2)
        return rows, j, None

    @classmethod
    def create(cls, target_state, position_weight=None, rotation_weight=None, pos_wgt=1.0,
               rot_wgt=1.0, weight=1.0, rotation_error_type="matrix", device="cuda"):
        device = resolve(device, "StateErrorFunction.create")
        target_state = np.asarray(target_state, np.float32)
        nj = target_state.shape[-2]

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(target_state=f(target_state),
                   position_weight=f(np.ones(nj) if position_weight is None
                                     else position_weight),
                   rotation_weight=f(np.ones(nj) if rotation_weight is None
                                     else rotation_weight),
                   pos_wgt=f(pos_wgt), rot_wgt=f(rot_wgt), weight=f(weight),
                   rotation_error_type=rotation_error_type)
