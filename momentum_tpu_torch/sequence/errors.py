"""Sequence (multi-frame) residual modules, after
momentum_tpu/sequence/errors.py (the reference's
character_sequence_solver/sequence_error_function.h): a residual spanning
`window` W contiguous frames, evaluated on an EvalContext whose tensors
carry a window axis before their own (..., W, ...).

  ModelParametersSequenceErrorFunction
      (model_parameters_sequence_error_function.cpp:31-57):
      error = weight·kMotion·Σ_i (w_i·(θ₁ᵢ − θ₀ᵢ))²             (window 2)
  StateSequenceErrorFunction (state_sequence_error_function.cpp:515-573):
      per joint ‖t₁ − (T_tgt·T₀).t‖²·kPos·posWgt·wᵢ and
      ‖R₁ − R_tgt·R₀‖²·kOrient·rotWgt·wᵢ                          (window 2)
  FiniteDifferenceSequenceErrorFunction
      (finite_difference_sequence_error_function.cpp:64-92):
      per joint ‖Σ_k c_k·pos_k − target‖²·wᵢ, stencil c of length W;
      Acceleration c = [1, −2, 1], Jerk c = [−1, 3, −3, 1]
  VelocityMagnitudeSequenceErrorFunction: per joint
      (‖pos₁ − pos₀‖ − targetMagnitude)²·wᵢ                        (window 2)
  JointToJointSequenceErrorFunction: per constraint the change across the
      window of R_refᵀ(p_src − p_ref)                              (window 2)
  VertexSequenceErrorFunction: per tracked vertex v₁ − v₀ on the posed
      mesh                                                         (window 2)
  SdfCollisionSequenceErrorFunction (sdf_collision_sequence_error_function.cpp):
      per tracked vertex and frame of the window min(sdf(v), 0)   (window 2)

`reads_states` marks the modules that read the skeleton states (False
only for ModelParameters, which reads the model parameters alone), so the
sequence solver's forward-mode Jacobian runs FK only where a module reads
its output. `needs_mesh` marks those that read the posed mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = [
    "SequenceErrorFunction",
    "ModelParametersSequenceErrorFunction",
    "StateSequenceErrorFunction",
    "FiniteDifferenceSequenceErrorFunction",
    "AccelerationSequenceErrorFunction",
    "JerkSequenceErrorFunction",
    "VelocityMagnitudeSequenceErrorFunction",
    "JointToJointSequenceErrorFunction",
    "VertexSequenceErrorFunction",
    "SdfCollisionSequenceErrorFunction",
]

K_MOTION_WEIGHT = 1e-1  # model_parameters_sequence_error_function.h:62
K_SEQ_POSITION_WEIGHT = 1e-3  # state_sequence_error_function.h:113
K_SEQ_ORIENTATION_WEIGHT = 1.0  # state_sequence_error_function.h:114


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _scale(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


class SequenceErrorFunction:
    """Base: subclasses declare `window` and implement residual on a
    window-stacked EvalContext (the window axis before each tensor's own)."""

    window: int = 2
    reads_states: bool = True
    needs_mesh: bool = False

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        raise NotImplementedError

    def error(self, character, ctxs: EvalContext) -> torch.Tensor:
        r = self.residual(character, ctxs)
        return torch.sum(r * r, dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelParametersSequenceErrorFunction(SequenceErrorFunction):
    pweight: torch.Tensor  # (P,) per-parameter weights (inside the square)
    weight: torch.Tensor

    window = 2
    reads_states = False

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        diff = ctxs.model_params[..., 1, :] - ctxs.model_params[..., 0, :]
        return _scale(self.weight * K_MOTION_WEIGHT) * self.pweight * diff

    @classmethod
    def create(cls, num_params=None, pweight=None, weight=1.0, device="cuda"):
        device = resolve(device, "ModelParametersSequenceErrorFunction.create")
        if pweight is None:
            pweight = np.ones(num_params, np.float32)
        return cls(pweight=_f32(pweight, device), weight=_f32(weight, device))


@dataclasses.dataclass(frozen=True, eq=False)
class StateSequenceErrorFunction(SequenceErrorFunction):
    # per-joint offset transform applied to the previous frame (targetState_,
    # state_sequence_error_function.cpp:535-537); identity by default
    target_offset: torch.Tensor  # (nJ, 8)
    position_weight: torch.Tensor  # (nJ,)
    rotation_weight: torch.Tensor  # (nJ,)
    pos_wgt: torch.Tensor
    rot_wgt: torch.Tensor
    weight: torch.Tensor
    rotation_error_type: str = "matrix"

    window = 2

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        prev = ctxs.skel_states[..., 0, :, :]
        nxt = ctxs.skel_states[..., 1, :, :]
        t0, q0, _ = ss.split(ss.multiply(self.target_offset, prev))
        t1, q1, _ = ss.split(nxt)
        pos_diff = t1 - t0
        if self.rotation_error_type == "logmap":
            rot_diff = quat.to_axis_angle(quat.multiply(quat.conjugate(q1), q0))
        else:
            rot_diff = quat.to_rotation_matrix(q1) - quat.to_rotation_matrix(q0)
            rot_diff = rot_diff.reshape(rot_diff.shape[:-2] + (9,))
        pos_s = _scale(self.weight * K_SEQ_POSITION_WEIGHT * self.pos_wgt * self.position_weight)
        rot_s = _scale(self.weight * K_SEQ_ORIENTATION_WEIGHT * self.rot_wgt
                       * self.rotation_weight)
        return torch.cat([
            (pos_s[..., None] * pos_diff).reshape(pos_diff.shape[:-2] + (-1,)),
            (rot_s[..., None] * rot_diff).reshape(rot_diff.shape[:-2] + (-1,)),
        ], dim=-1)

    @classmethod
    def create(cls, num_joints, position_weight=None, rotation_weight=None,
               target_offset=None, pos_wgt=1.0, rot_wgt=1.0, weight=1.0,
               rotation_error_type="matrix", device="cuda"):
        device = resolve(device, "StateSequenceErrorFunction.create")
        ones = np.ones(num_joints, np.float32)
        if target_offset is None:
            target_offset = ss.identity((num_joints,))
        return cls(
            target_offset=_f32(target_offset, device),
            position_weight=_f32(ones if position_weight is None else position_weight, device),
            rotation_weight=_f32(ones if rotation_weight is None else rotation_weight, device),
            pos_wgt=_f32(pos_wgt, device), rot_wgt=_f32(rot_wgt, device),
            weight=_f32(weight, device), rotation_error_type=rotation_error_type)


@dataclasses.dataclass(frozen=True, eq=False)
class FiniteDifferenceSequenceErrorFunction(SequenceErrorFunction):
    stencil: torch.Tensor  # (W,)
    jweight: torch.Tensor  # (nJ,)
    target: torch.Tensor  # (nJ, 3)
    weight: torch.Tensor
    window: int = 3

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        t = ctxs.skel_states[..., :3]  # (..., W, nJ, 3)
        deriv = torch.einsum("k,...kji->...ji", self.stencil, t)
        f = deriv - self.target
        return (_scale(self.weight * self.jweight)[..., None] * f).reshape(f.shape[:-2] + (-1,))

    @classmethod
    def create(cls, stencil, num_joints, jweight=None, target=None, weight=1.0,
               device="cuda"):
        device = resolve(device, "FiniteDifferenceSequenceErrorFunction.create")
        stencil = np.asarray(stencil, np.float32)
        return cls(
            stencil=_f32(stencil, device),
            jweight=_f32(np.ones(num_joints) if jweight is None else jweight, device),
            target=_f32(np.zeros((num_joints, 3)) if target is None else target, device),
            weight=_f32(weight, device), window=len(stencil))


class AccelerationSequenceErrorFunction(FiniteDifferenceSequenceErrorFunction):
    """Stencil [1, −2, 1] (acceleration_sequence_error_function.h:17-24)."""

    @classmethod
    def create(cls, num_joints, jweight=None, target=None, weight=1.0, device="cuda"):
        return FiniteDifferenceSequenceErrorFunction.create(
            [1.0, -2.0, 1.0], num_joints, jweight, target, weight, device)


class JerkSequenceErrorFunction(FiniteDifferenceSequenceErrorFunction):
    """Stencil [−1, 3, −3, 1] (jerk_sequence_error_function.h)."""

    @classmethod
    def create(cls, num_joints, jweight=None, target=None, weight=1.0, device="cuda"):
        return FiniteDifferenceSequenceErrorFunction.create(
            [-1.0, 3.0, -3.0, 1.0], num_joints, jweight, target, weight, device)


@dataclasses.dataclass(frozen=True, eq=False)
class VelocityMagnitudeSequenceErrorFunction(SequenceErrorFunction):
    jweight: torch.Tensor  # (nJ,)
    target_magnitude: torch.Tensor  # scalar or (nJ,)
    weight: torch.Tensor

    window = 2

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        t = ctxs.skel_states[..., :3]
        vel = t[..., 1, :, :] - t[..., 0, :, :]
        mag = torch.linalg.norm(vel + 1e-20, dim=-1)
        return _scale(self.weight * self.jweight) * (mag - self.target_magnitude)

    @classmethod
    def create(cls, num_joints, jweight=None, target_magnitude=0.0, weight=1.0,
               device="cuda"):
        device = resolve(device, "VelocityMagnitudeSequenceErrorFunction.create")
        return cls(jweight=_f32(np.ones(num_joints) if jweight is None else jweight, device),
                   target_magnitude=_f32(target_magnitude, device),
                   weight=_f32(weight, device))


@dataclasses.dataclass(frozen=True, eq=False)
class JointToJointSequenceErrorFunction(SequenceErrorFunction):
    """Relative joint placement across adjacent frames
    (joint_to_joint_sequence_error_function.cpp): per constraint
    rel_f = R_refᵀ(p_src − p_ref) at both frames; f = rel₁ − rel₀ (3 rows)."""

    source: torch.Tensor  # (C,) int32
    reference: torch.Tensor  # (C,) int32
    source_offset: torch.Tensor  # (C, 3)
    reference_offset: torch.Tensor  # (C, 3)
    cweight: torch.Tensor  # (C,)
    weight: torch.Tensor

    window = 2

    def _rel(self, states):
        src = states.index_select(-2, self.source)
        ref = states.index_select(-2, self.reference)
        p_src = ss.transform_points(src, self.source_offset)
        p_ref = ss.transform_points(ref, self.reference_offset)
        return quat.rotate_vector(quat.conjugate(ref[..., 3:7]), p_src - p_ref)

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        f = (self._rel(ctxs.skel_states[..., 1, :, :])
             - self._rel(ctxs.skel_states[..., 0, :, :]))
        return (_scale(self.weight * self.cweight)[..., None] * f).reshape(f.shape[:-2] + (-1,))

    @classmethod
    def create(cls, source, reference, source_offset, reference_offset, cweight=None,
               weight=1.0, device="cuda"):
        device = resolve(device, "JointToJointSequenceErrorFunction.create")
        source = np.asarray(source, np.int32)
        n = source.shape[0]
        return cls(
            source=torch.as_tensor(source, device=device),
            reference=torch.as_tensor(np.asarray(reference, np.int32), device=device),
            source_offset=_f32(np.reshape(source_offset, (n, 3)), device),
            reference_offset=_f32(np.reshape(reference_offset, (n, 3)), device),
            cweight=_f32(np.ones(n) if cweight is None else cweight, device),
            weight=_f32(weight, device))


@dataclasses.dataclass(frozen=True, eq=False)
class VertexSequenceErrorFunction(SequenceErrorFunction):
    """Vertex velocity smoothness (vertex_sequence_error_function.cpp): per
    tracked vertex f = v₁ − v₀ on the posed mesh."""

    vertex_index: torch.Tensor  # (C,) int32
    cweight: torch.Tensor
    weight: torch.Tensor

    window = 2
    needs_mesh = True

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        v = ctxs.mesh_vertices.index_select(-2, self.vertex_index)  # (..., W, C, 3)
        f = v[..., 1, :, :] - v[..., 0, :, :]
        return (_scale(self.weight * self.cweight)[..., None] * f).reshape(f.shape[:-2] + (-1,))

    @classmethod
    def create(cls, vertex_index, cweight=None, weight=1.0, device="cuda"):
        device = resolve(device, "VertexSequenceErrorFunction.create")
        vertex_index = np.asarray(vertex_index, np.int32)
        n = vertex_index.shape[0]
        return cls(vertex_index=torch.as_tensor(vertex_index, device=device),
                   cweight=_f32(np.ones(n) if cweight is None else cweight, device),
                   weight=_f32(weight, device))


@dataclasses.dataclass(frozen=True, eq=False)
class SdfCollisionSequenceErrorFunction(SequenceErrorFunction):
    """Per-frame SDF penetration across the window
    (sdf_collision_sequence_error_function.cpp): f = min(sdf(v), 0) for each
    tracked vertex at each frame of the window. It has a residual only, so
    its rows reach the solver by forward mode."""

    sdf: object  # axel.SignedDistanceField
    vertex_index: torch.Tensor  # (C,) int32
    cweight: torch.Tensor
    weight: torch.Tensor

    window = 2
    needs_mesh = True

    def residual(self, character, ctxs: EvalContext) -> torch.Tensor:
        v = ctxs.mesh_vertices.index_select(-2, self.vertex_index)  # (..., W, C, 3)
        d = self.sdf.sample(v)
        f = torch.minimum(d, d.new_zeros(()))
        return (_scale(self.weight * self.cweight * 5e-3) * f).reshape(f.shape[:-2] + (-1,))

    @classmethod
    def create(cls, sdf, vertex_index, cweight=None, weight=1.0, device="cuda"):
        device = resolve(device, "SdfCollisionSequenceErrorFunction.create")
        vertex_index = np.asarray(vertex_index, np.int32)
        n = vertex_index.shape[0]
        return cls(sdf=sdf, vertex_index=torch.as_tensor(vertex_index, device=device),
                   cweight=_f32(np.ones(n) if cweight is None else cweight, device),
                   weight=_f32(weight, device))
