"""The pymomentum.torch / pymomentum.solver surface on native torch, after
momentum_tpu/torch_interop.py.

The JAX package bridges torch tensors into jitted JAX functions (dlpack,
`jax.vjp` inside torch.autograd.Functions). Here the port's functions are
torch already, so each name is an `nn.Module` or a plain function whose
gradients come from autograd: FK through K1's rules (ops/fk.py), and
`solve_ik_torch` through the implicit-function-theorem backward of
solver/diff_ik.py (K2+K3 on the card).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.character.skinning import skin_points
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.solver.gauss_newton import SolverOptions

__all__ = ["Skeleton", "LinearBlendSkinning", "ParameterTransformModule",
           "InverseParameterTransformModule", "solve_ik_torch", "BlendShapeModule",
           "ParameterLimitsModule", "SdfColliderModule", "solve_ik", "residual", "gradient",
           "jacobian", "solve_sequence_ik", "get_solve_ik_statistics",
           "reset_solve_ik_statistics", "get_gradient_statistics",
           "reset_gradient_statistics", "set_num_threads", "transform_pose"]


class Skeleton(nn.Module):
    """FK: model or joint parameters → global skeleton states (..., nJ, 8)
    (pymomentum.torch.character.Skeleton, character.py:28-440)."""

    def __init__(self, character):
        super().__init__()
        self.character = character

    def forward(self, model_parameters: torch.Tensor) -> torch.Tensor:
        return self.character.skeleton_states(model_parameters)

    def joint_parameters_to_skeleton_state(self, joint_parameters: torch.Tensor) -> torch.Tensor:
        return fk.global_skel_states(self.character.skeleton, joint_parameters)


class LinearBlendSkinning(nn.Module):
    """Posed mesh vertices (..., V, 3) from model parameters, the body blend
    shapes applied when the rig drives them
    (pymomentum.torch.character.LinearBlendSkinning, character.py:442-628)."""

    def __init__(self, character):
        super().__init__()
        self.character = character.with_inverse_bind_pose()

    def forward(self, model_parameters: torch.Tensor) -> torch.Tensor:
        char = self.character
        states = char.skeleton_states(model_parameters)
        rest = char.mesh.vertices
        if char.blend_shape is not None and char.blend_shape_param_index is not None:
            index = torch.as_tensor(char.blend_shape_param_index, device=model_parameters.device)
            rest = char.blend_shape.apply(model_parameters.index_select(-1, index))
        return skin_points(char.skin_weights, states, char.inverse_bind_pose, rest)


class ParameterTransformModule(nn.Module):
    """Model → joint parameters (pymomentum.torch.character.ParameterTransform,
    character.py:704)."""

    def __init__(self, character):
        super().__init__()
        self.character = character

    def forward(self, model_parameters: torch.Tensor) -> torch.Tensor:
        return self.character.parameter_transform.apply(model_parameters)


class InverseParameterTransformModule(nn.Module):
    """Joint → model parameters through the pseudo-inverse
    (pymomentum.torch InverseParameterTransform, character.py:759-828)."""

    def __init__(self, character):
        super().__init__()
        self.inverse = character.parameter_transform.inverse()

    def forward(self, joint_parameters: torch.Tensor) -> torch.Tensor:
        return self.inverse.apply(joint_parameters)


class BlendShapeModule(nn.Module):
    """Blend-shape coefficients → vertices (pymomentum.torch.character.BlendShape)."""

    def __init__(self, blend_shape):
        super().__init__()
        self.blend_shape = blend_shape

    def forward(self, coefficients: torch.Tensor) -> torch.Tensor:
        return self.blend_shape.apply(coefficients)


class ParameterLimitsModule(nn.Module):
    """Differentiable parameter-limit penalties
    (pymomentum/torch/parameter_limits.py): forward() is the total limit
    energy; evaluate_by_type() splits it per record type, in the order of
    the reference's evaluate_*_error methods."""

    _TYPE_ORDER = ("minmax", "minmax_joint", "linear", "linear_joint", "halfplane",
                   "ellipsoid")

    def __init__(self, character, weight: float = 1.0):
        super().__init__()
        from momentum_tpu_torch.errors import LimitErrorFunction
        from momentum_tpu_torch.solver import SkeletonSolverFunction

        self.character = character
        device = character.parameter_transform.transform.device
        self.error_function = LimitErrorFunction.create(weight=weight, device=device)
        self.solver_function = SkeletonSolverFunction(character, (self.error_function,))
        counts = character.limits.counts
        self._present = tuple(name for name in self._TYPE_ORDER if counts[name])

    def forward(self, model_parameters: torch.Tensor) -> torch.Tensor:
        return self.solver_function.error(model_parameters)

    def evaluate_by_type(self, model_parameters: torch.Tensor) -> dict:
        """dict type name → its weighted energy (...,), as
        LimitErrorFunction.error scales it (kLimitWeight · weight · Σ w·ρ)."""
        from momentum_tpu_torch.errors.limit import K_LIMIT_WEIGHT

        ef = self.error_function
        ctx = self.solver_function.context(model_parameters)
        pieces = ef._pieces(self.character, ctx)
        return {name: K_LIMIT_WEIGHT * ef.weight
                * torch.sum(w * ef.loss.value(torch.sum(f * f, dim=-1)), dim=-1)
                for name, (f, w) in zip(self._present, pieces)}


class SdfColliderModule(nn.Module):
    """Differentiable SDF evaluation of world points against a collider
    rigidly attached to a joint (pymomentum/torch/sdf_collision.py
    SDFCollider): the points go into the collider joint's frame through the
    skeleton states, then are trilinearly sampled; autograd reaches both
    inputs. A batched call's states (..., nJ, 8) take the points' own batch
    (..., N, 3) (JAX's form holds unbatched only, ROADMAP F23)."""

    def __init__(self, sdf, parent: int = -1):
        super().__init__()
        self.sdf = sdf
        self.parent = parent

    def forward(self, skel_states: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        if self.parent >= 0:
            frame = ss.inverse(skel_states[..., self.parent, :])[..., None, :]
            points = ss.transform_points(frame, points)
        return self.sdf.sample(points)

    evaluate = forward


def solve_ik_torch(build_solver_fn, x0: torch.Tensor, inputs: dict,
                   options: Optional[SolverOptions] = None, method: str = "gauss_newton",
                   enabled_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable batched IK (tensor_ik.h:20-100, solver_pybind.cpp
    solve_ik): θ* of the problem `build_solver_fn(inputs)` from x0 (..., P),
    by solve_ik_ift. Gradients flow to the tensors of `inputs` (name →
    tensor: targets, weights, offsets, ...) by the implicit function
    theorem, and to x0 through the parameters enabled_mask disables (JAX's
    takes no mask: every parameter enabled)."""
    from momentum_tpu_torch.solver.diff_ik import solve_ik_ift

    fn = build_solver_fn(dict(inputs))
    return solve_ik_ift(fn, x0, enabled_mask, options or SolverOptions(), method)


solve_ik = solve_ik_torch  # the binding's name

_stats = {"n_solve_ik": 0, "n_solve_ik_batch": 0, "n_gradient": 0, "n_gradient_batch": 0}


def residual(build_solver_fn, params: torch.Tensor, inputs: dict) -> torch.Tensor:
    """Weighted residual rows of an IK problem at `params`."""
    return build_solver_fn(dict(inputs)).residual(params)


def gradient(build_solver_fn, params: torch.Tensor, inputs: dict) -> torch.Tensor:
    """dE/dθ of an IK problem at `params` (..., P), per element."""
    g = build_solver_fn(dict(inputs)).gradient(params)
    _stats["n_gradient"] += 1
    _stats["n_gradient_batch"] += math.prod(params.shape[:-1]) or 1
    return g


def jacobian(build_solver_fn, params: torch.Tensor, inputs: dict):
    """(rows (..., R), d rows/dθ (..., R, P)) of an IK problem at `params`."""
    return build_solver_fn(dict(inputs)).residual_and_jacobian(params)


def transform_pose(character, model_params: torch.Tensor, xform: torch.Tensor) -> torch.Tensor:
    """Model parameters rigidly retargeted by a world transform (solver_pybind
    transform_pose → transform_pose.h:19): `xform` an (8,) skel_state or a
    (4, 4) matrix [s·R | t]."""
    from momentum_tpu_torch.character.transform_pose import transform_pose as impl

    if xform.shape[-2:] == (4, 4):
        xform = ss.from_matrix(xform)
    return impl(character, model_params, xform)


def solve_sequence_ik(build_sequence_fn, per_frame_params: torch.Tensor,
                      universal_params: torch.Tensor, inputs: dict,
                      options: Optional[SolverOptions] = None):
    """Sequence IK (solver_pybind solve_sequence_ik): (per_frame,
    universal) after the banded sequence solve; forward only, as the
    reference's."""
    from momentum_tpu_torch.sequence.solver import solve_sequence

    fn = build_sequence_fn(dict(inputs))
    res = solve_sequence(fn, per_frame_params, universal_params,
                         options or SolverOptions())
    return res.per_frame, res.universal


def get_solve_ik_statistics() -> dict:
    """The IK call counters (tensor_ik.cpp:178-180 nTotalSolveIK /
    nTotalSolveIKIter)."""
    from momentum_tpu_torch.solver.ik import get_solve_counters

    out = dict(get_solve_counters())
    out.update({k: v for k, v in _stats.items() if k.startswith("n_solve")})
    return out


def reset_solve_ik_statistics() -> None:
    from momentum_tpu_torch.solver.ik import reset_solve_counters

    reset_solve_counters()
    _stats["n_solve_ik"] = _stats["n_solve_ik_batch"] = 0


def get_gradient_statistics() -> dict:
    return {k: v for k, v in _stats.items() if "gradient" in k}


def reset_gradient_statistics() -> None:
    _stats["n_gradient"] = _stats["n_gradient_batch"] = 0


def set_num_threads(n: int) -> None:
    """Size torch's CPU thread pool (solver_pybind set_num_threads sizes
    the reference's; JAX's is a no-op, XLA owning its threads)."""
    torch.set_num_threads(n)
