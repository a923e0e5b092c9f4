"""Body-level residual modules, after momentum_tpu/errors/body.py:

  FloorErrorFunction (floor_error_function.cpp:63-122)
      f = mean of the k lowest up-projections of the tracked posed-mesh
          vertices − target height                                  (1 row)
  CenterOfMassErrorFunction (center_of_mass_error_function.cpp:37-79)
      com = Σ m_i · WorldTransform(joint_i) · offset_i / Σ m_i
      f = com − target, optionally projected onto a plane first     (3 rows)
  HeightErrorFunction (height_error_function.cpp:200-220)
      f = extent of the posed mesh along the up axis − target        (1 row)

None has an analytic Jacobian, as in JAX: their rows reach the solver by
forward mode. `weight` may carry a leading frame axis (the tracker's
first-frame calibration constraints, tracking/tracker.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import ErrorFunction, EvalContext
from momentum_tpu_torch.math import skel_state as ss

__all__ = ["FloorErrorFunction", "CenterOfMassErrorFunction", "HeightErrorFunction"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class _ScalarRow(ErrorFunction):
    """A module of one row f = value(ctx) − target: error weight·f²,
    residual sqrt(weight)·f."""

    def _diff(self, ctx: EvalContext) -> torch.Tensor:
        raise NotImplementedError

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        diff = self._diff(ctx)
        return self.weight * diff * diff

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        return (torch.sqrt(torch.clamp(self.weight, min=0.0)) * self._diff(ctx))[..., None]

    def num_rows(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True, eq=False)
class FloorErrorFunction(_ScalarRow):
    vertex_index: torch.Tensor  # (V',) tracked vertices
    up_direction: torch.Tensor  # (3,)
    target_height: torch.Tensor
    weight: torch.Tensor
    k: int = 10

    needs_mesh = True

    def _diff(self, ctx: EvalContext) -> torch.Tensor:
        v = ctx.mesh_vertices.index_select(-2, self.vertex_index.long())
        proj = v @ self.up_direction
        k = min(self.k, self.vertex_index.shape[0])
        lowest = -torch.topk(-proj, k, dim=-1).values
        return torch.mean(lowest, dim=-1) - self.target_height

    @classmethod
    def create(cls, vertex_index, up_direction=(0.0, 1.0, 0.0), target_height=0.0,
               weight=1.0, k=10, device="cuda"):
        device = resolve(device, "FloorErrorFunction.create")
        return cls(vertex_index=torch.as_tensor(np.asarray(vertex_index, np.int32),
                                                device=device),
                   up_direction=_f32(up_direction, device),
                   target_height=_f32(target_height, device), weight=_f32(weight, device),
                   k=k)


@dataclasses.dataclass(frozen=True, eq=False)
class CenterOfMassErrorFunction(ErrorFunction):
    joint_index: torch.Tensor  # (J',) int32
    masses: torch.Tensor  # (J',)
    offsets: torch.Tensor  # (J', 3) local centre-of-mass offsets
    target: torch.Tensor  # (..., 3)
    projection_normal: torch.Tensor  # (3,), used when project_to_plane
    projection_d: torch.Tensor
    weight: torch.Tensor
    project_to_plane: bool = False

    def raw_residual(self, ctx: EvalContext) -> torch.Tensor:
        states = ctx.skel_states.index_select(-2, self.joint_index.long())
        pos = ss.transform_points(states, self.offsets)
        com = torch.einsum("...ji,j->...i", pos, self.masses) / torch.sum(self.masses)
        if self.project_to_plane:
            n = self.projection_normal
            com = com - n * (com @ n - self.projection_d)[..., None]
        return com - self.target

    def error(self, character, ctx: EvalContext) -> torch.Tensor:
        r = self.raw_residual(ctx)
        return self.weight * torch.sum(r * r, dim=-1)

    def residual(self, character, ctx: EvalContext) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.weight, min=0.0))[..., None] * self.raw_residual(ctx)

    def num_rows(self) -> int:
        return 3

    @classmethod
    def create(cls, joint_index, masses, target, offsets=None, weight=1.0,
               projection_normal=(0.0, 1.0, 0.0), projection_d=0.0, project_to_plane=False,
               device="cuda"):
        device = resolve(device, "CenterOfMassErrorFunction.create")
        joint_index = np.asarray(joint_index, np.int32)
        if offsets is None:
            offsets = np.zeros((joint_index.shape[0], 3), np.float32)
        return cls(joint_index=torch.as_tensor(joint_index, device=device),
                   masses=_f32(masses, device), offsets=_f32(offsets, device),
                   target=_f32(target, device),
                   projection_normal=_f32(projection_normal, device),
                   projection_d=_f32(projection_d, device), weight=_f32(weight, device),
                   project_to_plane=project_to_plane)

    @classmethod
    def from_physical_properties(cls, character, target, **kw):
        """The centre-of-mass constraint of the character's bodies
        (character.h:66 physicalProperties): each body's mass at its local
        centre-of-mass offset (center_of_mass_error_function.cpp:46)."""
        pp = character.physical_properties
        if pp is None or pp.num_bodies == 0:
            raise ValueError("character has no physical properties")
        return cls.create(pp.joint_index.cpu().numpy(), pp.mass.cpu().numpy(), target,
                          offsets=pp.center_of_mass_offset.cpu().numpy(), **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class HeightErrorFunction(_ScalarRow):
    up_direction: torch.Tensor  # (3,)
    target_height: torch.Tensor
    weight: torch.Tensor

    needs_mesh = True

    def _diff(self, ctx: EvalContext) -> torch.Tensor:
        proj = ctx.mesh_vertices @ self.up_direction
        height = torch.amax(proj, dim=-1) - torch.amin(proj, dim=-1)
        return height - self.target_height

    @classmethod
    def create(cls, target_height, up_direction=(0.0, 1.0, 0.0), weight=1.0, device="cuda"):
        device = resolve(device, "HeightErrorFunction.create")
        return cls(up_direction=_f32(up_direction, device),
                   target_height=_f32(target_height, device), weight=_f32(weight, device))
