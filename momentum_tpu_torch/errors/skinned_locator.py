"""Skinned-locator residual modules, after momentum_tpu/errors/skinned_locator.py.
A skinned locator (character/skinned_locator.h:25-47) is a rest-pose point
moved by the skin-weighted blend of up to K joints' skinning matrices:

    world = Σ_k w_k · (T_k · invBind_k) · restPos

  SkinnedLocatorErrorFunction (skinned_locator_error_function.cpp)
      f = world − target                                            (3 rows)
  SkinnedLocatorTriangleErrorFunction
  (skinned_locator_triangle_error_function.h:59-63)
      f = world − (Σ_i bary_i · v_i + depth · n̂) over a triangle of the
      posed mesh, or, sliding, over the candidate triangle whose centroid is
      nearest the locator at each evaluation                       (3 rows)

Neither has an analytic Jacobian, in JAX or here: their rows reach the
solver by forward mode (the solver function's mixed analytic/AD branch),
FK's tangents through kernel K1's jvp rule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.character.character import SkinnedLocators
from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction, pad_rows
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["SkinnedLocatorErrorFunction", "SkinnedLocatorTriangleErrorFunction"]


def _locator_world(ef, character, skel_states: torch.Tensor) -> torch.Tensor:
    """(..., C, 3) world positions of the module's skinned locators."""
    return SkinnedLocators(parents=ef.parents, skin_weights=ef.skin_weights,
                           rest_position=ef.rest_position).world_positions(character,
                                                                          skel_states)


def _tables(device, cap, n, k, parents, skin_weights, rest_position, cweight, **extra):
    """The locator tables (and `extra`, arrays of n rows) as tensors on
    `device`, padded to `cap` rows."""
    cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
    arrays = dict(parents=parents,
                  skin_weights=np.asarray(skin_weights, np.float32).reshape(n, k),
                  rest_position=np.asarray(rest_position, np.float32).reshape(n, 3),
                  cweight=cweight, **extra)
    return {name: torch.as_tensor(pad_rows(a, cap), device=device) for name, a in arrays.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class SkinnedLocatorErrorFunction(VectorErrorFunction):
    parents: torch.Tensor  # (C, K) int32 skinning joints
    skin_weights: torch.Tensor  # (C, K)
    rest_position: torch.Tensor  # (C, 3) in the rest pose
    target: torch.Tensor  # (..., C, 3) world targets
    cweight: torch.Tensor
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 3

    def constraint_count(self) -> int:
        return self.parents.shape[0]

    def world_positions(self, character, skel_states: torch.Tensor) -> torch.Tensor:
        return _locator_world(self, character, skel_states)

    def raw(self, character, ctx: EvalContext):
        return self.world_positions(character, ctx.skel_states) - self.target, self.cweight

    @classmethod
    def create(cls, parents, skin_weights, rest_position, target, cweight=None, weight=1.0,
               loss=None, capacity=None, device="cuda"):
        device = resolve(device, "SkinnedLocatorErrorFunction.create")
        parents = np.asarray(parents, np.int32)
        n, k = parents.shape
        t = _tables(device, capacity or n, n, k, parents, skin_weights, rest_position, cweight,
                    target=np.asarray(target, np.float32).reshape(n, 3))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss(), **t)


@dataclasses.dataclass(frozen=True, eq=False)
class SkinnedLocatorTriangleErrorFunction(VectorErrorFunction):
    """A skinned locator held to a point of the posed mesh: the target is
    Σ_i bary_i·triangle_vertex_i + depth·triangle_normal, and the rows pull
    the locator and the triangle toward each other (both move with θ).

    Sliding (the reference's candidateTriangles): with `candidates` (C, S)
    triangle indices (-1 pads), each evaluation takes the candidate whose
    centroid is nearest the locator, the first one on a tie."""

    parents: torch.Tensor  # (C, K) locator skinning joints
    skin_weights: torch.Tensor  # (C, K)
    rest_position: torch.Tensor  # (C, 3)
    tri_indices: torch.Tensor  # (C, 3) the reference triangle's vertices
    bary: torch.Tensor  # (C, 3)
    depth: torch.Tensor  # (C,)
    cweight: torch.Tensor
    weight: torch.Tensor
    candidates: Optional[torch.Tensor] = None  # (C, S) triangle indices, -1 pads
    candidate_faces: Optional[torch.Tensor] = None  # (C, S, 3) their vertices
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 3
    needs_mesh = True

    def constraint_count(self) -> int:
        return self.parents.shape[0]

    def _triangle_target(self, vt: torch.Tensor) -> torch.Tensor:
        """Σ bary·v + depth·n̂ of triangles vt (..., C, 3, 3)."""
        p = torch.sum(self.bary[..., None] * vt, dim=-2)
        n = torch.linalg.cross(vt[..., 1, :] - vt[..., 0, :], vt[..., 2, :] - vt[..., 0, :],
                               dim=-1)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
        return p + self.depth[..., None] * n

    def raw(self, character, ctx: EvalContext):
        if ctx.mesh_vertices is None:
            raise ValueError("SkinnedLocatorTriangleErrorFunction needs the posed mesh in the "
                             "context")
        world = _locator_world(self, character, ctx.skel_states)
        verts = ctx.mesh_vertices
        lead = verts.shape[:-2]
        if self.candidate_faces is not None:
            cf = self.candidate_faces
            v = verts.index_select(-2, cf.reshape(-1)).reshape(lead + tuple(cf.shape) + (3,))
            centers = v.mean(dim=-2)  # (..., C, S, 3)
            d2 = torch.sum((centers - world[..., :, None, :]) ** 2, dim=-1)
            d2 = torch.where(self.candidates >= 0, d2, torch.inf)
            best = torch.argmin(d2, dim=-1)  # (..., C)
            idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
            vt = torch.gather(v, -3, idx)[..., 0, :, :]
        else:
            tri = self.tri_indices
            vt = verts.index_select(-2, tri.reshape(-1)).reshape(lead + tuple(tri.shape) + (3,))
        return world - self._triangle_target(vt), self.cweight

    @classmethod
    def create(cls, parents, skin_weights, rest_position, tri_indices, bary, depth=None,
               cweight=None, weight=1.0, loss=None, candidates=None, faces=None,
               capacity=None, device="cuda"):
        device = resolve(device, "SkinnedLocatorTriangleErrorFunction.create")
        parents = np.asarray(parents, np.int32)
        n, k = parents.shape
        cap = capacity or n
        depth = np.zeros(n, np.float32) if depth is None else np.asarray(depth, np.float32)
        t = _tables(device, cap, n, k, parents, skin_weights, rest_position, cweight,
                    tri_indices=np.asarray(tri_indices, np.int32).reshape(n, 3),
                    bary=np.asarray(bary, np.float32).reshape(n, 3), depth=depth)
        if candidates is not None:
            if faces is None:
                raise ValueError("candidates requires the mesh faces array")
            candidates = np.asarray(candidates, np.int32)
            cf = np.asarray(faces, np.int32)[np.maximum(candidates, 0)]
            t.update(candidates=torch.as_tensor(pad_rows(candidates, cap, fill=-1),
                                                device=device),
                     candidate_faces=torch.as_tensor(pad_rows(cf, cap), device=device))
        return cls(weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss(), **t)
