"""Geometric residual modules, after momentum_tpu/errors/geometric.py:

  PlaneErrorFunction (plane_error_function.cpp:51-66)
      f_c = (WorldTransform(parent_c) · offset_c) · normal_c − d_c   (1 row)
      half_plane: f_c = min(f_c, 0), only the negative side counts

The plane is the floor of the marker tracker (equality pins and half-plane
non-penetration, tracking/tracker.py). It has no analytic Jacobian, as in
JAX: its rows reach the solver by forward mode. The other eight modules of
the JAX file come with the rest of the error catalog (ROADMAP M3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.position import _pad_rows
from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss

__all__ = ["PlaneErrorFunction"]


@dataclasses.dataclass(frozen=True, eq=False)
class PlaneErrorFunction(VectorErrorFunction):
    """Point-to-plane constraints; kLegacyWeight 1e-4 is the caller's
    (plane_error_function.h:86)."""

    parent: torch.Tensor  # (C,) int32
    offset: torch.Tensor  # (C, 3) point in the joint-local frame
    normal: torch.Tensor  # (C, 3) world-space plane normal
    d: torch.Tensor  # (C,) plane offset along the normal
    cweight: torch.Tensor  # (..., C) per-constraint weight (0 = padding)
    weight: torch.Tensor
    half_plane: bool = False
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def constraint_count(self) -> int:
        return self.parent.shape[0]

    def raw(self, character, ctx: EvalContext):
        parents = self.parent.clamp(0, ctx.skel_states.shape[-2] - 1)  # ROADMAP F3
        p = ss.transform_points(ctx.skel_states.index_select(-2, parents), self.offset)
        val = torch.sum(p * self.normal, dim=-1) - self.d
        if self.half_plane:
            val = torch.clamp(val, max=0.0)
        return val[..., None], self.cweight

    @classmethod
    def create(cls, parent, offset, normal, d, cweight=None, weight=1.0, half_plane=False,
               loss=None, capacity=None, device="cuda"):
        device = resolve(device, "PlaneErrorFunction.create")
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        cweight = np.ones(n, np.float32) if cweight is None else np.asarray(cweight, np.float32)
        cap = capacity or n

        def t(x):
            return torch.as_tensor(_pad_rows(x, cap), device=device)

        return cls(parent=t(parent), offset=t(np.asarray(offset, np.float32).reshape(n, 3)),
                   normal=t(np.asarray(normal, np.float32).reshape(n, 3)),
                   d=t(np.asarray(d, np.float32).reshape(n)), cweight=t(cweight),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   half_plane=half_plane, loss=loss or GeneralizedLoss())
