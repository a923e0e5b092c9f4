"""Blend shapes: shape = base + Σ w_i · shapeVector_i, after
momentum_tpu/character/blend_shape.py (blend_shape_base.h:15-61,
blend_shape.h:19-63). The basis is stored as (K, V, 3); applying it is one
matmul. io/shape.py loads and saves a basis.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["BlendShape"]


@dataclasses.dataclass(frozen=True, eq=False)
class BlendShape:
    base_shape: torch.Tensor  # (V, 3)
    shape_vectors: torch.Tensor  # (K, V, 3)

    @property
    def num_shapes(self) -> int:
        return self.shape_vectors.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.base_shape.shape[0]

    def apply(self, coefficients: torch.Tensor) -> torch.Tensor:
        """(..., K) → (..., V, 3): base + coeffs · basis (computeShape)."""
        return self.base_shape + self.compute_deltas(coefficients)

    def compute_deltas(self, coefficients: torch.Tensor) -> torch.Tensor:
        """Offsets only (no base), used when composing with face expressions."""
        return torch.einsum("...k,kvi->...vi", coefficients, self.shape_vectors)

    def estimate_coefficients(self, vertices: torch.Tensor,
                              regularization: float = 1.0) -> torch.Tensor:
        """Ridge least-squares fit of the coefficients to target vertices
        (..., V, 3) (blend_shape.h estimateCoefficients)."""
        k = self.num_shapes
        basis = self.shape_vectors.reshape(k, -1)  # (K, 3V)
        target = (vertices - self.base_shape).reshape(vertices.shape[:-2] + (-1,))
        ata = basis @ basis.T + regularization * torch.eye(k, dtype=basis.dtype,
                                                           device=basis.device)
        atb = torch.einsum("kd,...d->...k", basis, target)
        return torch.linalg.solve(ata, atb[..., None])[..., 0]
