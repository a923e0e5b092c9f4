"""ParameterTransform: model parameters → joint parameters
(parameter_transform.h:34-62), stored dense as in
momentum_tpu/character/parameter_transform.py:

    joint_parameters = transform · model_parameters + offsets
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT

__all__ = ["ParameterTransform", "InverseParameterTransform"]


@dataclasses.dataclass(frozen=True, eq=False)
class ParameterTransform:
    """transform: (nJointParams, nModelParams); offsets: (nJointParams,);
    parameter_sets: named parameter sets (the reference's ParameterSets) as
    name -> tuple of model-parameter indices."""

    transform: torch.Tensor
    offsets: torch.Tensor
    names: tuple = ()
    parameter_sets: dict = dataclasses.field(default_factory=dict)

    @property
    def num_model_parameters(self) -> int:
        return self.transform.shape[1]

    @property
    def num_joint_parameters(self) -> int:
        return self.transform.shape[0]

    @property
    def num_joints(self) -> int:
        return self.num_joint_parameters // PARAMS_PER_JOINT

    def apply(self, model_params: torch.Tensor) -> torch.Tensor:
        """(..., nP) → (..., nJ*7): one dense matmul (parameter_transform.cpp:110)."""
        return model_params @ self.transform.T + self.offsets

    def pinv(self) -> torch.Tensor:
        """(nP, nJ*7) pseudo-inverse for the joint → model mapping
        (inverse_parameter_transform.h), computed once on the host by
        numpy, as JAX's, and returned on the transform's device."""
        pinv = np.linalg.pinv(self.transform.detach().cpu().numpy())
        return torch.as_tensor(pinv, dtype=self.transform.dtype, device=self.transform.device)

    def inverse(self) -> "InverseParameterTransform":
        """The least-squares joint → model inverse (pybind
        ParameterTransform.inverse)."""
        return InverseParameterTransform(self)


class InverseParameterTransform:
    """Joint parameters → model parameters through the pseudo-inverse
    (inverse_parameter_transform.h): apply() gives the θ minimizing
    ‖T·θ + offsets − joint_params‖²."""

    def __init__(self, parameter_transform: ParameterTransform):
        self.parameter_transform = parameter_transform
        self._pinv = parameter_transform.pinv()

    def apply(self, joint_params: torch.Tensor) -> torch.Tensor:
        """(..., nJ*7) → (..., nP)."""
        return (joint_params - self.parameter_transform.offsets) @ self._pinv.T
