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
from momentum_tpu_torch.device import resolve

__all__ = ["ParameterTransform", "InverseParameterTransform", "make_identity_transform"]


@dataclasses.dataclass(frozen=True, eq=False)
class ParameterTransform:
    """transform: (nJointParams, nModelParams); offsets: (nJointParams,);
    parameter_sets: named parameter sets (the reference's ParameterSets) as
    name -> tuple of model-parameter indices; pose_constraints: named pose
    presets (parameter_transform.h poseConstraints) as
    name -> ((parameter index, value), ...)."""

    transform: torch.Tensor
    offsets: torch.Tensor
    names: tuple = ()
    parameter_sets: dict = dataclasses.field(default_factory=dict)
    pose_constraints: dict = dataclasses.field(default_factory=dict)

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

    def parameter_index(self, name: str) -> int:
        return self.names.index(name)

    def parameter_set_mask(self, set_name: str) -> torch.Tensor:
        """float 0/1 mask over the model parameters of a named set, on the
        transform's device."""
        m = torch.zeros(self.num_model_parameters, dtype=torch.float32,
                        device=self.transform.device)
        m[list(self.parameter_sets[set_name])] = 1.0
        return m

    def active_joint_params(self, enabled: torch.Tensor | None = None) -> torch.Tensor:
        """bool (nJ*7,): the joint parameters driven by any (enabled) model
        parameter (parameter_transform.h computeActiveJointParams)."""
        pattern = self.transform.abs() > 0
        if enabled is None:
            return pattern.any(dim=1)
        enabled = torch.as_tensor(enabled, device=self.transform.device)
        return (pattern.float() @ enabled.float()) > 0

    # ---- pymomentum.geometry.ParameterTransform's surface
    # (parameter_transform_pybind.cpp:176-244): boolean numpy masks ----

    @property
    def size(self) -> int:
        return self.num_model_parameters

    @property
    def all_parameters(self) -> np.ndarray:
        return np.ones(self.num_model_parameters, bool)

    @property
    def no_parameters(self) -> np.ndarray:
        return np.zeros(self.num_model_parameters, bool)

    def _name_mask(self, pred) -> np.ndarray:
        return np.asarray([pred(n) for n in self.names], bool)

    @property
    def scaling_parameters(self) -> np.ndarray:
        """Names containing 'scale_' (parameter_transform.cpp:157-167)."""
        return self._name_mask(lambda n: "scale_" in n)

    @property
    def rigid_parameters(self) -> np.ndarray:
        """Names containing 'root_' or 'hips' (parameter_transform.cpp:173-183)."""
        return self._name_mask(lambda n: "root_" in n or "hips" in n)

    @property
    def blend_shape_parameters(self) -> np.ndarray:
        """The 'blend_<i>' coefficients (addBlendShapeParameters' names)."""
        return self._name_mask(lambda n: n.startswith("blend_"))

    @property
    def face_expression_parameters(self) -> np.ndarray:
        """The 'face_expre_<i>' coefficients."""
        return self._name_mask(lambda n: n.startswith("face_expre_"))

    @property
    def pose_parameters(self) -> np.ndarray:
        """All but the scaling, blend-shape and face-expression parameters
        (parameter_transform.cpp:217-219 getPoseParameters)."""
        return (self.all_parameters & ~self.scaling_parameters & ~self.blend_shape_parameters
                & ~self.face_expression_parameters)

    def find_parameters(self, names, allow_missing: bool = False) -> np.ndarray:
        """Boolean mask of the named parameters; ValueError on a missing name
        unless allow_missing (parameter_transform_pybind.cpp:232-244)."""
        mask = np.zeros(self.num_model_parameters, bool)
        for n in names:
            if n in self.names:
                mask[self.names.index(n)] = True
            elif not allow_missing:
                raise ValueError(f"parameter {n!r} not in transform")
        return mask

    def parameters_for_joints(self, joint_indices) -> np.ndarray:
        """Boolean mask of the parameters driving any of the given joints
        (parameter_transform_pybind.cpp:221-230)."""
        tf = self.transform.detach().cpu().numpy()
        mask = np.zeros(self.num_model_parameters, bool)
        for j in joint_indices:
            rows = tf[int(j) * PARAMS_PER_JOINT:(int(j) + 1) * PARAMS_PER_JOINT]
            mask |= (np.abs(rows) > 0).any(axis=0)
        return mask

    def add_parameter_set(self, name: str, parameters) -> "ParameterTransform":
        """A new transform with the named set added; `parameters` is a
        boolean mask or an index list (pybind add_parameter_set)."""
        arr = np.asarray(parameters)
        idx = (tuple(np.nonzero(arr)[0].tolist()) if arr.dtype == bool
               else tuple(int(i) for i in arr))
        return dataclasses.replace(self, parameter_sets={**self.parameter_sets, name: idx})

    def parameter_set(self, name: str) -> np.ndarray:
        """Boolean mask of a named set (pybind parameter_set)."""
        mask = np.zeros(self.num_model_parameters, bool)
        mask[list(self.parameter_sets[name])] = True
        return mask

    def pinv(self) -> torch.Tensor:
        """(nP, nJ*7) pseudo-inverse for the joint → model mapping
        (inverse_parameter_transform.h): computed by numpy on the host, as
        JAX's, on the first call, and kept on the transform's device for
        every later call on this transform."""
        cached = self.__dict__.get("_pinv")
        if cached is None:
            pinv = np.linalg.pinv(self.transform.detach().cpu().numpy())
            with torch.inference_mode(False):
                cached = torch.as_tensor(pinv, dtype=self.transform.dtype,
                                         device=self.transform.device)
            object.__setattr__(self, "_pinv", cached)
        return cached

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


def make_identity_transform(num_joints: int, dtype=torch.float32,
                            device="cuda") -> ParameterTransform:
    """One model parameter per joint parameter, named p0, p1, ...; on the
    card unless the caller asks for the CPU."""
    device = resolve(device, "make_identity_transform")
    n = num_joints * PARAMS_PER_JOINT
    return ParameterTransform(transform=torch.eye(n, dtype=dtype, device=device),
                              offsets=torch.zeros(n, dtype=dtype, device=device),
                              names=tuple(f"p{i}" for i in range(n)))
