"""Character model: skeleton, parameter transform, limits, locators, FK."""

from momentum_tpu_torch.character.character import Character, Locators  # noqa: F401
from momentum_tpu_torch.character.limits import (  # noqa: F401
    ParameterLimits, make_limits)
from momentum_tpu_torch.character.parameter_transform import ParameterTransform  # noqa: F401
from momentum_tpu_torch.character.skeleton import Skeleton, make_skeleton  # noqa: F401
