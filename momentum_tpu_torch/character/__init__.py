"""Character model: skeleton, parameter transform, limits, locators, FK, mesh,
skinning, blend shapes and collision geometry."""

from momentum_tpu_torch.character.blend_shape import BlendShape  # noqa: F401
from momentum_tpu_torch.character.character import (  # noqa: F401
    Character, CollisionGeometry, Locators, Mesh)
from momentum_tpu_torch.character.limits import (  # noqa: F401
    ParameterLimits, concat_limits, make_limits)
from momentum_tpu_torch.character.parameter_transform import ParameterTransform  # noqa: F401
from momentum_tpu_torch.character.skeleton import Skeleton, make_skeleton  # noqa: F401
from momentum_tpu_torch.character.skinning import SkinWeights  # noqa: F401
