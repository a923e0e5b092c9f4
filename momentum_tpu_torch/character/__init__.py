"""Character model: skeleton, parameter transform, limits, locators, FK, mesh,
skinning, blend shapes, skinned locators, collision geometry and bodies."""

from momentum_tpu_torch.character import fk  # noqa: F401
from momentum_tpu_torch.character.blend_shape import BlendShape  # noqa: F401
from momentum_tpu_torch.character.character import (  # noqa: F401
    Character, CollisionGeometry, Locators, Mesh, PhysicalProperties, SkinnedLocators)
from momentum_tpu_torch.character.limits import (  # noqa: F401
    ParameterLimits, concat_limits, make_empty_limits, make_limits)
from momentum_tpu_torch.character.parameter_transform import (  # noqa: F401
    ParameterTransform, make_identity_transform)
from momentum_tpu_torch.character.skeleton import (  # noqa: F401
    INVALID_INDEX, PARAMS_PER_JOINT, Skeleton, make_skeleton)
from momentum_tpu_torch.character.skinning import (  # noqa: F401
    MAX_SKIN_JOINTS, SkinWeights, apply_ssd, skin_points)
