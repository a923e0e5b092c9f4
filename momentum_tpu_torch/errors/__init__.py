"""Residual modules."""

from momentum_tpu_torch.errors.base import (  # noqa: F401
    ErrorFunction, EvalContext, UnionErrorFunction, VectorErrorFunction)
from momentum_tpu_torch.errors.body import (  # noqa: F401
    CenterOfMassErrorFunction, FloorErrorFunction, HeightErrorFunction)
from momentum_tpu_torch.errors.camera_projection import (  # noqa: F401
    CameraProjectionErrorFunction)
from momentum_tpu_torch.errors.collision import (  # noqa: F401
    CollisionErrorFunction, PlaneCollisionErrorFunction, compute_valid_pairs)
from momentum_tpu_torch.errors.geometric import (  # noqa: F401
    AimDirErrorFunction, AimDistErrorFunction, DistanceErrorFunction,
    FixedAxisAngleErrorFunction, FixedAxisCosErrorFunction, FixedAxisDiffErrorFunction,
    NormalErrorFunction, PlaneErrorFunction, ProjectionErrorFunction)
from momentum_tpu_torch.errors.joint_pair import (  # noqa: F401
    JointToJointDistanceErrorFunction, JointToJointOrientationErrorFunction,
    JointToJointPositionErrorFunction)
from momentum_tpu_torch.errors.limit import LimitErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.pose_prior import Mppca, PosePriorErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.position import (  # noqa: F401
    ModelParametersErrorFunction, OrientationErrorFunction, PositionErrorFunction)
from momentum_tpu_torch.errors.sdf import (  # noqa: F401
    SdfCollisionErrorFunction, VertexSdfErrorFunction)
from momentum_tpu_torch.errors.skinned_locator import (  # noqa: F401
    SkinnedLocatorErrorFunction, SkinnedLocatorTriangleErrorFunction)
from momentum_tpu_torch.errors.state import StateErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.vertex import (  # noqa: F401
    CameraVertexProjectionErrorFunction, PointTriangleVertexErrorFunction,
    VertexNormalErrorFunction, VertexPlaneErrorFunction, VertexPositionErrorFunction,
    VertexProjectionErrorFunction, VertexVertexDistanceErrorFunction)
