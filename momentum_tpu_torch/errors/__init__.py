"""Residual modules."""

from momentum_tpu_torch.errors.base import (  # noqa: F401
    ErrorFunction, EvalContext, VectorErrorFunction)
from momentum_tpu_torch.errors.body import (  # noqa: F401
    CenterOfMassErrorFunction, FloorErrorFunction, HeightErrorFunction)
from momentum_tpu_torch.errors.geometric import PlaneErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.limit import LimitErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.pose_prior import Mppca, PosePriorErrorFunction  # noqa: F401
from momentum_tpu_torch.errors.position import (  # noqa: F401
    ModelParametersErrorFunction, OrientationErrorFunction, PositionErrorFunction)
from momentum_tpu_torch.errors.vertex import (  # noqa: F401
    VertexNormalErrorFunction, VertexPlaneErrorFunction, VertexPositionErrorFunction,
    VertexProjectionErrorFunction)
