"""Residual modules."""

from momentum_tpu_torch.errors.base import (  # noqa: F401
    ErrorFunction, EvalContext, VectorErrorFunction)
from momentum_tpu_torch.errors.position import PositionErrorFunction  # noqa: F401
