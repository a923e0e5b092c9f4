"""Fixtures and the bench.py IK workload."""
from momentum_tpu_torch.testing.fixtures import create_test_character  # noqa: F401
