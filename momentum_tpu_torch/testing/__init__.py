"""Fixtures and the bench.py IK workload."""
