"""Cameras: the pinhole model and its extrinsics."""

from momentum_tpu_torch.camera.models import Camera, PinholeIntrinsics  # noqa: F401
