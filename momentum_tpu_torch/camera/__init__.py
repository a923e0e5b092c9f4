"""Cameras: pinhole, OpenCV and OpenCV fisheye intrinsics, and their extrinsics."""

from momentum_tpu_torch.camera.models import (  # noqa: F401
    Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)
