"""momentum_tpu_torch — the PyTorch/CUDA port of momentum_tpu for NVIDIA Hopper.

Modules keep the paths and names of their `momentum_tpu` counterparts
(`momentum_tpu_torch/character/fk.py` ↔ `momentum_tpu/character/fk.py`, ...)
and hold plain functions on tensors plus small dataclasses for the character
and the error functions. The TPU's Pallas kernels become hand-written CUDA
kernels under `csrc/`, built at first use by `ops/build.py`; every kernel's
wrapper takes its plain PyTorch version for CPU tensors.

This package imports torch and never jax (nor `momentum_tpu`, which does).
"""

__version__ = "0.1.0"

import torch as _torch

# IK needs f32-accurate products: TF32 keeps ~3 decimal digits, and a
# lower-precision JᵀJ stalls LM convergence (docs/BENCHMARKS.md:203-256,
# 413-421 record the JAX package's measurements). Mirrors the JAX package's
# `jax_default_matmul_precision = "highest"` (momentum_tpu/__init__.py:24-27).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from momentum_tpu_torch.math import quaternion, skel_state  # noqa: E402,F401
