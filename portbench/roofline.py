"""The card's published peaks and the least time work can take on it.

Frozen copies of momentum_tpu_torch/testing/profile_workload.py's `bound`
and `solve_bound` (commit 45bf5184d6b6a7fbab3c206b266155535e341f3c), in
seconds: an H100 SXM's 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside
the tensor cores (NVIDIA's data sheet, at the full 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for work that moves `nbytes` (each input read once,
    each output written once) and does `flops` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def solve_work(batch: int, n: int, k: int = 1) -> tuple:
    """(bytes, flops) of B damped (n, n) solves with k right-hand sides: a,
    damp and b read, x written; n³/3 flops to factor and 2n² per right-hand
    side to substitute, per system."""
    return 4 * batch * (n * n + n + 2 * n * k), batch * (n ** 3 / 3 + 2 * n * n * k)


def lm_iteration_flops(batch: int, rows: int, n: int) -> float:
    """Float32 operations of the linear algebra one LM iteration must do on
    B elements of `rows` residual rows and n parameters: JᵀJ (2rn²), Jᵀr
    (2rn), the factor (n³/3) and the two substitutions (2n²)."""
    return batch * (2 * rows * n * n + 2 * rows * n + n ** 3 / 3 + 2 * n * n)
