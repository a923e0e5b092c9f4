"""Small-matrix linear algebra: the damped SPD solve of the LM step.

The solves dispatch as momentum_tpu/math/linalg.py does (:159-219), by one
rule (`ops/psd.py::kernel_takes`, the counterpart of
`psd_solve_pallas_available`): CUDA float32 systems launch
`damped_chol_solve_kernel`, the port of the TPU kernels, at any n up to
`psd.MAX_N` and with a vector or a (..., n, k) right-hand side; CPU tensors
and float64 take `damped_chol_solve_plain`, `torch.linalg.cholesky_ex` +
`torch.cholesky_solve`. Either way a system whose factorization fails comes
back as all-NaN x (ROADMAP F1)."""

from __future__ import annotations

import torch

from momentum_tpu_torch.ops import psd

__all__ = ["damped_psd_solve", "psd_solve"]


def damped_psd_solve(a: torch.Tensor, damp_diag: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Solve (a + diag(damp_diag)) x = b for SPD a (..., n, n), b (..., n) or
    (..., n, k). damp_diag broadcasts against (..., n). Leading dims (or
    none) are flattened into one batch."""
    n = a.shape[-1]
    lead = a.shape[:-2]
    if b.ndim not in (a.ndim - 1, a.ndim) or b.shape[:a.ndim - 1] != lead + (n,):
        raise ValueError(f"expected b of shape (..., {n}) or (..., {n}, k) against a "
                         f"{tuple(a.shape)}, got {tuple(b.shape)}")
    damp = torch.broadcast_to(damp_diag, lead + (n,)).reshape(-1, n)
    a3 = a.reshape(-1, n, n)
    b2 = b.reshape((-1,) + b.shape[a.ndim - 2:])
    if psd.kernel_takes(a3, b2):
        x = psd.damped_chol_solve(a3.contiguous(), damp.contiguous(), b2.contiguous())
    else:
        x = psd.damped_chol_solve_plain(a3, damp, b2)
    return x.reshape(b.shape)


def psd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for SPD a (..., n, n), b (..., n) or (..., n, k)."""
    return damped_psd_solve(a, a.new_zeros(()), b)
