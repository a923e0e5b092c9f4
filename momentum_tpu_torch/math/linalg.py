"""Small-matrix linear algebra: the damped SPD solve of the LM step.

CUDA tensors go through `damped_chol_solve_kernel` (ops/psd.py, the port of
the TPU kernels that momentum_tpu/math/linalg.py dispatches at :167-175);
CPU tensors take its plain version, `torch.linalg.cholesky_ex` +
`torch.cholesky_solve`. Either way a system whose factorization fails comes
back as all-NaN x (ROADMAP F1).
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.ops import psd

__all__ = ["damped_psd_solve", "psd_solve"]


def damped_psd_solve(a: torch.Tensor, damp_diag: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Solve (a + diag(damp_diag)) x = b for SPD a (..., n, n), b (..., n).
    damp_diag broadcasts against (..., n). Leading dims (or none) are
    flattened into the kernel's batch."""
    n = a.shape[-1]
    if b.shape[-1:] != (n,) or b.ndim != a.ndim - 1:
        raise ValueError(f"expected b of shape (..., {n}) against a "
                         f"{tuple(a.shape)}; matrix right-hand sides are not ported")
    lead = a.shape[:-2]
    x = psd.damped_chol_solve(
        a.reshape(-1, n, n).contiguous(),
        torch.broadcast_to(damp_diag, lead + (n,)).reshape(-1, n).contiguous(),
        b.reshape(-1, n).contiguous())
    return x.reshape(lead + (n,))


def psd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for SPD a (..., n, n), b (..., n)."""
    return damped_psd_solve(a, a.new_zeros(()), b)
