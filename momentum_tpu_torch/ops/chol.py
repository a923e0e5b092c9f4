"""K5a and K5b: the entry points of momentum_tpu/ops/chol_pallas.py, which
solve (a + diag(damp)) x = b for B SPD systems in one pass each. Both reach
K2+K3's kernel, damped_chol_solve_kernel (csrc/psd.cu), which computes the
same function in one pass: one system per block, factored in 32-wide panels
with the trailing update per panel, then substituted. ops/psd.py counts its
launches.

    chol_solve          K5a  chol_pallas.py::_kernel :55 via chol_solve_pallas
                             :215 (one system resident in fast memory,
                             factor and substitutions fused)
    chol_solve_blocked  K5b  chol_pallas.py::_kernel_blocked :93 via
                             chol_solve_pallas_blocked :174 (32-wide panels,
                             trailing update per panel: K2's algorithm, which
                             the kernel runs)

The TPU layout rules (n % 8 for K5a, batch padding to the tile) do not
apply. K5b keeps its n % 32 == 0: JAX's blocked kernel factors only n // 32
panels and silently returns a wrong x otherwise; the port raises ValueError
(ROADMAP F6). Pad with `pad_identity`. A pivot that is not > 0 gives an
all-NaN x in every version (ROADMAP F1), where the TPU kernels clamp it.

The plain versions are `torch.linalg.cholesky_ex` + `torch.cholesky_solve`
(ops/psd.py::damped_chol_solve_plain). CPU tensors take them; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.ops import psd

__all__ = ["chol_solve", "chol_solve_plain", "chol_solve_blocked",
           "chol_solve_blocked_plain", "pad_identity", "PANEL"]

PANEL = 32  # panel width of K5b


def chol_solve_plain(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5a's plain version."""
    return psd.damped_chol_solve_plain(a, damp, b)


def chol_solve(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b: a (B, n, n), damp (B, n), b (B, n)
    float32, any n ≤ psd.MAX_N (K5a)."""
    return psd.damped_chol_solve(a, damp, b)


def _check_panels(n: int):
    if n % PANEL:
        raise ValueError(f"chol_solve_blocked takes n a multiple of {PANEL}, got n = {n}: "
                         "pad with pad_identity (ROADMAP F6)")


def chol_solve_blocked_plain(a: torch.Tensor, damp: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """K5b's plain version, with K5b's n % 32 == 0 rule."""
    _check_panels(a.shape[-1])
    return psd.damped_chol_solve_plain(a, damp, b)


def chol_solve_blocked(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b in 32-wide panels (K5b): a (B, n, n),
    damp (B, n), b (B, n), n a multiple of 32 (else ValueError, ROADMAP F6).

    CPU tensors take `chol_solve_blocked_plain`. CUDA tensors launch
    damped_chol_solve_kernel or raise: all three must be float32,
    contiguous, on one device and without grad, with n ≤ psd.MAX_N."""
    _check_panels(a.shape[-1])
    return psd.damped_chol_solve(a, damp, b)


def pad_identity(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor,
                 multiple: int = PANEL):
    """(a, damp, b) padded to the next multiple of `multiple` with identity
    rows and columns, zero damping and zero right-hand side: the padded
    system's x is the original x followed by zeros."""
    n = a.shape[-1]
    m = -(-n // multiple) * multiple
    if m == n:
        return a, damp, b
    ap = a.new_zeros(a.shape[:-2] + (m, m))
    ap[..., :n, :n] = a
    ap[..., range(n, m), range(n, m)] = 1.0
    pad = damp.new_zeros(damp.shape[:-1] + (m - n,))
    return ap, torch.cat([damp, pad], dim=-1), torch.cat([b, pad], dim=-1)
