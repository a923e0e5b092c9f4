"""K2+K3: batched damped Cholesky solve — `damped_chol_solve_kernel`, and
for k > 1 right-hand sides `damped_chol_subst_kernel` after it
(csrc/psd.cu).

One kernel replaces two TPU kernels of momentum_tpu/ops/psd_pallas.py:
`_panel_kernel` (:53, K2: per-panel Cholesky and triangular inverse Linv)
and `_subst_kernel` (:120, K3: blocked forward and back substitution with
the Linv blocks). On the H100 one (n, n) system fits in one block's shared
memory, so for a vector right-hand side the block factors and substitutes
without writing the factor to device memory.

Its bound is bytes: B·n²·4 read once, 61 µs at B = 2048, n = 157 (3.35
TB/s), above the 39 µs of its B·n³/3 flops. What holds it back is latency:
one system per block. The kernel therefore runs K2's algorithm in 32-wide
panels with lookahead. Warp 0 factors each diagonal block in registers and
forms its inverse Linv, while the other warps finish the previous panel's
trailing update. All warps compute L21 = A21·Linvᵀ and the trailing update
as 4 × 4 register-tile products. The substitutions are 32-wide
matrix-vector products with Linv. Shared memory holds only the lower block
triangle, packed, so three systems of n ≤ 160 share an SM; it comes in by
cp.async, and warp 0 factors the first diagonal block while the rest
arrives. The note at the top of csrc/psd.cu has the details.

The kernel pads the system to a multiple of 32 rows in shared memory up to
n = 288 (the full-body rig has n = 157); from n = 289 to MAX_N the same code
keeps the matrix in a device workspace (ROADMAP F7).

A (B, n, k) right-hand side with k > 1 (the SPIKE steps of the sequence
paths: (32, 156) with k = 470 on config 5f) takes two kernels, launched by
the same call: the factor kernel leaves each system's factor, stored
symmetric, in a workspace, and `damped_chol_subst_kernel` substitutes
blocks of 32 columns of one system each, as JAX's `_solve_panels`
(psd_pallas.py:262-282) does: per panel a 32 × 32 product with Linv, then a
right-looking register-tile product with L21 that reuses each factor entry
across the block's columns. Its bound is B·(n³/3 + 2n²k) flops at 67
TFLOP/s (`testing/profile_workload.py::solve_bound`).

`damped_chol_solve_plain` is the plain PyTorch version:
`torch.linalg.cholesky_ex` + `torch.cholesky_solve`, for any n, dtype and
(B, n) or (B, n, k) right-hand side. Both versions give an all-NaN x for a
system whose factorization meets a pivot that is not > 0 (ROADMAP F1: the
JAX CPU path's behaviour, not the TPU kernels' clamp).

`kernel_takes` is the rule by which math/linalg.py chooses between the two.
"""

from __future__ import annotations

import ctypes

import torch

from momentum_tpu_torch.ops import build

__all__ = ["KERNELS", "damped_chol_solve", "damped_chol_solve_plain", "check_system",
           "kernel_takes", "launches"]

# calls that launched K2+K3 in this process (one for the two kernels of k > 1)
launches = 0
# the kernels of one call: the first alone for k = 1, both in turn for k > 1
KERNELS = ("damped_chol_solve_kernel", "damped_chol_subst_kernel")

MAX_N = 4096  # csrc/psd.cu kMaxN: one block a system, whose time grows as n³
MAX_SHARED_N = 288  # csrc/psd.cu kMaxSharedN: the packed triangle fits in shared memory
PANEL = 32  # csrc/psd.cu kPanel


def damped_chol_solve_plain(a: torch.Tensor, damp: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b; a (B, n, n), damp (B, n), b (B, n) or
    (B, n, k)."""
    vec = b.ndim == a.ndim - 1
    l, info = torch.linalg.cholesky_ex(a + torch.diag_embed(damp))
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, l)
    x = torch.where((info != 0)[..., None, None], torch.full_like(x, float("nan")), x)
    return x.squeeze(-1) if vec else x


def check_system(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor,
                 kernel: str) -> tuple:
    """(B, n, k) of a batch of damped systems that `kernel` can take, with k
    right-hand sides (1 for b (B, n)), or raise."""
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected a of shape (B, n, n), got {tuple(a.shape)}")
    batch, n = a.shape[0], a.shape[1]
    if damp.shape != (batch, n):
        raise ValueError(f"expected damp of shape {(batch, n)}, got {tuple(damp.shape)}")
    if b.shape[:2] != (batch, n) or b.ndim not in (2, 3):
        raise ValueError(f"expected b of shape {(batch, n)} or {(batch, n)} + (k,), "
                         f"got {tuple(b.shape)}")
    for t in (a, damp, b):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != a.device):
            raise ValueError(f"{kernel} takes contiguous float32 tensors on one CUDA device")
        if t.requires_grad:
            raise RuntimeError(f"{kernel} has no backward: call it on tensors without grad")
    return batch, n, b.shape[2] if b.ndim == 3 else 1


def kernel_takes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether math/linalg.py sends the systems a (..., n, n) with right-hand
    sides b to damped_chol_solve_kernel: a CUDA float32 a. The rest, CPU
    tensors and float64 (which the kernel's f32 arithmetic would not honour),
    take `damped_chol_solve_plain`. Decided from the device and dtype before
    any launch; inside the domain the kernel launches or raises.

    The counterpart of momentum_tpu/ops/psd_pallas.py::
    psd_solve_pallas_available (:41), which gives JAX's TPU kernel every
    batched n ≥ 64 with B a multiple of 32, a matrix right-hand side
    included (its system is factored by K2, :301-311). This kernel has
    neither the minimum n nor the lane layout that asks for whole groups of
    32 systems, so it also takes what JAX leaves to XLA on the TPU; a
    matrix right-hand side goes to damped_chol_subst_kernel after the
    factor."""
    return a.is_cuda and a.dtype == torch.float32


def _lib():
    lib = build.load("psd")
    if lib.damped_chol_solve_launch.argtypes is None:
        lib.damped_chol_solve_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.damped_chol_solve_launch.restype = ctypes.c_int
        lib.damped_chol_factor_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.damped_chol_factor_launch.restype = ctypes.c_int
    return lib


def damped_chol_solve(a: torch.Tensor, damp: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b for B SPD systems: a (B, n, n),
    damp (B, n), b (B, n) or (B, n, k) -> x of b's shape.

    CPU tensors take `damped_chol_solve_plain`. CUDA tensors launch
    damped_chol_solve_kernel (and, for k > 1, damped_chol_subst_kernel after
    it) or raise: all three must be float32, contiguous, on one device and
    without grad, with n ≤ MAX_N. One call counts one launch."""
    global launches
    if not a.is_cuda:
        return damped_chol_solve_plain(a, damp, b)
    batch, n, k = check_system(a, damp, b, "damped_chol_solve_kernel")
    if n > MAX_N:
        raise ValueError(f"damped_chol_solve_kernel takes n ≤ {MAX_N}, got n = {n}")
    x = torch.empty_like(b)
    if batch == 0 or n == 0 or k == 0:
        return x
    with torch.cuda.device(a.device):
        rc = _lib().damped_chol_solve_launch(
            a.data_ptr(), damp.data_ptr(), b.data_ptr(), x.data_ptr(), batch, n, k,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"damped_chol_solve_kernel launch failed: CUDA error {rc}")
    launches += 1
    return x


def damped_chol_factor(a: torch.Tensor, damp: torch.Tensor,
                       b: torch.Tensor | None = None) -> tuple:
    """The factor damped_chol_solve_kernel hands to damped_chol_subst_kernel,
    for CUDA float32 systems a (B, n, n), damp (B, n) with n ≤ MAX_SHARED_N:
    (F, ok), F (B, m, m) with m = ⌈n/32⌉·32, stored symmetric (Linv on the
    diagonal blocks, zeros above their diagonal, L21 below them, its
    transpose above), ok (B,) the F1 flags; F of a system whose flag is down
    is not written. With b (B, n), the fused kernel factors and solves, and
    hands its factor on beside x: (F, ok, x). For tests and measurements of
    the factor; the solve is damped_chol_solve. One call counts one launch."""
    global launches
    batch, n, _ = check_system(a, damp, damp if b is None else b,
                               "damped_chol_solve_kernel")
    if not a.is_cuda or n > MAX_SHARED_N or (b is not None and b.ndim != 2):
        raise ValueError(f"damped_chol_factor takes CUDA systems of n ≤ {MAX_SHARED_N} "
                         f"and a (B, n) right-hand side")
    m = -(-n // PANEL) * PANEL
    fac = torch.zeros(batch, m, m, dtype=a.dtype, device=a.device)
    ok = torch.zeros(batch, dtype=torch.int32, device=a.device)
    x = None if b is None else torch.empty_like(b)
    with torch.cuda.device(a.device):
        rc = _lib().damped_chol_factor_launch(
            a.data_ptr(), damp.data_ptr(), None if b is None else b.data_ptr(),
            None if x is None else x.data_ptr(), fac.data_ptr(), ok.data_ptr(), batch, n,
            int(b is not None), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"damped_chol_factor_launch failed: CUDA error {rc}")
    launches += 1
    return (fac, ok.bool()) if b is None else (fac, ok.bool(), x)
