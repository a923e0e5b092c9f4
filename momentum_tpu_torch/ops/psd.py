"""K2+K3: batched damped Cholesky solve — `damped_chol_solve_kernel`
(csrc/psd.cu).

One kernel replaces two TPU kernels of momentum_tpu/ops/psd_pallas.py:
`_panel_kernel` (:53, K2: per-panel Cholesky and triangular inverse Linv)
and `_subst_kernel` (:120, K3: blocked forward and back substitution with
the Linv blocks). On the H100 one (n, n) system fits in one block's shared
memory, so the block factors and substitutes without writing the factor to
device memory.

Its bound is bytes: B·n²·4 read once, 61 µs at B = 2048, n = 157 (3.35
TB/s), above the 39 µs of its B·n³/3 flops. What holds it back is latency:
one system per block, two blocks per SM. The kernel therefore runs K2's
algorithm in 32-wide panels. Warp 0 factors each diagonal block in registers
and forms its inverse Linv. All warps then compute L21 = A21·Linvᵀ and the
trailing update as 4 × 4 register-tile products. The substitutions are
32-wide matrix-vector products with Linv. The matrix comes in by float4
loads, eight in flight per thread. The note at the top of csrc/psd.cu has
the details.

The kernel pads the system in shared memory to a multiple of 32 rows, so it
takes n ≤ 224 (the full-body rig has n = 157); a larger n does not fit in
one block's shared memory and raises ValueError.

`damped_chol_solve_plain` is the plain PyTorch version:
`torch.linalg.cholesky_ex` + `torch.cholesky_solve`. Both versions give an
all-NaN x for a system whose factorization meets a pivot that is not > 0
(ROADMAP F1: the JAX CPU path's behaviour, not the TPU kernels' clamp).
"""

from __future__ import annotations

import ctypes

import torch

from momentum_tpu_torch.ops import build

__all__ = ["damped_chol_solve", "damped_chol_solve_plain", "check_system", "launches"]

# times damped_chol_solve_kernel was launched in this process
launches = 0


def damped_chol_solve_plain(a: torch.Tensor, damp: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b; a (B, n, n), damp (B, n), b (B, n)."""
    l, info = torch.linalg.cholesky_ex(a + torch.diag_embed(damp))
    x = torch.cholesky_solve(b.unsqueeze(-1), l).squeeze(-1)
    return torch.where((info != 0).unsqueeze(-1),
                       torch.full_like(x, float("nan")), x)


def check_system(a: torch.Tensor, damp: torch.Tensor, b: torch.Tensor,
                 kernel: str) -> tuple:
    """(B, n) of a batch of damped systems that `kernel` can take, or raise."""
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected a of shape (B, n, n), got {tuple(a.shape)}")
    batch, n = a.shape[0], a.shape[1]
    for name, t in (("damp", damp), ("b", b)):
        if t.shape != (batch, n):
            raise ValueError(f"expected {name} of shape {(batch, n)}, got {tuple(t.shape)}")
    for t in (a, damp, b):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != a.device):
            raise ValueError(f"{kernel} takes contiguous float32 tensors on one CUDA device")
        if t.requires_grad:
            raise RuntimeError(f"{kernel} has no backward: call it on tensors without grad")
    return batch, n


def _lib():
    lib = build.load("psd")
    lib.damped_chol_solve_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.damped_chol_solve_launch.restype = ctypes.c_int
    lib.damped_chol_solve_smem_bytes.argtypes = [ctypes.c_int]
    lib.damped_chol_solve_smem_bytes.restype = ctypes.c_int
    return lib


def damped_chol_solve(a: torch.Tensor, damp: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """x with (a + diag(damp)) x = b for B SPD systems: a (B, n, n),
    damp (B, n), b (B, n) -> x (B, n).

    CPU tensors take `damped_chol_solve_plain`. CUDA tensors launch
    damped_chol_solve_kernel or raise: all three must be float32,
    contiguous, on one device and without grad, with n small enough for the
    block's shared memory (n ≤ 224)."""
    global launches
    if not a.is_cuda:
        return damped_chol_solve_plain(a, damp, b)
    batch, n = check_system(a, damp, b, "damped_chol_solve_kernel")
    lib = _lib()
    if lib.damped_chol_solve_smem_bytes(n) > build.SMEM_PER_BLOCK:
        raise ValueError(f"damped_chol_solve_kernel: n = {n} does not fit in "
                         f"one block's shared memory")
    x = torch.empty_like(b)
    if batch == 0 or n == 0:
        return x
    with torch.cuda.device(a.device):
        rc = lib.damped_chol_solve_launch(
            a.data_ptr(), damp.data_ptr(), b.data_ptr(), x.data_ptr(), batch, n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"damped_chol_solve_kernel launch failed: CUDA error {rc}")
    launches += 1
    return x
