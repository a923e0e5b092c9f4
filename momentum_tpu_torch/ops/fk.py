"""K1: batched global forward kinematics — `fk_global_kernel` (csrc/fk.cu).

Replaces the TPU kernel momentum_tpu/ops/fk_pallas.py::_fk_kernel (:62),
which runs the binary-lifting ladder in VMEM with one-hot permutation
matmuls. On the H100 the kernel is bound by latency, not by bytes or flops:
one thread per batch element walks the joints in topological order, with
the block's elements staged through shared memory so device-memory traffic
is coalesced (the note at the top of csrc/fk.cu has the numbers).

`fk_global_plain` is the plain PyTorch version: the same binary-lifting
prefix product as momentum_tpu's `global_skel_states_lifted`, with an index
gather for the parent selection. It composes in another order than the
kernel's serial walk, so the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from momentum_tpu_torch.math import skel_state as ss
from momentum_tpu_torch.ops import build

__all__ = ["fk_global", "fk_global_plain", "launches"]

# times fk_global_kernel was launched in this process (reset it to measure a run)
launches = 0


def fk_global_plain(skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) local → (..., nJ, 8) global states by binary lifting:
    g_{k+1}[j] = g_k[p_k[j]] ∘ g_k[j] over a virtual identity node nJ."""
    batch = local_states.shape[:-2]
    ident = ss.identity(batch + (1,), dtype=local_states.dtype,
                        device=local_states.device)
    g = torch.cat([local_states, ident], dim=-2)
    for p in skeleton.prefix_index:
        g = ss.multiply(g.index_select(-2, p), g)
    return g[..., :-1, :]


def _lib():
    lib = build.load("fk")
    lib.fk_global_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.fk_global_launch.restype = ctypes.c_int
    lib.fk_global_smem_bytes.argtypes = [ctypes.c_int]
    lib.fk_global_smem_bytes.restype = ctypes.c_int
    return lib


def fk_global(skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) local → (..., nJ, 8) global skeleton states.

    A CPU tensor takes `fk_global_plain`. A CUDA tensor launches
    fk_global_kernel or raises: it must be float32 and contiguous, on the
    device of `skeleton.joint_parent`, and must not require grad (the
    kernel has no backward yet; the slice's Jacobians are analytic)."""
    global launches
    if not local_states.is_cuda:
        return fk_global_plain(skeleton, local_states)
    nj = skeleton.num_joints
    if local_states.shape[-2:] != (nj, 8):
        raise ValueError(f"expected (..., {nj}, 8) local states, got "
                         f"{tuple(local_states.shape)}")
    if local_states.dtype != torch.float32 or not local_states.is_contiguous():
        raise ValueError("fk_global_kernel takes contiguous float32 states")
    if local_states.requires_grad:
        raise RuntimeError("fk_global_kernel has no backward: call it on "
                           "tensors that do not require grad")
    parent = skeleton.joint_parent
    if parent.device != local_states.device or parent.dtype != torch.int32:
        raise ValueError("skeleton.joint_parent must be int32 on the states' device")
    lib = _lib()
    if lib.fk_global_smem_bytes(nj) > build.SMEM_PER_BLOCK:
        raise ValueError(f"fk_global_kernel: {nj} joints do not fit in one "
                         f"block's shared memory")
    out = torch.empty_like(local_states)
    batch = local_states.numel() // (nj * 8)
    if batch == 0:
        return out
    with torch.cuda.device(local_states.device):
        rc = lib.fk_global_launch(
            local_states.data_ptr(), parent.data_ptr(), out.data_ptr(), batch, nj,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fk_global_kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
