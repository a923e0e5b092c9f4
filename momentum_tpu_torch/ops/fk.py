"""K1: batched global forward kinematics — `fk_global_kernel` (csrc/fk.cu).

Replaces the TPU kernel momentum_tpu/ops/fk_pallas.py::_fk_kernel (:62),
which runs the binary-lifting ladder in VMEM with one-hot permutation
matmuls. The kernel runs the same ladder with one thread per (element,
joint) and the parent selection as an index into shared memory (the note at
the top of csrc/fk.cu has the design and the numbers).

`fk_global_plain` is the plain PyTorch version: the same prefix product, an
index gather per row of `Skeleton.prefix_table`, the table the kernel
reads. Both compose in the same order with the same rounding, so on the
card they agree to the last bits of PyTorch's own kernels.

Derivatives: `fk_global` goes through `_FkGlobal`, a
`torch.autograd.Function` whose forward is the kernel (the plain version on
the CPU) and whose derivatives are those of `fk_global_plain` at the saved
local states: `backward` its VJP, `jvp` its JVP (forward mode, for
`torch.func.jacfwd` and `torch.func.jvp`), and `vmap` folds a vmapped
dimension into the kernel's leading batch, so `torch.func.vmap` hands the
kernel a plain tensor. It is the form of JAX's `make_differentiable_fk`
(momentum_tpu/ops/fk_pallas.py:127-142), a `custom_jvp` with tangents from
the lifted XLA FK; there is no derivative kernel.
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
    g_{k+1}[j] = g_k[p_k[j]] ∘ g_k[j] over a virtual identity node nJ, p_k
    row k of `skeleton.prefix_table`."""
    batch = local_states.shape[:-2]
    ident = ss.identity(batch + (1,), dtype=local_states.dtype,
                        device=local_states.device)
    g = torch.cat([local_states, ident], dim=-2)
    for p in skeleton.prefix_table.to(local_states.device):
        g = ss.multiply(g.index_select(-2, p), g)
    return g[..., :-1, :]


def _lib():
    lib = build.load("fk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fk_global_launch.argtypes = [p, p, i, p, i, i, p]
    lib.fk_global_launch.restype = i
    lib.fk_global_max_joints.argtypes = []
    lib.fk_global_max_joints.restype = i
    return lib


def _fk_global_direct(skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if local_states.is_cuda:
        return _fk_global_kernel(skeleton, local_states)
    return fk_global_plain(skeleton, local_states)


class _FkGlobal(torch.autograd.Function):
    """Global states by the kernel (or, on the CPU, the plain version); the
    derivatives are those of `fk_global_plain` at the saved local states."""

    @staticmethod
    def forward(local_states, skeleton):
        return _fk_global_direct(skeleton, local_states)

    @staticmethod
    def setup_context(ctx, inputs, output):
        local_states, skeleton = inputs
        ctx.skeleton = skeleton
        ctx.save_for_backward(local_states)
        ctx.save_for_forward(local_states)

    @staticmethod
    def backward(ctx, grad_out):
        (local,) = ctx.saved_tensors
        _, vjp = torch.func.vjp(lambda x: fk_global_plain(ctx.skeleton, x), local)
        return vjp(grad_out)[0], None

    @staticmethod
    def jvp(ctx, local_tangent, _skeleton_tangent):
        (local,) = ctx.saved_tensors
        return torch.func.jvp(lambda x: fk_global_plain(ctx.skeleton, x),
                              (local,), (local_tangent,))[1]

    @staticmethod
    def vmap(info, in_dims, local_states, skeleton):
        """The vmapped dimension becomes the leading batch dimension of one
        launch (the kernel takes any leading dims)."""
        dim = in_dims[0]
        if dim is None:
            return _FkGlobal.apply(local_states, skeleton), None
        return _FkGlobal.apply(local_states.movedim(dim, 0).contiguous(), skeleton), 0


def fk_global(skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """(..., nJ, 8) local → (..., nJ, 8) global skeleton states.

    A CPU tensor takes `fk_global_plain`. A CUDA tensor launches
    fk_global_kernel or raises: it must be float32, contiguous and 16-byte
    aligned, on the device of `skeleton.prefix_table`, with at most
    `fk_global_max_joints()` (1023) joints. The call goes through
    `_FkGlobal` on either device, so reverse mode, forward mode and
    torch.func's transforms reach the kernel through its rules."""
    return _FkGlobal.apply(local_states, skeleton)


def _fk_global_kernel(skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """Launch fk_global_kernel on the current stream (checks as fk_global)."""
    global launches
    nj = skeleton.num_joints
    if local_states.shape[-2:] != (nj, 8):
        raise ValueError(f"expected (..., {nj}, 8) local states, got "
                         f"{tuple(local_states.shape)}")
    if local_states.dtype != torch.float32 or not local_states.is_contiguous():
        raise ValueError("fk_global_kernel takes contiguous float32 states")
    if local_states.data_ptr() % 16:
        raise ValueError("fk_global_kernel takes 16-byte aligned states")
    table = skeleton.prefix_table
    if table.device != local_states.device:
        raise ValueError("skeleton.prefix_table must lie on the states' device")
    lib = _lib()
    if nj > lib.fk_global_max_joints():
        raise ValueError(f"fk_global_kernel takes at most {lib.fk_global_max_joints()} "
                         f"joints, got {nj}")
    out = torch.empty_like(local_states)
    batch = local_states.numel() // (nj * 8)
    if batch == 0:
        return out
    with torch.cuda.device(local_states.device):
        rc = lib.fk_global_launch(
            local_states.data_ptr(), table.data_ptr(), table.shape[0], out.data_ptr(),
            batch, nj, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fk_global_kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
