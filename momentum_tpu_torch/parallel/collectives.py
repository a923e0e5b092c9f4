"""JAX's collectives over a mesh axis, on a `torch.distributed` group:

    jax.lax.axis_index / axis_size    rank / world
    jax.lax.ppermute (cyclic shift)   shift: one send and one receive a
                                      rank, posted together
                                      (dist.batch_isend_irecv), so no ring
                                      order can deadlock
    jax.lax.psum / pmax               all_reduce_sum / all_reduce_max
    jax.lax.all_gather                all_gather: the tensors packed into
                                      one flat buffer, one all_gather,
                                      unpacked

The group is the caller's; nothing here picks a backend or moves compute
to another device. gloo's send/recv and all_gather take CPU tensors only,
so under gloo those two ops copy a CUDA buffer to the host and back,
one flat buffer a call. all_reduce takes CUDA tensors under gloo and
NCCL alike and is not staged.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["rank", "world", "shift", "all_reduce_sum", "all_reduce_max", "all_gather",
           "require_initialized"]


def require_initialized(caller: str) -> None:
    """Raise unless torch.distributed has a default group: a sharded entry
    point never falls back to solving on one process."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{caller} needs torch.distributed: call "
                           "torch.distributed.init_process_group first")


def rank(group=None) -> int:
    return dist.get_rank(group)


def world(group=None) -> int:
    return dist.get_world_size(group)


def _host_staged(group, t: torch.Tensor) -> bool:
    """Whether the group's backend needs `t` on the host for send/recv and
    all_gather (gloo with a CUDA tensor)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _pack(tensors):
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return flat, [t.shape for t in tensors]


def _unpack(flat: torch.Tensor, shapes, lead=()):
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[..., at:at + n].reshape(lead + tuple(shape)))
        at += n
    return out


def _global_rank(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def shift(tensors, offset: int, group=None) -> list:
    """Each rank r receives rank (r + offset) mod S's `tensors` (a list of
    one dtype): jax.lax.ppermute with the cyclic permutation
    i → (i − offset) mod S. offset +1 is JAX's _shift_left (values come
    from the right neighbour), −1 its _shift_right. The wrap-around is
    sent, as JAX sends it; the callers mask what it brings."""
    s, r = world(group), rank(group)
    if s == 1:
        return [t.clone() for t in tensors]
    flat, shapes = _pack(tensors)
    device = flat.device
    if _host_staged(group, flat):
        flat = flat.cpu()
    recv = torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, flat, _global_rank(group, (r - offset) % s), group),
           dist.P2POp(dist.irecv, recv, _global_rank(group, (r + offset) % s), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unpack(recv.to(device), shapes)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """jax.lax.psum: the sum over the ranks, the same bytes on every rank."""
    out = t.clone()
    dist.all_reduce(out, dist.ReduceOp.SUM, group)
    return out


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """jax.lax.pmax."""
    out = t.clone()
    dist.all_reduce(out, dist.ReduceOp.MAX, group)
    return out


def all_gather(tensors, group=None) -> list:
    """jax.lax.all_gather of each tensor of `tensors` (one dtype): a list of
    (S, *shape) tensors, rank-ordered, from one collective."""
    s = world(group)
    flat, shapes = _pack(tensors)
    device = flat.device
    if _host_staged(group, flat):
        flat = flat.cpu()
    parts = [torch.empty_like(flat) for _ in range(s)]
    dist.all_gather(parts, flat, group)
    return _unpack(torch.stack(parts).to(device), shapes, lead=(s,))
