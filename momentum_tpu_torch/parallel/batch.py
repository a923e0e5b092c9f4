"""Data-parallel IK and tracking over the ranks of a `torch.distributed`
group, after momentum_tpu/parallel/batch.py: each rank solves its slice of
a batch of independent IK problems (or of a clip's frames) with the port's
batched solvers and the results are gathered, so every rank returns the
whole result (the reference's dispenso::parallel_for over problems,
tensor_ik.cpp:127). The solves themselves exchange nothing.

The batched solvers freeze an element once it has converged, so an
element's result does not depend on which others share its batch: a rank's
slice solves to what the whole batch solves to.

A "mesh" here is a process group: `default_mesh` gives the group over the
first n ranks of the default group, which the other entry points take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.parallel import collectives as C

__all__ = ["default_mesh", "shard_batch", "solve_ik_sharded", "track_poses_sharded"]


def default_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """The group over the first n (default: all) ranks of the default group
    (JAX's 1-D mesh over the first n devices). A group of fewer ranks is a
    collective call: every rank of the default group makes it. `axis` names
    the mesh axis in JAX; a group has none."""
    C.require_initialized("default_mesh")
    size = dist.get_world_size()
    if n_devices is None or n_devices == size:
        return dist.group.WORLD
    if not 0 < n_devices <= size:
        raise ValueError(f"{n_devices} ranks asked of a group of {size}")
    return dist.new_group(list(range(n_devices)))


def _part(n: int, group) -> slice:
    """This rank's rows of n rows split evenly over the group."""
    s, r = C.world(group), C.rank(group)
    return slice(r * n // s, (r + 1) * n // s)


def _map_tensors(tree, fn):
    """`tree` with fn applied to each tensor: through tuples and lists,
    dicts and dataclasses, a Character kept whole (the rig is never
    batched)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Character):
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(t, fn) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tensors(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_batch(tree, mesh=None, axis: str = "data", batch: Optional[int] = None):
    """This rank's part of `tree`: tensors whose leading dim equals `batch`
    are cut to the rank's rows, everything else is kept whole (JAX's
    split-or-replicate). `batch` defaults to the largest leading dim that
    the group's size divides."""
    C.require_initialized("shard_batch")
    group = mesh
    n = C.world(group)
    if batch is None:
        dims = []
        _map_tensors(tree, lambda t: dims.append(t.shape[0]) if t.ndim > 0 else None)
        candidates = [d for d in dims if d % n == 0 and d >= n]
        if not candidates:
            raise ValueError("no mesh-divisible leading batch axis found")
        batch = max(candidates)
    rows = _part(batch, group)
    return _map_tensors(tree, lambda t: t[rows] if t.ndim > 0 and t.shape[0] == batch else t)


def _gather(t: Optional[torch.Tensor], group, dim: int = 0):
    """The ranks' slices of t concatenated along `dim`, on every rank."""
    if t is None:
        return None
    moved = t.movedim(dim, 0)
    wire = moved.to(torch.uint8) if moved.dtype == torch.bool else moved.contiguous()
    parts, = C.all_gather([wire], group)
    out = parts.flatten(0, 1).to(t.dtype)
    return out.movedim(0, dim)


def solve_ik_sharded(solver_fn, x0: torch.Tensor, mesh=None, enabled_mask=None,
                     options=None, method: str = "levenberg_marquardt", axis: str = "data"):
    """Batched IK with the batch split over the ranks of `mesh` (a group;
    None: default_mesh()). solver_fn: a SkeletonSolverFunction whose modules
    carry a leading batch axis; x0 (B, P) with B divisible by the group's
    size. Every rank returns the whole SolveResult: parameters, energies,
    flags, histories and damping gathered; iterations the largest rank's,
    which is the count of the whole batch's solve."""
    from momentum_tpu_torch.solver.gauss_newton import SolverOptions
    from momentum_tpu_torch.solver.ik import solve_ik

    opts = options or SolverOptions()
    group = default_mesh(axis=axis) if mesh is None else mesh
    n = C.world(group)
    b = x0.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by mesh size {n}")
    local_fn = dataclasses.replace(
        solver_fn, error_functions=shard_batch(solver_fn.error_functions, group, batch=b))
    mask = enabled_mask
    if mask is not None and mask.ndim > 1:  # a (P,) mask is every element's
        mask = shard_batch(mask, group, batch=b)
    res = solve_ik(local_fn, shard_batch(x0, group, batch=b), mask, opts, method)
    iters = C.all_reduce_max(torch.tensor(res.iterations, device=x0.device), group)
    return res._replace(
        params=_gather(res.params, group), error=_gather(res.error, group),
        iterations=int(iters), converged=_gather(res.converged, group),
        error_history=_gather(res.error_history, group, 1),
        param_history=_gather(res.param_history, group, 1),
        lambda_final=_gather(res.lambda_final, group))


def track_poses_sharded(character, markers, mesh=None, config=None, initial=None,
                        enabled_mask=None, axis: str = "data"):
    """Frame-parallel marker tracking with the frames split over the ranks
    of `mesh` (a group; None: default_mesh()): track_poses_batched on each
    rank's frames, gathered. The frame count must be divisible by the
    group's size; pad the clip (e.g. repeat the last frame) otherwise. With
    config.refine, the frames refined are the whole clip's worst, as in
    track_poses_batched: the first stage's energies are gathered, every
    rank picks the same frames and refines those it holds."""
    from momentum_tpu_torch.tracking.config import TrackingConfig
    from momentum_tpu_torch.tracking.tracker import TrackingResult, track_poses_batched

    config = config or TrackingConfig()
    group = default_mesh(axis=axis) if mesh is None else mesh
    n = C.world(group)
    f = markers.num_frames
    if f % n:
        raise ValueError(f"frame count {f} not divisible by mesh size {n}; pad the clip")
    local = shard_batch(markers, group, batch=f)
    init = initial
    if init is not None and torch.as_tensor(init).ndim > 1:  # (P,) starts every frame
        init = shard_batch(torch.as_tensor(init), group, batch=f)
    if config.refine is None:
        res = track_poses_batched(character, local, config, init, enabled_mask)
        return TrackingResult(motion=_gather(res.motion, group),
                              errors=_gather(res.errors, group))
    return _track_refined(character, local, config, init, enabled_mask, group, f)


def _track_refined(character, local, config, init, enabled_mask, group, f):
    """track_poses_batched's compacted refine over a clip split by frames:
    k_full iterations on each rank's frames, then r_refine more on the
    clip's `capacity` worst frames, each refined by the rank holding it."""
    from momentum_tpu_torch.tracking.tracker import (
        TrackingResult, _frame_solve, _initial, _mask_low_visibility)

    local = _mask_low_visibility(local, config.min_vis_percent)
    solve = _frame_solve(character, local, config, enabled_mask)
    f_loc, p = local.num_frames, character.num_model_parameters
    x0 = _initial(character, init)
    x_b = x0.expand(f_loc, p) if x0.ndim == 1 else x0
    k_full, r_refine, capacity = config.refine
    capacity = min(int(capacity), f)
    lam_init = torch.full((f_loc,), solve.opts.lambda_init, device=x_b.device)
    res1 = solve(local.positions, local.occluded, x_b, k_full, lam_init)
    lam1 = res1.lambda_final if res1.lambda_final is not None else lam_init
    key = _gather(torch.nan_to_num(res1.error, nan=3e38, posinf=3e38), group)
    idx = torch.topk(key, capacity).indices
    rows = _part(f, group)
    mine = idx[(idx >= rows.start) & (idx < rows.stop)] - rows.start
    motion, errors = res1.params, res1.error
    if mine.numel():
        res2 = solve(local.positions[mine], local.occluded[mine], res1.params[mine], r_refine,
                     lam1[mine], rows=mine)
        motion = motion.index_copy(0, mine, res2.params)
        errors = errors.index_copy(0, mine, res2.error)
    return TrackingResult(motion=_gather(motion, group), errors=_gather(errors, group))
