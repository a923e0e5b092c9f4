"""Compacted tail refinement for batched IK solves, after
momentum_tpu/solver/compaction.py.

After `k_full` full-batch LM iterations most elements have converged, so the
remaining `r_refine` iterations run only on the worst `capacity` elements
(gathered by energy into a compacted sub-batch) and are scattered back. The
refinement resumes each element's LM damping (SolveResult.lambda_final →
lambda0), so a refined element follows the same iterates it would in a
(k_full + r_refine)-iteration solve.

Spans (utils/profiling.py): `compaction.solve` around a call, and inside it
`compaction.select` (the top-k and the gathers), `compaction.refine` (the
second stage) and `compaction.scatter` (the writes back).
"""

from __future__ import annotations

from typing import Callable

import torch

from momentum_tpu_torch.solver.gauss_newton import SolveResult
from momentum_tpu_torch.utils.profiling import profile_scope, spanned

__all__ = ["gather_batch", "scatter_batch", "solve_compacted"]

_BIG = 3.0e38  # sorts NaN/inf energies first so divergent elements refine


def _map(fn, tree, *rest):
    """Apply fn to the leaves of tensors nested in tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def gather_batch(tree, idx: torch.Tensor, batch_size: int):
    """Gather tensors whose leading dim is batch_size at `idx`; pass shared
    (unbatched) leaves through unchanged."""

    def g(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 and leaf.shape[0] == batch_size:
            return leaf[idx]
        return leaf

    return _map(g, tree)


def scatter_batch(tree, sub, idx: torch.Tensor, capacity: int):
    """Inverse of gather_batch: `tree` with `sub`'s compacted leaves written
    back at `idx` (out of place)."""

    def s(full, small):
        if (isinstance(small, torch.Tensor) and small.ndim >= 1
                and small.shape[0] == capacity
                and isinstance(full, torch.Tensor) and full.ndim == small.ndim):
            return full.index_copy(0, idx, small)
        return full

    return _map(s, tree, sub)


@spanned("compaction.solve")
def solve_compacted(solve_fn: Callable, inputs, x0: torch.Tensor, capacity: int,
                    k_full: int, r_refine: int) -> SolveResult:
    """Full batch for `k_full` iterations, then `r_refine` more on the
    `capacity` worst elements only.

    solve_fn(inputs, x0, max_iterations, lambda0) -> SolveResult; `inputs`
    is a tensor or a nest of tensors whose leading-batch-dim leaves are
    gathered for the refinement stage. Elements beyond capacity keep their
    k_full-iteration result."""
    batch = x0.shape[0]
    res1 = solve_fn(inputs, x0, k_full, None)
    if capacity <= 0 or r_refine <= 0:
        return res1
    if capacity > batch:
        raise ValueError(f"capacity {capacity} exceeds batch {batch}")
    with profile_scope("compaction.select"):
        key = torch.nan_to_num(res1.error, nan=_BIG, posinf=_BIG)
        _, idx = torch.topk(key, capacity)
        lam = None if res1.lambda_final is None else res1.lambda_final[idx]
        sub = gather_batch(inputs, idx, batch), res1.params[idx]
    with profile_scope("compaction.refine"):
        res2 = solve_fn(*sub, r_refine, lam)
    del sub  # the gathered batch is not held through the scatter
    with profile_scope("compaction.scatter"):
        lam_out = None
        if res1.lambda_final is not None:
            lam_out = res1.lambda_final.index_copy(
                0, idx, lam if res2.lambda_final is None else res2.lambda_final)
        return SolveResult(
            params=res1.params.index_copy(0, idx, res2.params),
            error=res1.error.index_copy(0, idx, res2.error),
            iterations=res1.iterations + res2.iterations,
            converged=res1.converged.index_copy(0, idx, res2.converged),
            lambda_final=lam_out)
