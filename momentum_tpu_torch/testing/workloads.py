"""The bench.py IK workload of momentum_tpu/testing/workloads.py on tensors.

Full-body marker IK (51-joint / 157-parameter rig, 80 position constraints),
warm-started batch-native LM: `k_full` full-batch iterations, then `r_refine`
compacted iterations on the worst `capacity` elements
(solver/compaction.py). The random numbers come from numpy exactly as the
JAX workload draws them, so both packages solve the same problem from the
same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["build_fullbody_ik_problem", "make_solve_stage", "make_solve_batch",
           "DEFAULT_REFINE", "DEFAULT_BATCH"]

# 5 full-batch LM iterations + 6 compacted iterations on the worst 128 of 2048
DEFAULT_REFINE = (5, 6, 128)
DEFAULT_BATCH = 2048


def build_fullbody_ik_problem(batch: int, seed: int = 0, noise: float = 0.05,
                              device=None):
    """(char, ef0, targets, x0): targets are exact locator positions of
    uniform-random ground-truth poses; x0 is truth + `noise` gaussian."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(seed)
    gt_np = rng.uniform(-0.3, 0.3, (batch, char.num_model_parameters)).astype(np.float32)
    gt = torch.as_tensor(gt_np, device=device)
    targets = char.locators.world_positions(char.skeleton_states(gt))
    ef0 = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device=device)
    x0 = gt + torch.as_tensor(rng.normal(0, noise, gt_np.shape).astype(np.float32),
                              device=device)
    return char, ef0, targets, x0


def make_solve_stage(char, ef0, *, regularization: float = 1e-5,
                     lambda_init: float = 0.01, lambda_down: float = 0.1):
    """The compaction-compatible LM stage `(targets, x0, iters, lam0) ->
    SolveResult` on the fused analytic Jacobian path."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt

    opts = SolverOptions(regularization=regularization, energy_from_residual=True,
                         lambda_init=lambda_init, lambda_down=lambda_down)

    def _solve_stage(targets, x0, iters, lam0):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
        return solve_levenberg_marquardt(
            fn.residual, fn.error, x0,
            options=dataclasses.replace(opts, max_iterations=iters),
            jacobian_fn=fn.residual_and_jacobian, lambda0=lam0)

    return _solve_stage


def make_solve_batch(char, ef0, batch: int, refine: Optional[tuple] = DEFAULT_REFINE,
                     iters: int = 6, **stage_kw):
    """The full solve step `(targets, x0) -> SolveResult` (compacted-tail LM).
    `refine` capacities quoted at B = 2048 scale down proportionally for
    smaller batches."""
    stage = make_solve_stage(char, ef0, **stage_kw)
    if refine is None:
        def solve_batch(targets, x0):
            return stage(targets, x0, iters, None)
        return solve_batch

    from momentum_tpu_torch.solver import solve_compacted

    k_full, r_refine, cap = refine
    if batch < DEFAULT_BATCH:
        cap = max(8, cap * batch // DEFAULT_BATCH)
    cap = min(cap, batch)

    def solve_batch(targets, x0):
        return solve_compacted(stage, targets, x0, capacity=cap,
                               k_full=k_full, r_refine=r_refine)

    return solve_batch
