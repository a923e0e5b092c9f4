"""High-level IK entry point (tensor_ik.cpp:95-190), after
momentum_tpu/solver/ik.py: one batched solve over x0's leading dimensions,
with NaN results reverted to x0 (tensor_ik.cpp:168-175).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from momentum_tpu_torch.solver.gauss_newton import (
    SolveResult, SolverOptions, solve_gauss_newton, solve_levenberg_marquardt)
from momentum_tpu_torch.solver.skeleton_solver_function import SkeletonSolverFunction

__all__ = ["solve_ik", "get_solve_counters", "reset_solve_counters"]

# Solve counters (tensor_ik.cpp:178-180 nTotalSolveIK / nTotalSolveIKIter),
# counted on the host when solve_ik is called: problems, and problems times
# the iteration budget.
_counters = {"n_total_solve_ik": 0, "n_total_solve_ik_iter": 0}


def get_solve_counters() -> dict:
    return dict(_counters)


def reset_solve_counters() -> None:
    _counters["n_total_solve_ik"] = 0
    _counters["n_total_solve_ik_iter"] = 0


def solve_ik(
    solver_fn: SkeletonSolverFunction,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor] = None,
    options: SolverOptions = SolverOptions(),
    method: str = "gauss_newton",
) -> SolveResult:
    """Solve the IK problems of x0 (..., P). "gauss_newton" takes the normal
    equations whenever a module adds its own (limits, pose prior);
    "levenberg_marquardt" / "trust_region" need every module's fused
    Jacobian. Elements whose result is not finite are reverted to x0."""
    batch = math.prod(x0.shape[:-1])
    _counters["n_total_solve_ik"] += batch
    _counters["n_total_solve_ik_iter"] += batch * options.max_iterations
    if method == "gradient_descent":
        raise NotImplementedError("gradient descent comes with ROADMAP M5")
    if method not in ("gauss_newton", "levenberg_marquardt", "trust_region"):
        raise ValueError(f"unknown method {method!r}")
    jac_fn = solver_fn.residual_and_jacobian if solver_fn.fully_analytic else None
    normal_fn = None
    error_fn = solver_fn.error
    if options.linear_solver == "cholesky" and solver_fn.has_structured_modules:
        normal_fn = solver_fn.normal_equations
        if options.energy_from_residual:
            error_fn = solver_fn.residual_sq
    if method == "gauss_newton":
        result = solve_gauss_newton(solver_fn.residual, error_fn, x0, enabled_mask, options,
                                    jacobian_fn=jac_fn, normal_fn=normal_fn)
    else:
        if normal_fn is not None or enabled_mask is not None:
            raise NotImplementedError("LM on normal equations or with a parameter mask "
                                      "comes with ROADMAP M5")
        result = solve_levenberg_marquardt(solver_fn.residual, error_fn, x0, options,
                                           jacobian_fn=jac_fn)
    bad = ~torch.isfinite(result.params).all(dim=-1, keepdim=True)
    return result._replace(params=torch.where(bad, x0, result.params))
