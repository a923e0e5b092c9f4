"""High-level IK entry point (tensor_ik.cpp:95-190), after
momentum_tpu/solver/ik.py: one batched solve over x0's leading dimensions,
with NaN results reverted to x0 (tensor_ik.cpp:168-175).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from momentum_tpu_torch.solver.gauss_newton import (
    SolveResult, SolverOptions, solve_gauss_newton, solve_gradient_descent,
    solve_levenberg_marquardt)
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
    """Solve the IK problems of x0 (..., P) by "gauss_newton",
    "levenberg_marquardt" / "trust_region" or "gradient_descent" (learning
    rate 0.01). The Cholesky path takes the normal equations whenever a
    module adds its own (limits, pose prior); otherwise, and for QR, CG and
    gradient descent, every module's analytic Jacobian when all have one,
    else forward mode (JAX's routing, momentum_tpu/solver/ik.py:63-83).
    Elements whose result is not finite are reverted to x0."""
    batch = math.prod(x0.shape[:-1])
    _counters["n_total_solve_ik"] += batch
    _counters["n_total_solve_ik_iter"] += batch * options.max_iterations
    solvers = {"gauss_newton": solve_gauss_newton,
               "levenberg_marquardt": solve_levenberg_marquardt,
               "trust_region": solve_levenberg_marquardt,
               "gradient_descent": solve_gradient_descent}
    if method not in solvers:
        raise ValueError(f"unknown method {method!r}")
    jac_fn = solver_fn.residual_and_jacobian if solver_fn.fully_analytic else None
    normal_fn = None
    error_fn = solver_fn.error
    if (method != "gradient_descent" and options.linear_solver == "cholesky"
            and solver_fn.has_structured_modules):
        normal_fn = solver_fn.normal_equations
        if options.energy_from_residual:
            error_fn = solver_fn.residual_sq
    result = solvers[method](solver_fn.residual, error_fn, x0, enabled_mask, options,
                             jacobian_fn=jac_fn, normal_fn=normal_fn)
    bad = ~torch.isfinite(result.params).all(dim=-1, keepdim=True)
    return result._replace(params=torch.where(bad, x0, result.params))
