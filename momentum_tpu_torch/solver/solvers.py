"""Class-style solver wrappers, after momentum_tpu/solver/solvers.py
(pymomentum.solver2's surface, solver2_pybind.cpp:275-984): thin stateful
shells over solve_ik, solve_gradient_descent and sequence.solve_sequence,
so code written against the reference's class API ports line by line."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.solver.gauss_newton import SolverOptions, solve_gradient_descent
from momentum_tpu_torch.solver.ik import solve_ik
from momentum_tpu_torch.solver.skeleton_solver_function import SkeletonSolverFunction

__all__ = [
    "GradientDescentSolver",
    "GaussNewtonSolver",
    "GaussNewtonSolverQR",
    "SubsetGaussNewtonSolver",
    "SparseGaussNewtonSolver",
    "TrustRegionQR",
    "SequenceSolver",
    "SequenceCholeskySolver",
    "MultiposeSolver",
    "solve_multipose",
]


class _SolverBase:
    method = "gauss_newton"

    def __init__(self, solver_function: SkeletonSolverFunction,
                 options: SolverOptions = SolverOptions()):
        self.solver_function = solver_function
        self.options = options
        self.enabled_parameters: Optional[torch.Tensor] = None
        self.last_result = None

    def _device(self) -> torch.device:
        return self.solver_function.character.parameter_transform.transform.device

    def set_enabled_parameters(self, mask) -> None:
        """solver.cpp:36-43 setEnabledParameters: a 0/1 (or bool) mask over
        the model parameters, on the character's device."""
        self.enabled_parameters = torch.as_tensor(np.asarray(mask, np.float32),
                                                  device=self._device())

    def solve(self, params) -> torch.Tensor:
        res = solve_ik(self.solver_function, torch.as_tensor(params, device=self._device()),
                       self.enabled_parameters, self.options, self.method)
        self.last_result = res
        return res.params

    def set_store_history(self, store: bool = True) -> None:
        """solver.h:72-77 setStoreHistory."""
        self.options = dataclasses.replace(self.options, store_history=store)

    @property
    def error_history(self):
        """Per-iteration energies of the last solve (solver.h:90-92), or None."""
        return None if self.last_result is None else self.last_result.error_history

    @property
    def parameter_history(self):
        return None if self.last_result is None else self.last_result.param_history

    def get_error(self, params) -> float:
        return float(self.solver_function.error(torch.as_tensor(params, device=self._device())))


class GaussNewtonSolver(_SolverBase):
    """gauss_newton_solver.h equivalent."""

    method = "gauss_newton"


class GaussNewtonSolverQR(GaussNewtonSolver):
    """gauss_newton_solver_qr.h equivalent: the damped step from a QR
    factorization of [J; √λ·I] instead of the normal equations."""

    def __init__(self, solver_function, options: SolverOptions = SolverOptions()):
        super().__init__(solver_function, dataclasses.replace(options, linear_solver="qr"))


class SubsetGaussNewtonSolver(GaussNewtonSolver):
    """subset_gauss_newton_solver.h equivalent: the subset is
    set_enabled_parameters' mask (masked columns instead of compaction)."""


class SparseGaussNewtonSolver(GaussNewtonSolver):
    """gauss_newton_solver_sparse.h:50-90 equivalent for high-dimensional
    problems: matrix-free conjugate gradients on (JᵀJ + damp·I) by JVP/VJP
    sweeps (solve_gauss_newton_cg) in place of the reference's sparse
    factorization."""

    def __init__(self, solver_function, options: SolverOptions = SolverOptions()):
        super().__init__(solver_function, dataclasses.replace(options, linear_solver="cg"))


class TrustRegionQR(_SolverBase):
    """trust_region_qr.h equivalent: adaptive-damping LM on the QR path."""

    method = "levenberg_marquardt"

    def __init__(self, solver_function, options: SolverOptions = SolverOptions()):
        super().__init__(solver_function, dataclasses.replace(options, linear_solver="qr"))


class GradientDescentSolver(_SolverBase):
    """gradient_descent_solver.h equivalent (first-order)."""

    method = "gradient_descent"

    def __init__(self, solver_function, options: SolverOptions = SolverOptions(),
                 learning_rate: float = 0.01):
        super().__init__(solver_function, options)
        self.learning_rate = learning_rate

    def solve(self, params) -> torch.Tensor:
        fn = self.solver_function
        res = solve_gradient_descent(
            fn.residual, fn.error, torch.as_tensor(params, device=self._device()),
            self.enabled_parameters, self.options, learning_rate=self.learning_rate)
        self.last_result = res
        return res.params


class SequenceSolver:
    """sequence_solver.h equivalent."""

    def __init__(self, solver_function, options: SolverOptions = SolverOptions()):
        self.solver_function = solver_function
        self.options = options
        self.last_result = None

    def solve(self, per_frame: torch.Tensor, universal: torch.Tensor):
        from momentum_tpu_torch.sequence.solver import solve_sequence

        res = solve_sequence(self.solver_function, per_frame, universal, self.options)
        self.last_result = res
        return res


class SequenceCholeskySolver(SequenceSolver):
    """sequence_cholesky_solver.h equivalent. The sequence solver already
    factors the banded normal equations (sequence/solver.py,
    block_tridiag.py), so this shares SequenceSolver's path; the name
    exists for ported code."""


def solve_multipose(fn, pf0, u0, options: SolverOptions = SolverOptions()):
    """MultiposeSolver (multipose_solver.h:18-60): N independent poses
    coupled only through shared universal parameters, which is the sequence
    solve without sequence error functions (the band degenerates to
    block-diagonal plus the arrowhead)."""
    from momentum_tpu_torch.sequence.solver import solve_sequence

    if fn.sequence_errors:
        raise ValueError("multipose solve expects no sequence error functions")
    return solve_sequence(fn, pf0, u0, options)


class MultiposeSolver(SequenceSolver):
    def solve(self, per_frame, universal):
        res = solve_multipose(self.solver_function, per_frame, universal, self.options)
        self.last_result = res
        return res
