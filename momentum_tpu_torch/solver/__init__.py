"""Solvers: skeleton solver function, GN and LM, compacted tail refinement,
the solve_ik entry point."""

from momentum_tpu_torch.solver.compaction import (  # noqa: F401
    gather_batch, scatter_batch, solve_compacted)
from momentum_tpu_torch.solver.gauss_newton import (  # noqa: F401
    SolverOptions, SolveResult, solve_gauss_newton, solve_levenberg_marquardt)
from momentum_tpu_torch.solver.ik import solve_ik  # noqa: F401
from momentum_tpu_torch.solver.skeleton_solver_function import (  # noqa: F401
    SkeletonSolverFunction)
