"""Solvers: skeleton solver function, GN (Cholesky, QR, CG, line search),
LM, gradient descent, compacted tail refinement, the solve_ik entry point,
differentiable IK and the class-style wrappers."""

from momentum_tpu_torch.solver.gauss_newton import (  # noqa: F401
    SolveResult, SolverOptions, solve_gauss_newton, solve_gauss_newton_cg,
    solve_gradient_descent, solve_levenberg_marquardt)
from momentum_tpu_torch.solver.skeleton_solver_function import (  # noqa: F401
    SkeletonSolverFunction)
from momentum_tpu_torch.solver.ik import solve_ik  # noqa: F401
from momentum_tpu_torch.solver.diff_ik import gradient_rmse, solve_ik_ift  # noqa: F401
from momentum_tpu_torch.solver.solvers import (  # noqa: F401
    GaussNewtonSolver, GaussNewtonSolverQR, GradientDescentSolver, MultiposeSolver,
    SequenceCholeskySolver, SequenceSolver, SparseGaussNewtonSolver,
    SubsetGaussNewtonSolver, TrustRegionQR, solve_multipose)
from momentum_tpu_torch.solver.compaction import (  # noqa: F401
    gather_batch, scatter_batch, solve_compacted)
