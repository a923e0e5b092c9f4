from momentum_tpu_torch.sequence.block_tridiag import (  # noqa: F401
    banded_to_tridiag, block_tridiag_solve, schur_arrowhead_solve)
from momentum_tpu_torch.sequence.errors import (  # noqa: F401
    AccelerationSequenceErrorFunction, FiniteDifferenceSequenceErrorFunction,
    JerkSequenceErrorFunction, JointToJointSequenceErrorFunction,
    ModelParametersSequenceErrorFunction, SdfCollisionSequenceErrorFunction,
    SequenceErrorFunction, StateSequenceErrorFunction, VelocityMagnitudeSequenceErrorFunction,
    VertexSequenceErrorFunction)
from momentum_tpu_torch.sequence.solver import SequenceSolveResult, solve_sequence  # noqa: F401
from momentum_tpu_torch.sequence.solver_function import (  # noqa: F401
    SequenceSolverFunction, broadcast_frames, stack_frames)
