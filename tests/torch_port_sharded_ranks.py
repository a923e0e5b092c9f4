"""The ranks' side of tests/test_torch_port_sharded.py: each spawned rank
builds the port's problems from the numpy inputs the parent made and runs
every case through the port's sharded entry points. Imports no jax (the
ranks are fresh interpreters) and returns CPU tensors and plain values."""

import dataclasses

import numpy as np
import torch


def _position(char, targets):
    """A PositionErrorFunction on the rig's locators with `targets`
    (..., C, 3) set: stacked per frame for a (F, C, 3) list."""
    from momentum_tpu_torch.errors import PositionErrorFunction

    loc = char.locators
    ef = PositionErrorFunction.create(loc.parent.numpy(), loc.offset.numpy(),
                                      np.zeros((loc.parent.shape[0], 3)), device="cpu")
    return dataclasses.replace(ef, target=torch.as_tensor(targets))


def sequence_function(case: dict):
    """The port's SequenceSolverFunction of a sequence case: per-frame
    position targets (stacked by stack_frames) and its sequence module."""
    from momentum_tpu_torch import sequence as S
    from momentum_tpu_torch.testing.fixtures import create_test_character

    char = create_test_character(case["joints"], device="cpu")
    p, nj = char.num_model_parameters, char.num_joints
    made = {"smooth": lambda: S.ModelParametersSequenceErrorFunction.create(
                p, weight=1e-3, device="cpu"),
            "accel": lambda: S.AccelerationSequenceErrorFunction.create(
                nj, weight=5e-3, device="cpu"),
            "jerk": lambda: S.JerkSequenceErrorFunction.create(nj, weight=1e-3, device="cpu")}
    stacked = S.stack_frames([_position(char, t) for t in case["targets"]])
    return S.SequenceSolverFunction.create(
        char, case["frames"], universal=case["universal"], per_frame_errors=(stacked,),
        sequence_errors=tuple(made[name]() for name in case["sequence"]))


def _sequences(cases: dict) -> dict:
    from momentum_tpu_torch.sequence.sharded import solve_sequence_sharded
    from momentum_tpu_torch.solver import SolverOptions

    out = {}
    for name, case in cases.items():
        fn = sequence_function(case)
        res = solve_sequence_sharded(
            fn, torch.zeros(case["frames"], fn.num_per_frame), torch.zeros(fn.num_universal),
            options=SolverOptions(**case["options"]))
        out[name] = dict(per_frame=res.per_frame, universal=res.universal,
                         error=float(res.error), iterations=res.iterations,
                         converged=bool(res.converged))
    return out


def _ik(case: dict, rank: int, world: int) -> dict:
    from momentum_tpu_torch.parallel import default_mesh, solve_ik_sharded
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu_torch.testing.fixtures import create_test_character

    char = create_test_character(case["joints"], device="cpu")
    fn = SkeletonSolverFunction(char, (_position(char, case["targets"]),))
    x0 = torch.as_tensor(case["x0"])
    res = solve_ik_sharded(fn, x0, default_mesh(), options=SolverOptions(**case["options"]))
    raised = None
    if world > 1:  # a batch the group does not divide
        try:
            solve_ik_sharded(fn, x0[:world + 1], default_mesh())
        except ValueError as e:
            raised = str(e)
    sub = None
    if world > 2:  # the group of the first two ranks: every rank makes it
        group = default_mesh(2)
        if rank < 2:
            sub = solve_ik_sharded(fn, x0, group, options=SolverOptions(**case["options"])).params
    return dict(params=res.params, iterations=res.iterations, raised=raised, subgroup=sub)


def _shard_batch(rank: int, world: int) -> dict:
    """shard_batch's split-or-keep on a mixed tree, the batch found by
    itself: the largest leading dim the group divides."""
    from momentum_tpu_torch.parallel import shard_batch

    tree = dict(x=torch.arange(16 * 3).reshape(16, 3), y=torch.arange(world + 1),
                names=("a", "b"))
    part = shard_batch(tree)
    return dict(x=part["x"], y=part["y"], names=part["names"])


def _tracking(case: dict, world: int) -> dict:
    from momentum_tpu_torch.parallel import track_poses_sharded
    from momentum_tpu_torch.testing.fixtures import create_test_character
    from momentum_tpu_torch.tracking import MarkerSequence
    from momentum_tpu_torch.tracking.config import TrackingConfig

    char = create_test_character(case["joints"], device="cpu")
    pos = torch.as_tensor(case["positions"])
    markers = MarkerSequence(positions=pos, occluded=torch.zeros(pos.shape[:2], dtype=torch.bool),
                             names=tuple(char.locators.names))
    cfg = TrackingConfig(**case["config"])
    res = track_poses_sharded(char, markers, config=cfg)
    refined = track_poses_sharded(char, markers, config=TrackingConfig(
        **case["config"], refine=case["refine"]))
    raised = None
    if world > 1:
        try:
            track_poses_sharded(char, dataclasses.replace(
                markers, positions=pos[:world + 1], occluded=markers.occluded[:world + 1]),
                config=cfg)
        except ValueError as e:
            raised = str(e)
    return dict(motion=res.motion, errors=res.errors, refined_motion=refined.motion,
                refined_errors=refined.errors, raised=raised)


def run_cases(rank: int, world: int, inputs: dict) -> dict:
    """Every case of the file on this rank's group."""
    return dict(sequence=_sequences(inputs["sequence"]), ik=_ik(inputs["ik"], rank, world),
                tracking=_tracking(inputs["tracking"], world),
                shard_batch=_shard_batch(rank, world))
