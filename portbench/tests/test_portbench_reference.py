"""The frozen rig and the plain reference against the port's plain CPU
paths, at small sizes. The reference itself imports nothing of the port;
these tests only compare the two."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import motion
from portbench.reference import ik as ref_ik
from portbench.reference import kinematics as kin
from portbench.reference import sequence as ref_seq
from portbench.rig import load_rig, port_character, universal_mask

RIG = "portbench/rigs/cmu41.json"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rig():
    return load_rig(RIG)


def test_frozen_rig_is_the_cmu_humanoid(rig):
    from momentum_tpu_torch.tracking.cmu import create_cmu_character

    fixture = create_cmu_character(device="cpu")
    char = port_character(rig, CPU)
    assert fixture.skeleton.joint_names == char.skeleton.joint_names
    assert torch.equal(fixture.skeleton.joint_parent, char.skeleton.joint_parent)
    # the frozen rig's lengths are in m, the module's in mm
    torch.testing.assert_close(fixture.skeleton.translation_offset / 1000,
                               char.skeleton.translation_offset, rtol=1e-6, atol=0)
    assert torch.equal(fixture.skeleton.pre_rotation, char.skeleton.pre_rotation)
    pt, fpt = char.parameter_transform, fixture.parameter_transform
    assert torch.equal(fpt.transform, pt.transform) and torch.equal(fpt.offsets, pt.offsets)
    assert fpt.names == pt.names and fpt.parameter_sets == pt.parameter_sets
    assert fixture.locators.names == char.locators.names
    assert torch.equal(fixture.locators.parent, char.locators.parent)
    torch.testing.assert_close(fixture.locators.offset / 1000, char.locators.offset,
                               rtol=1e-6, atol=0)
    assert torch.equal(fixture.locators.weight, char.locators.weight)
    assert fixture.limits.minmax_index.numel() == char.limits.minmax_index.numel() == 0
    assert (len(rig.joint_names), rig.num_parameters, rig.locator_parents.size) == (23, 73, 41)


def _take(rig, frames, seed):
    """(truth (F, P), markers (F, L, 3)) of one take of the cells' motion."""
    traffic = json.loads((ROOT / "portbench/traffic/ik.b65536.json").read_text())
    truth, markers = motion.draw_takes(kin.reference_rig(rig, CPU), traffic["motion"], 1, frames,
                                       rig.num_parameters, torch.Generator().manual_seed(seed),
                                       CPU)
    return truth[0], markers[0]


def _position_error(rig, targets):
    from momentum_tpu_torch.errors import PositionErrorFunction

    ef = PositionErrorFunction.create(rig.locator_parents, rig.locator_offsets,
                                      np.zeros_like(rig.locator_offsets), device="cpu")
    return dataclasses.replace(ef, target=targets)


def test_reference_fk_and_energy_match_the_port(rig):
    char = port_character(rig, CPU)
    rr = kin.reference_rig(rig, CPU)
    theta, targets = _take(rig, 16, 1)
    port = char.locators.world_positions(char.skeleton_states(theta))
    ref = kin.locator_positions(rr, theta)
    torch.testing.assert_close(ref, port, rtol=0, atol=2e-6)
    torch.testing.assert_close(kin.energy(rr, theta, targets),
                               torch.sum((port - targets) ** 2, dim=(-2, -1)),
                               rtol=1e-4, atol=1e-9)


def test_reference_jacobian_matches_the_port(rig):
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    char = port_character(rig, CPU)
    rr = kin.reference_rig(rig, CPU)
    truth, targets = _take(rig, 8, 3)
    theta = motion.keyframe_starts(truth, 8)
    fn = SkeletonSolverFunction(char, (_position_error(rig, targets),))
    rows, jac = fn.residual_and_jacobian(theta)
    ref_rows, ref_jac = kin.residual_and_jacobian(rr, theta, targets)
    torch.testing.assert_close(ref_rows, rows, rtol=0, atol=2e-6)
    torch.testing.assert_close(ref_jac, jac, rtol=0, atol=5e-6)


def test_keyframe_starts_interpolate_between_keyframes():
    truth = torch.arange(10, dtype=torch.float32)[:, None].expand(10, 2) ** 2
    starts = motion.keyframe_starts(truth, 4)
    assert torch.equal(starts[[0, 4, 8, 9]], truth[[0, 4, 8, 9]])
    torch.testing.assert_close(starts[2], 0.5 * (truth[0] + truth[4]))
    torch.testing.assert_close(starts[6], 0.5 * (truth[4] + truth[8]))


def test_reference_lm_follows_the_port(rig):
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt

    config = json.loads((ROOT / "portbench/configs/fullbody_ik.json").read_text())
    opts = config["solver"]["options"]
    char = port_character(rig, CPU)
    rr = kin.reference_rig(rig, CPU)
    truth, targets = _take(rig, 48, 5)
    x0 = motion.keyframe_starts(truth, 8)
    fn = SkeletonSolverFunction(char, (_position_error(rig, targets),))
    res = solve_levenberg_marquardt(fn.residual, fn.error, x0,
                                    options=SolverOptions(**{**opts, "max_iterations": 5}),
                                    jacobian_fn=fn.residual_and_jacobian)
    x, err, _ = ref_ik.levenberg_marquardt(rr, targets, x0, 5, None, opts)
    # the same iterates up to float32 round-off: the energies, set by the
    # markers' noise at the end, agree closely
    e_port = ref_ik.energies(rr, res.params, targets)
    assert torch.median(e_port) / torch.median(err) == pytest.approx(1.0, rel=1e-3)
    assert 2 * float(torch.median(err)) < float(torch.median(kin.energy(rr, x0, targets)))


def test_reference_sequence_gn_follows_the_port(rig):
    from momentum_tpu_torch.sequence import (
        ModelParametersSequenceErrorFunction, SequenceSolverFunction, solve_sequence)
    from momentum_tpu_torch.solver import SolverOptions

    frames = 10
    char = port_character(rig, CPU)
    rr = kin.reference_rig(rig, CPU)
    _, targets = _take(rig, frames, 7)
    universal = universal_mask(rig, "scaling")
    fn = SequenceSolverFunction.create(
        char, frames, universal=universal,
        per_frame_errors=(_position_error(rig, targets),),
        sequence_errors=(ModelParametersSequenceErrorFunction.create(
            rig.num_parameters, weight=0.1, device="cpu"),))
    pf0 = motion.centroid_starts(targets, rig.num_parameters)[:, ~universal]
    u0 = torch.zeros(1)
    res = solve_sequence(fn, pf0, u0, SolverOptions(max_iterations=4))
    take = ref_seq.Take(rr, targets, torch.as_tensor(universal), 0.1)
    opts = {"max_iterations": 4, "regularization": 0.05, "min_iterations": 1, "threshold": 1.0,
            "diag_floor": 1e-5, "band_jitter": 1e-7, "universal_jitter": 1e-6}
    pf, u, err, it = ref_seq.gauss_newton(take, pf0, u0, opts)
    assert it == res.iterations
    torch.testing.assert_close(pf, res.per_frame, rtol=0, atol=2e-3)
    torch.testing.assert_close(u, res.universal, rtol=0, atol=1e-4)
    assert err == pytest.approx(float(res.error), rel=1e-4)
    assert float(take.energy(pf0, u0)) > 10 * err
