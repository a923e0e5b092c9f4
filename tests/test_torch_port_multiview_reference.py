"""The port's multi-view keypoint fit against the benchmark's plain
reference (portbench/reference/projection.py: OpenCV projection, its own
forward-mode Jacobian and LM), on the CMU rig (23 joints, 73 parameters,
41 locators, metres), 4 of the dome's 31 cameras
(portbench/cameras/panoptic_hd31.json), B = 8 seeded random poses.

Tolerances:
  rows     2e-3 px: the port maps world to eye by its quaternion transform,
           the reference by a 3 × 3 matrix; ~1e-7 of a ~3 m depth is
           ~1.5e-4 px at fx = 1400, and the distortion adds its own rounding;
  energy   5e-5 relative a frame after the compacted solve (LM 15 on every
           frame, then 6 on the worst 2: converged from starts 0.05 rad
           off): both solve the same float32 problem by LM from the same
           start; their steps differ by rounding (K2+K3 against
           cholesky_ex, the analytic J against forward mode), which moved
           the energies at the minimum by up to 1.2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from momentum_tpu_torch.camera import Camera, OpenCVIntrinsics
from momentum_tpu_torch.errors import CameraProjectionErrorFunction
from momentum_tpu_torch.math import quaternion as quat
from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_compacted
from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt

from test_torch_port_helpers import one_torch_thread  # noqa: F401

CAMERAS = (0, 8, 16, 24)
B = 8
OPTS = dict(regularization=1e-5, lambda_init=0.01, lambda_up=10.0, lambda_down=0.1,
            lambda_min=1e-10, lambda_max=1e8, threshold=1.0, min_iterations=1)


@pytest.fixture(scope="module")
def problem():
    from portbench.drivers.multiview import draw_keypoints
    from portbench.reference import kinematics as kin, projection as ref
    from portbench.rig import load_rig, port_character

    rig = load_rig("portbench/rigs/cmu41.json")
    rr = kin.reference_rig(rig, "cpu")
    doc = ref.load_cameras("portbench/cameras/panoptic_hd31.json")
    doc = {**doc, "cameras": [doc["cameras"][k] for k in CAMERAS]}
    cams = ref.reference_cameras(doc, 0.01, "cpu")
    rng = np.random.default_rng(25)
    p = rig.num_parameters
    truth = rng.uniform(-0.3, 0.3, (B, p))
    truth[:, :3] = rng.uniform(-0.5, 0.5, (B, 3)) + (0.0, 0.0, 0.9)
    truth[:, 6] = 0.1
    truth = torch.as_tensor(truth, dtype=torch.float32)
    gen = torch.Generator().manual_seed(25)
    targets, conf = draw_keypoints(rr, cams, truth, {"noise_px": 1.0, "occluded_share": 0.05},
                                   gen)
    x0 = truth + 0.05 * torch.randn(truth.shape, generator=gen)
    char = port_character(rig, "cpu")
    loc = char.locators
    port_cams = []
    for c in doc["cameras"]:
        q = quat.from_rotation_matrix(torch.as_tensor(c["rotation"], dtype=torch.float32))
        eye = torch.cat([torch.as_tensor(c["translation_m"], dtype=torch.float32), q,
                         torch.ones(1)])
        port_cams.append(Camera.create(OpenCVIntrinsics.create(
            c["fx"], c["fy"], c["cx"], c["cy"], k=c["k"], p=c["p"], device="cpu"), eye))
    first = CameraProjectionErrorFunction.create(port_cams[0], loc.parent.numpy(),
                                                 loc.offset.numpy(), np.zeros((41, 2)),
                                                 device="cpu")
    templates = [dataclasses.replace(first, camera=c) for c in port_cams]
    return rr, cams, char, templates, targets, conf, x0


def _fn(char, templates, targets, conf):
    return SkeletonSolverFunction(char, tuple(
        dataclasses.replace(t, target=targets[:, k], cweight=conf[:, k])
        for k, t in enumerate(templates)))


def test_rows_match_the_reference(problem):
    from portbench.reference import projection as ref

    rr, cams, char, templates, targets, conf, x0 = problem
    assert 0.3 < float(conf.mean()) < 1.0  # some keypoints out of view or occluded
    rows = _fn(char, templates, targets, conf).residual(x0)
    want = ref.residual(rr, cams, x0, targets, conf)
    assert rows.shape == want.shape == (B, 2 * len(CAMERAS) * 41)
    torch.testing.assert_close(rows, want, rtol=0, atol=2e-3)
    rows_j, _ = _fn(char, templates, targets, conf).residual_and_jacobian(x0)
    torch.testing.assert_close(rows_j, want, rtol=0, atol=2e-3)


def test_compacted_solve_energies_match_the_reference(problem):
    from portbench.reference import projection as ref

    rr, cams, char, templates, targets, conf, x0 = problem

    def stage(inputs, x, iters, lam0):
        fn = _fn(char, templates, *inputs)
        return solve_levenberg_marquardt(
            fn.residual, fn.error, x,
            options=SolverOptions(max_iterations=iters, energy_from_residual=True, **OPTS),
            jacobian_fn=fn.residual_and_jacobian, lambda0=lam0)

    got = solve_compacted(stage, (targets, conf), x0, capacity=2, k_full=15, r_refine=6).params
    want, _ = ref.solve_compacted(rr, cams, targets, conf, x0, OPTS, 15, 6, 2, block=4)
    e_got = ref.energies(rr, cams, got, targets, conf)
    e_want = ref.energies(rr, cams, want, targets, conf)
    e_start = ref.energies(rr, cams, x0, targets, conf)
    assert bool((e_want < 0.5 * e_start).all())  # the solve does real work
    torch.testing.assert_close(e_got, e_want, rtol=5e-5, atol=0)
