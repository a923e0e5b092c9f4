"""The workloads of the port: the bench.py IK workload of
momentum_tpu/testing/workloads.py, bench.py's full residual stack
(bench.py:242-323), and the shadowed render of a posed clip of
benchmarks/bench_suite.py::config7.

Full-body marker IK (51-joint / 157-parameter rig, 80 position constraints),
warm-started batch-native LM: `k_full` full-batch iterations, then `r_refine`
compacted iterations on the worst `capacity` elements
(solver/compaction.py). The random numbers come from numpy exactly as the
JAX workload draws them, so both packages solve the same problem from the
same seed.

The full residual stack is the same problem with the terms the reference's
per-frame tracker always carries (marker_tracker.cpp:645-653): orientation
targets on all 51 joints from the ground-truth rotations, the fixture's
MinMax limits, and a two-component MPPCA pose prior; solved by Gauss-Newton
on the normal equations, 2 full-batch iterations then 1 more on the worst
half by marker energy. Config 2 of benchmarks/bench_suite.py runs the same
modules by LM: one frame (:118-155), and each element's 40-iteration LM
optimum as 2b's yardstick (:229-231).

Config 4 (:244-367) fits pose and 8 blend-shape coefficients of the same rig
to 306 of its skinned mesh vertices: one frame by LM, and 2b's batch of 256 by
Gauss-Newton, 4 full-batch iterations then 2 more on the worst 64.

Config 5 (:378-418) solves a whole take at once: F = 1024 frames of
position targets from uniform-random poses, a motion-smoothness term
(ModelParametersSequenceErrorFunction, weight 0.1), the rig's "scaling"
parameters shared by all frames (none on the 16-joint test rig of config
5, the global scale on the full-body rig of 5f), Gauss-Newton 8 on the
block-banded normal equations (sequence/solver.py).

Config 6s (a synthetic stand-in for config 6, :441-560, whose CMU take is
not in the repository) tracks a clip of the take's size, 343 frames × 41
markers, on the CMU rig (tracking/cmu.py: 23 joints, 73 parameters, mm,
z-up): a walk of 2 m along x, every rotation a sine of random amplitude and
phase (tests/test_tracking.py's recipe), the global scale at 0.1 (log2),
the markers the locators' positions plus N(0, 2 mm) noise, each occluded
on 5% of the frames. Its five stages are config 6's: calibration, the
locators-only pass, per-frame tracking, the smoothed refine and
hierarchical batched tracking.

The render clip: the full-body character's skinned tube mesh (612 vertices,
612 faces) posed by a 32-frame random walk in its 157 parameters, rendered
with Lambert shading and a 256 × 256 shadow map at 1280 × 960 and box-
filtered to 640 × 480 — the reference rasterizer's one published
performance figure (~45 fps on an 8-core CPU).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["build_fullbody_ik_problem", "make_solve_stage", "make_solve_batch",
           "DEFAULT_REFINE", "DEFAULT_BATCH", "build_fullstack_problem",
           "make_fullstack_solve", "FULLSTACK_REFINE", "fullstack_modules",
           "fullstack_lm_optimum",
           "build_fullstack_frame", "solve_fullstack_frame", "VertexFitProblem",
           "VERTEX_FIT_REFINE", "VERTEX_FIT_BATCH", "build_vertex_fit_problem",
           "make_vertex_fit_solve", "solve_vertex_fit_frame", "SEQUENCE_FRAMES",
           "SequenceProblem", "build_sequence_problem", "make_sequence_solve",
           "TRACKING_FRAMES", "TrackingClip", "tracking_clip_draws", "build_tracking_clip",
           "calibration_frames", "calibrate_clip", "calibrate_clip_locators",
           "track_clip_per_frame", "refine_clip", "track_clip_hierarchical",
           "clip_marker_errors_mm",
           "build_render_clip",
           "make_render_clip", "clip_vertices", "render_clip_passes",
           "CATALOG_BATCH", "CATALOG_MORE", "CatalogProblem", "catalog_recipe", "catalog_draws",
           "catalog_character", "build_catalog_ik_problem", "solve_catalog",
           "catalog_energies", "catalog_figures", "KEYPOINT_PROJECTION_WEIGHT",
           "keypoint_recipe", "keypoint_draws", "build_keypoint_clip", "track_clip_keypoints",
           "refine_clip_keypoints", "clip_reprojection_errors_px"]

# 5 full-batch LM iterations + 6 compacted iterations on the worst 128 of 2048
DEFAULT_REFINE = (5, 6, 128)
DEFAULT_BATCH = 2048
# full stack: 2 full-batch GN iterations + 1 on the worst 1024 of 2048 (bench.py:277)
FULLSTACK_REFINE = (2, 1, 1024)


def build_fullbody_ik_problem(batch: int, seed: int = 0, noise: float = 0.05,
                              device="cuda", return_states: bool = False):
    """(char, ef0, targets, x0[, states]) on `device` (the card unless the
    caller asks for the CPU): targets are exact locator positions of
    uniform-random ground-truth poses; x0 is truth + `noise` gaussian;
    return_states adds the ground truth's global states."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_fullbody_ik_problem")
    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(seed)
    gt_np = rng.uniform(-0.3, 0.3, (batch, char.num_model_parameters)).astype(np.float32)
    gt = torch.as_tensor(gt_np, device=device)
    states = char.skeleton_states(gt)
    targets = char.locators.world_positions(states)
    ef0 = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device=device)
    x0 = gt + torch.as_tensor(rng.normal(0, noise, gt_np.shape).astype(np.float32),
                              device=device)
    if return_states:
        return char, ef0, targets, x0, states
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


def fullstack_modules(char, device) -> tuple:
    """bench.py's full-stack modules for `char` on `device`: (position on
    the locators, orientation on all joints, limits, a two-component MPPCA
    pose prior over every parameter), the first two with placeholder
    targets."""
    from momentum_tpu_torch.errors import (
        LimitErrorFunction, Mppca, OrientationErrorFunction, PositionErrorFunction,
        PosePriorErrorFunction)

    nj, p = char.num_joints, char.num_model_parameters
    ef_pos = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device=device)
    ef_ori = OrientationErrorFunction.create(
        np.arange(nj, dtype=np.int32), np.tile(np.asarray([0, 0, 0, 1], np.float32), (nj, 1)),
        device=device)
    names = char.parameter_transform.names
    prior = Mppca.from_components(
        pi=np.asarray([0.6, 0.4]), mu=np.zeros((2, p), np.float32),
        w_list=[np.full((p, 4), 0.01, np.float32)] * 2, sigma2=np.asarray([1.0, 2.0]),
        names=names, device=device)
    return (ef_pos, ef_ori, LimitErrorFunction.create(device=device),
            PosePriorErrorFunction.create(prior, names))


def build_fullstack_problem(batch: int, seed: int = 0, noise: float = 0.05,
                            device="cuda"):
    """(char, efs, targets, q_targets, x0) on `device` (the card unless the
    caller asks for the CPU): the IK problem of
    build_fullbody_ik_problem with bench.py's full-stack modules
    efs = fullstack_modules(char); q_targets (B, 51, 4) are the ground
    truth's global rotations."""
    device = resolve(device, "build_fullstack_problem")
    char, _, targets, x0, states = build_fullbody_ik_problem(
        batch, seed=seed, noise=noise, device=device, return_states=True)
    return char, fullstack_modules(char, device), targets, states[..., 3:7], x0


def make_fullstack_solve(char, efs, batch: int):
    """bench.py's full-stack solve `(targets, q_targets, x0) -> (params,
    marker energy (B,), full-stack energy (B,))`: GN (regularization 1e-5,
    Σ rows² as the energy) through solve_ik for 2 iterations on the whole
    batch, then 1 more on the 1024 elements of highest marker energy (NaN
    and inf first; FULLSTACK_REFINE). GN keeps no state between iterations,
    so the refined elements follow the (k_full + r_refine)-iteration solve
    exactly. The full-stack energy is the solver's (Σ rows² before its last
    step), which bench_suite.py's config 2b holds against the 40-iteration
    LM optimum (`fullstack_lm_optimum`). The capacity, quoted at B = 2048,
    scales with the batch."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    ef_pos, ef_ori, lim, prior = efs
    k_full, r_refine, cap = FULLSTACK_REFINE
    cap = min(batch, cap * batch // DEFAULT_BATCH if batch < DEFAULT_BATCH else cap)
    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)

    def stage(targets, q_targets, x0, iters):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef_pos, target=targets),
                                           dataclasses.replace(ef_ori, target=q_targets),
                                           lim, prior))
        return solve_ik(fn, x0, options=dataclasses.replace(opts, max_iterations=iters),
                        method="gauss_newton")

    def marker_energy(targets, params):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef_pos, target=targets),))
        return fn.error(params)

    def solve(targets, q_targets, x0):
        res = stage(targets, q_targets, x0, k_full)
        energy = marker_energy(targets, res.params)
        key = torch.nan_to_num(energy, nan=3.0e38, posinf=3.0e38)
        _, idx = torch.topk(key, cap)
        sub = stage(targets[idx], q_targets[idx], res.params[idx], r_refine)
        return (res.params.index_copy(0, idx, sub.params),
                energy.index_copy(0, idx, marker_energy(targets[idx], sub.params)),
                res.error.index_copy(0, idx, sub.error))

    return solve


def _fullstack_fn(char, efs, targets, q_targets):
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    ef_pos, ef_ori, lim, prior = efs
    return SkeletonSolverFunction(char, (dataclasses.replace(ef_pos, target=targets),
                                         dataclasses.replace(ef_ori, target=q_targets),
                                         lim, prior))


def fullstack_lm_optimum(char, efs, targets, q_targets, x0):
    """Each element's LM optimum on the full stack's normal equations
    (bench_suite.py config 2b, :229-231): solve_ik's LM, regularization
    1e-5, Σ rows² as the energy, 40 iterations. A SolveResult."""
    from momentum_tpu_torch.solver import SolverOptions, solve_ik

    opts = SolverOptions(max_iterations=40, regularization=1e-5, energy_from_residual=True)
    return solve_ik(_fullstack_fn(char, efs, targets, q_targets), x0, options=opts,
                    method="levenberg_marquardt")


def build_fullstack_frame(seed: int = 0, device="cuda"):
    """(char, efs, x0 (P,)) on `device` (the card unless the caller asks for
    the CPU): bench_suite.py config 2's single frame (:118-153), drawn from
    numpy as the JAX recipe draws it: ground truth U(−0.3, 0.3), the full
    stack's four modules with the truth's locator positions and global
    rotations as targets (position and orientation set), x0 = truth +
    0.05·N(0, 1)."""
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_fullstack_frame")
    char = create_fullbody_character(device=device)
    efs = fullstack_modules(char, device)
    p = char.num_model_parameters
    rng = np.random.default_rng(seed)
    gt = torch.as_tensor(rng.uniform(-0.3, 0.3, p).astype(np.float32), device=device)
    states = char.skeleton_states(gt)
    efs = (dataclasses.replace(efs[0], target=char.locators.world_positions(states)),
           dataclasses.replace(efs[1], target=states[..., 3:7]), *efs[2:])
    x0 = gt + 0.05 * torch.as_tensor(rng.normal(0, 1, p).astype(np.float32), device=device)
    return char, efs, x0


def solve_fullstack_frame(char, efs, x0):
    """Config 2's single-frame solve: solve_ik's LM, 20 iterations with the
    default options (regularization 0.05, the exact energy), over the full
    stack, whose limits and prior add their own normal equations."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    return solve_ik(SkeletonSolverFunction(char, efs), x0,
                    options=SolverOptions(max_iterations=20),
                    method="levenberg_marquardt")


class VertexFitProblem(NamedTuple):
    """bench_suite.py config 4 (:244-318) on one device."""

    char: object  # the full-body rig with 8 blend shapes (P = 165)
    ef0: object  # VertexPositionErrorFunction on every 2nd vertex, zero targets
    gt_frame: torch.Tensor  # (P,) the single frame's truth
    targets_frame: torch.Tensor  # (C, 3) its posed vertices
    gt: torch.Tensor  # (B, P) config 4b's truths
    targets: torch.Tensor  # (B, C, 3)
    x0: torch.Tensor  # (B, P) truth + 0.05·N(0, 1)


# config 4b: 4 full-batch GN iterations + 2 on the worst 64 of 256 (bench_suite.py:321-342)
VERTEX_FIT_REFINE = (4, 2, 64)
VERTEX_FIT_BATCH = 256


def build_vertex_fit_problem(batch: int = VERTEX_FIT_BATCH, seed: int = 1,
                             device="cuda") -> VertexFitProblem:
    """Config 4's problem on `device` (the card unless the caller asks for
    the CPU), drawn from numpy exactly as the JAX recipe draws it: from
    seed 0, 8 blend shapes of N(0, 0.01) over the rig's 612-vertex mesh and
    the single frame's truth (U(−0.2, 0.2) on the 157 pose parameters,
    U(−1, 1) on the 8 coefficients); from `seed` (config 4b: 1), `batch`
    truths the same way and x0 = truth + 0.05·N(0, 1). Targets are the
    truths' posed vertices, every 2nd vertex (306 of them, 918 rows)."""
    from momentum_tpu_torch.character.blend_shape import BlendShape
    from momentum_tpu_torch.character.utility import add_blend_shape_parameters
    from momentum_tpu_torch.errors import VertexPositionErrorFunction
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_vertex_fit_problem")
    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(0)
    v, k = char.mesh.num_vertices, 8
    vectors = rng.normal(0, 0.01, (k, v, 3)).astype(np.float32)
    char = add_blend_shape_parameters(char, BlendShape(
        base_shape=char.mesh.vertices, shape_vectors=torch.as_tensor(vectors, device=device)))
    p = char.num_model_parameters

    def truth(r, lead):
        return np.concatenate([r.uniform(-0.2, 0.2, lead + (p - k,)),
                               r.uniform(-1, 1, lead + (k,))], axis=-1).astype(np.float32)

    gt_frame = torch.as_tensor(truth(rng, ()), device=device)
    vid = np.arange(0, v, max(v // 256, 1), dtype=np.int32)
    ef0 = VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)), device=device)
    fn0 = SkeletonSolverFunction(char, (ef0,))
    rng_b = np.random.default_rng(seed)
    gt = torch.as_tensor(truth(rng_b, (batch,)), device=device)
    x0 = gt + 0.05 * torch.as_tensor(rng_b.normal(0, 1, (batch, p)).astype(np.float32),
                                     device=device)
    return VertexFitProblem(
        char=char, ef0=ef0, gt_frame=gt_frame,
        targets_frame=fn0.context(gt_frame).mesh_vertices.index_select(-2, ef0.vertex_index),
        gt=gt, targets=fn0.context(gt).mesh_vertices.index_select(-2, ef0.vertex_index), x0=x0)


def make_vertex_fit_solve(char, ef0, batch: int):
    """Config 4b's solve `(targets, x0) -> SolveResult`: solve_ik's GN
    (regularization 1e-5, Σ rows² as the energy) on the vertex rows' analytic
    Jacobian, VERTEX_FIT_REFINE = (k_full, r_refine, capacity) through
    solve_compacted. The capacity, quoted at B = 256, scales with the
    batch."""
    from momentum_tpu_torch.solver import (
        SkeletonSolverFunction, SolverOptions, solve_compacted, solve_ik)

    k_full, r_refine, cap = VERTEX_FIT_REFINE
    cap = min(batch, max(1, cap * batch // VERTEX_FIT_BATCH))
    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)

    def stage(targets, x0, iters, _lam0):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
        return solve_ik(fn, x0, options=dataclasses.replace(opts, max_iterations=iters),
                        method="gauss_newton")

    def solve(targets, x0):
        return solve_compacted(stage, targets, x0, capacity=cap, k_full=k_full,
                               r_refine=r_refine)

    return solve


def solve_vertex_fit_frame(char, ef0, targets, x0):
    """Config 4's single-frame fit (:285-295): solve_ik's LM, 20 iterations
    with the default options, on x0 (P,) against one frame's targets (C, 3)."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    return solve_ik(fn, x0, options=SolverOptions(max_iterations=20),
                    method="levenberg_marquardt")


SEQUENCE_FRAMES = 1024  # config 5's frame count (bench_suite.py:378)


class SequenceProblem(NamedTuple):
    """bench_suite.py config 5 (:378-418) on one device."""

    fn: object  # SequenceSolverFunction: stacked position targets + motion smoothness
    pf0: torch.Tensor  # (F, n_pf) zeros
    u0: torch.Tensor  # (n_u,) zeros
    gt: torch.Tensor  # (F, P) the truths the targets come from


def build_sequence_problem(frames: int = SEQUENCE_FRAMES, fullbody: bool = False,
                           seed: int = 0, device="cuda") -> SequenceProblem:
    """Config 5's problem (5f with fullbody) on `device` (the card unless the
    caller asks for the CPU), drawn from numpy as the JAX recipe draws it:
    truths U(−0.2, 0.2) over (F, P) from `seed`, their locator positions as
    the targets of one stacked PositionErrorFunction, motion smoothness of
    weight 0.1, the rig's "scaling" set universal; the solve starts from
    zero."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.sequence import (
        ModelParametersSequenceErrorFunction, SequenceSolverFunction)
    from momentum_tpu_torch.testing.fixtures import (
        create_fullbody_character, create_test_character)

    device = resolve(device, "build_sequence_problem")
    char = (create_fullbody_character(device=device) if fullbody
            else create_test_character(16, device=device))
    p = char.num_model_parameters
    rng = np.random.default_rng(seed)
    gt = torch.as_tensor(rng.uniform(-0.2, 0.2, (frames, p)).astype(np.float32), device=device)
    targets = char.locators.world_positions(char.skeleton_states(gt))
    ef0 = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device=device)
    universal = np.zeros(p, bool)
    universal[list(char.parameter_transform.parameter_sets.get("scaling", ()))] = True
    fn = SequenceSolverFunction.create(
        char, frames, universal=universal,
        per_frame_errors=(dataclasses.replace(ef0, target=targets),),
        sequence_errors=(ModelParametersSequenceErrorFunction.create(p, weight=0.1,
                                                                     device=device),))
    pf0, u0 = fn.split(torch.zeros(frames, p, device=device))
    return SequenceProblem(fn=fn, pf0=pf0, u0=u0, gt=gt)


def make_sequence_solve(fn, options=None):
    """Config 5's solve `(pf0, u0) -> SequenceSolveResult`: solve_sequence
    with `options` (config 5's SolverOptions(max_iterations=8) by default)."""
    from momentum_tpu_torch.sequence import solve_sequence
    from momentum_tpu_torch.solver import SolverOptions

    options = SolverOptions(max_iterations=8) if options is None else options
    return lambda pf0, u0: solve_sequence(fn, pf0, u0, options)


TRACKING_FRAMES = 343  # config 6's take, 02_01.c3d (bench_suite.py:442-444)
TRACKING_SCALE = 0.1  # config 6s's true scale_global (log2)


class TrackingClip(NamedTuple):
    """Config 6s on one device."""

    char: object  # the CMU rig (tracking/cmu.py)
    markers: object  # MarkerSequence (F, 41, 3) with its occlusion mask
    truth: torch.Tensor  # (F, 73) the motion the markers come from
    seed_params: torch.Tensor  # (73,) zeros with the root at frame 0's marker centroid


def tracking_clip_draws(frames: int, seed: int, num_params: int, num_markers: int):
    """Config 6s's numpy draws, in order: (motion (F, P) float32, marker
    noise (F, M, 3) in mm, occluded (F, M) bool). Root x walks 0 → 2000 mm,
    root y stays 0, root z = 900 + 20·sin(2πt) mm; every rotation parameter
    is amp·sin(2πt + phase) with amp U(0.05, 0.3) rad and phase U(0, 2π)
    (tests/test_tracking.py:33-52); scale_global (parameter 6) is 0.1."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, frames)[:, None]
    amp = rng.uniform(0.05, 0.3, num_params)
    phase = rng.uniform(0.0, 2 * np.pi, num_params)
    motion = amp * np.sin(2 * np.pi * t + phase)
    motion[:, 0] = np.linspace(0.0, 2000.0, frames)
    motion[:, 1] = 0.0
    motion[:, 2] = 900.0 + 20.0 * np.sin(2 * np.pi * t[:, 0])
    motion[:, 6] = TRACKING_SCALE
    noise = rng.normal(0.0, 2.0, (frames, num_markers, 3))
    occluded = rng.random((frames, num_markers)) < 0.05
    return motion.astype(np.float32), noise.astype(np.float32), occluded


def build_tracking_clip(frames: int = TRACKING_FRAMES, seed: int = 0,
                        device="cuda") -> TrackingClip:
    """Config 6s on `device` (the card unless the caller asks for the CPU):
    the CMU rig, `tracking_clip_draws`' motion, its locators' positions by
    the port's FK plus the noise, and the occlusion mask."""
    from momentum_tpu_torch.tracking import MarkerSequence, create_cmu_character

    device = resolve(device, "build_tracking_clip")
    char = create_cmu_character(device=device)
    motion, noise, occluded = tracking_clip_draws(
        frames, seed, char.num_model_parameters, char.locators.num_locators)
    truth = torch.as_tensor(motion, device=device)
    positions = (char.locators.world_positions(char.skeleton_states(truth))
                 + torch.as_tensor(noise, device=device))
    markers = MarkerSequence(positions=positions,
                             occluded=torch.as_tensor(occluded, device=device),
                             names=char.locators.names)
    seed_params = torch.zeros(char.num_model_parameters, device=device)
    seed_params[:3] = positions[0].mean(dim=0)
    return TrackingClip(char=char, markers=markers, truth=truth, seed_params=seed_params)


def _tracking_configs():
    """Config 6's settings (bench_suite.py:459-534): calibration, per-frame
    tracking, the refine."""
    from momentum_tpu_torch.tracking import CalibrationConfig, RefineConfig, TrackingConfig

    lm = "levenberg_marquardt"
    return (CalibrationConfig(calib_frames=10, major_iter=2, max_iter=25, regularization=1e-3,
                              method=lm),
            TrackingConfig(max_iter=15, regularization=1e-3, method=lm),
            RefineConfig(max_iter=10, regularization=1e-3, smoothing=1e-4, method=lm))


def calibration_frames(frames: int) -> np.ndarray:
    """The frames calibrate_model samples from a clip of `frames` with
    config 6's 10 calibration frames (no greedy sampling)."""
    return np.arange(0, frames, max(1, frames // 10))[:10]


def calibrate_clip(clip: TrackingClip):
    """Stage 1: (identity (P,), motion of the sampled frames) by
    calibrate_model (10 frames, 2 rounds, LM 25, regularization 1e-3) from
    `seed_params`."""
    from momentum_tpu_torch.tracking import calibrate_model

    return calibrate_model(clip.char, clip.markers, _tracking_configs()[0],
                           initial=clip.seed_params)


def calibrate_clip_locators(clip: TrackingClip, identity: torch.Tensor):
    """Stage 2: (the rig with its locator offsets re-estimated, motion of
    the sampled frames): one locators-only round from `identity`."""
    from momentum_tpu_torch.tracking import calibrate_model

    cfg = dataclasses.replace(_tracking_configs()[0], locators_only=True, major_iter=1)
    _, motion, char = calibrate_model(clip.char, clip.markers, cfg, initial=identity)
    return char, motion


def track_clip_per_frame(char, markers, identity: torch.Tensor):
    """Stage 3: warm-started per-frame tracking (LM 15) → TrackingResult."""
    from momentum_tpu_torch.tracking import track_poses_per_frame

    return track_poses_per_frame(char, markers, _tracking_configs()[1], initial=identity)


def refine_clip(char, markers, motion: torch.Tensor):
    """Stage 4: the smoothed whole-clip refine of `motion` (GN 10 with line
    search, smoothing 1e-4, float64 normal equations) → TrackingResult."""
    from momentum_tpu_torch.tracking import refine_motion

    return refine_motion(char, markers, motion, _tracking_configs()[2])[0]


def track_clip_hierarchical(char, markers, identity: torch.Tensor, stride: int = 8):
    """Stage 5: keyframes every `stride` frames by the warm-started chain,
    then every frame at once, LM 10 and 5 more on the worst 64 →
    TrackingResult."""
    from momentum_tpu_torch.tracking import track_poses_hierarchical

    cfg = dataclasses.replace(_tracking_configs()[1], refine=(10, 5, 64))
    return track_poses_hierarchical(char, markers, cfg, initial=identity, stride=stride)


def clip_marker_errors_mm(char, markers, motion: torch.Tensor, rows=slice(None)) -> np.ndarray:
    """The distances (mm) between the matched locators of `motion` and the
    visible markers of the frames `rows`, flattened (bench_suite.py config
    6's `_err_mm`)."""
    from momentum_tpu_torch.tracking.tracker import _match_locators

    li, mi = _match_locators(char, markers)
    world = char.locators.world_positions(char.skeleton_states(motion)).cpu().numpy()
    pos, occ = markers.positions.cpu().numpy()[rows], markers.occluded.cpu().numpy()[rows]
    return np.linalg.norm(world[:, li] - pos[:, mi], axis=-1)[~occ[:, mi]]


def build_render_clip(frames: int = 32, seed: int = 0, device="cuda",
                      image_height: int = 960, image_width: int = 1280):
    """(char, motion (frames, 157), camera) on `device` (the card unless the
    caller asks for the CPU): config 7's character, its random-walk clip
    (cumulative 0.02·N(0, 1) steps from numpy, as the JAX recipe draws them)
    and the camera framing every frame at the render size."""
    from momentum_tpu_torch.rasterizer.utils import create_camera_for_body
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_render_clip")
    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(seed)
    steps = 0.02 * rng.normal(0, 1, (frames, char.num_model_parameters)).astype(np.float32)
    motion = torch.as_tensor(np.cumsum(steps, axis=0), device=device)
    cam = create_camera_for_body(char, char.skeleton_states(motion), image_height,
                                 image_width)
    return char, motion, cam


def clip_vertices(char, motion) -> torch.Tensor:
    """(frames, V, 3) skinned mesh vertices of every frame of `motion`: FK
    in one batch (kernel K1 on the card), then LBS skinning."""
    from momentum_tpu_torch.character.skinning import skin_points

    return skin_points(char.skin_weights, char.skeleton_states(motion),
                       char.inverse_bind_pose, char.mesh.vertices)


def make_render_clip(char, cam, width: int = 640, height: int = 480, supersample: int = 2,
                     shadow_resolution: int = 256):
    """`render_clip(motion) -> (frames, height, width, 3)` colour images:
    `clip_vertices`, then per frame `render_mesh_shadowed` at
    (supersample·height, supersample·width) (two rasterizer passes, kernel
    K4b on the card) and a supersample × supersample box filter."""
    from momentum_tpu_torch.rasterizer import render_mesh_shadowed

    ss = supersample

    def render_clip(motion):
        verts = clip_vertices(char, motion)
        frames = []
        for v in verts:
            out = render_mesh_shadowed(cam, v, char.mesh.faces, width * ss, height * ss,
                                       shadow_resolution=shadow_resolution)
            frames.append(out["color"].reshape(height, ss, width, ss, 3).mean(dim=(1, 3)))
        return torch.stack(frames)

    return render_clip


def render_clip_passes(char, cam, motion, width: int = 640, height: int = 480,
                       supersample: int = 2, shadow_resolution: int = 256) -> list:
    """Per frame of `make_render_clip(char, cam, ...)(motion)`, its two
    rasterizer passes as `ops/raster.py::_kernel_args` builds them (the
    arguments of one K4b launch): [{"camera": args, "shadow": args}, ...]."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    faces = char.mesh.faces
    frames = []
    for v in clip_vertices(char, motion):
        passes = render.shadowed_passes(cam, v, faces, width * supersample,
                                        height * supersample,
                                        shadow_resolution=shadow_resolution)
        frame = {}
        for name in ("camera", "shadow"):
            sv, w, h, kw = passes[name]
            frame[name] = raster._kernel_args(sv, faces, w, h, **kw)
        frames.append(frame)
    return frames


# ---- config C: batched IK over the whole rigid error catalog ----

CATALOG_BATCH = 2048
CATALOG_ITERATIONS = 10
CATALOG_MORE = 20  # conv_at_1e5's yardstick: the solve continued this many iterations
CATALOG_NOISE = 0.05
# the full-body rig's joints the catalog's modules attach to (fixtures.py's
# order: root, spine0-5, neck0-1, head0-1, then per side clavicle, arm0-3,
# hand0-6, hip, leg0-3, foot0-2)
CATALOG_HEAD = 10  # head1
CATALOG_AXES = (0, 6)  # root (pelvis), spine5
CATALOG_ENDS = (22, 42, 30, 50)  # l_hand6, r_hand6, l_foot2, r_foot2
CATALOG_WRISTS = (16, 36)  # l_hand0, r_hand0
CATALOG_PELVIS = 0


def catalog_recipe() -> dict:
    """Config C's fixed inputs, numpy only, so that the port and
    tools/jax_reference.py build identical ones: the three cameras (an
    OpenCV one with k1, k2, p1, p2, a fisheye one, and a pinhole one whose
    projection_matrix() the Projection module takes), ten limb and torso
    capsules along their bones, one Linear, LinearJoint, HalfPlane and
    Ellipsoid limit record each (make_limits' record tuples), the floor
    plane, the Distance module's origins and every module's weight."""
    def rz(angle):
        return [0.0, 0.0, np.sin(angle / 2), np.cos(angle / 2)]

    # (joint, its bone's direction as a rotation of local x, length, radii)
    spine, left, right, down = rz(np.pi / 2), rz(0.0), rz(np.pi), rz(-np.pi / 2)
    caps = [(2, spine, 0.25, (0.12, 0.12)), (5, spine, 0.25, (0.12, 0.12)),
            (12, left, 0.28, (0.05, 0.04)), (14, left, 0.28, (0.05, 0.04)),
            (32, right, 0.28, (0.05, 0.04)), (34, right, 0.28, (0.05, 0.04)),
            (24, down, 0.32, (0.08, 0.06)), (26, down, 0.32, (0.08, 0.06)),
            (44, down, 0.32, (0.08, 0.06)), (46, down, 0.32, (0.08, 0.06))]
    ell = np.eye(4, dtype=np.float32)
    ell[:3, :3] = np.diag([0.6, 0.3, 0.3])
    ell[:3, 3] = [0.6, 0.0, 0.0]
    big = 3.0e38
    return dict(
        cameras=[
            dict(kind="opencv", position=(0.3, 0.4, 4.5), fx=900.0, fy=900.0, cx=640.0,
                 cy=360.0, k=(-0.05, 0.01, 0.0, 0.0, 0.0, 0.0), p=(0.001, -0.0005)),
            dict(kind="fisheye", position=(3.5, 0.6, 3.0), fx=500.0, fy=500.0, cx=640.0,
                 cy=360.0, k=(0.02, -0.005, 0.001, 0.0)),
            dict(kind="pinhole", position=(-4.0, 0.3, 2.0), fx=800.0, fy=800.0, cx=640.0,
                 cy=360.0)],
        camera_target=(0.0, 0.2, 0.0), camera_up=(0.0, 1.0, 0.0), image_size=(1280, 720),
        capsule_parent=np.asarray([c[0] for c in caps], np.int32),
        capsule_transform=np.asarray([[0.0, 0.0, 0.0] + c[1] + [1.0] for c in caps],
                                     np.float32),
        capsule_radius=np.asarray([c[3] for c in caps], np.float32),
        capsule_length=np.asarray([c[2] for c in caps], np.float32),
        # l_arm1_rx = 0.5·l_arm0_rx; r_arm1 rx = 0.5·r_arm0 rx (joint space);
        # 0.6·l_leg0_rx + 0.8·l_leg1_rx ≥ −0.1; l_hand0 on an ellipsoid about spine5
        linear=[(43, 40, 0.5, 0.0, -big, big, 1.0)],
        linear_joint=[(33 * 7 + 3, 32 * 7 + 3, 0.5, 0.0, -big, big, 1.0)],
        halfplane=[(76, 79, 0.6, 0.8, -0.1, 1.0)],
        ellipsoid=[(16, 6, np.zeros(3, np.float32), ell, 1.0)],
        floor_normal=(0.0, 1.0, 0.0), floor_offset=-1.35,
        distance_origin=np.asarray([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0], [0.0, -2.0, 1.0],
                                    [0.0, -2.0, -1.0]], np.float32),
        weights=dict(camera=1e-6, projection=1e-6, state=1e-2))


def catalog_draws(batch: int, seed: int, num_params: int, noise: float = CATALOG_NOISE):
    """(truth (B, P), x0 (B, P)): uniform ±0.3 truths and a warm start of
    truth + N(0, noise), from two generators, so that the first n elements
    are the same at every batch size."""
    truth = np.random.default_rng(seed).uniform(-0.3, 0.3, (batch, num_params))
    x0 = truth + np.random.default_rng(seed + 1).normal(0.0, noise, (batch, num_params))
    return truth.astype(np.float32), x0.astype(np.float32)


class CatalogProblem(NamedTuple):
    """Config C on one device."""

    char: object  # the full-body rig with the recipe's capsules and extra limit records
    modules: tuple  # ((label, module), ...), every target taken from each element's truth
    truth: torch.Tensor  # (B, 157)
    x0: torch.Tensor  # (B, 157)


def _recipe_cameras(recipe, device):
    """The cameras of a recipe (catalog_recipe, keypoint_recipe), each
    placed by look_at."""
    from momentum_tpu_torch.camera import (
        Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)

    cams = []
    for c in recipe["cameras"]:
        args = (c["fx"], c["fy"], c["cx"], c["cy"])
        size = recipe["image_size"]
        if c["kind"] == "opencv":
            intr = OpenCVIntrinsics.create(*args, k=c["k"], p=c["p"], image_size=size,
                                           device=device)
        elif c["kind"] == "fisheye":
            intr = OpenCVFisheyeIntrinsics.create(*args, k=c["k"], image_size=size,
                                                  device=device)
        else:
            intr = PinholeIntrinsics.create(*args, image_size=size, device=device)
        cams.append(Camera.create(intr).look_at(c["position"], recipe["camera_target"],
                                                recipe["camera_up"]))
    return cams


def catalog_character(device="cuda"):
    """The full-body rig with config C's capsules and extra limit records."""
    from momentum_tpu_torch.character import CollisionGeometry, concat_limits, make_limits
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "catalog_character")
    r = catalog_recipe()
    char = create_fullbody_character(device=device)
    extra = make_limits(linear=r["linear"], linear_joint=r["linear_joint"],
                        halfplane=r["halfplane"], ellipsoid=r["ellipsoid"], device=device)
    col = CollisionGeometry(**{k: torch.as_tensor(r[f"capsule_{k}"], device=device)
                               for k in ("parent", "transform", "radius", "length")})
    return dataclasses.replace(char, limits=concat_limits(char.limits, extra), collision=col)


def build_catalog_ik_problem(batch: int = CATALOG_BATCH, seed: int = 0,
                             device="cuda") -> CatalogProblem:
    """Config C on `device` (the card unless the caller asks for the CPU):
    the full-body rig (catalog_character), `catalog_draws`' truths and warm
    starts, and every rigid module of the catalog with its targets from each
    element's truth: Position on the 80 locators; CameraProjection of them
    through the OpenCV and the fisheye camera; Projection through the
    pinhole camera's matrix; AimDir and AimDist on the head; the three
    FixedAxis modules on pelvis and spine; Normal and Distance on the hands
    and feet, in one Union; the three JointToJoint modules, wrists relative
    to the pelvis; State over all joints (matrix type, weight 1e-2); the
    limits (the rig's 151 MinMax records and the recipe's four);
    Collision over the ten capsules; PlaneCollision against the floor."""
    from momentum_tpu_torch import errors as E
    from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

    device = resolve(device, "build_catalog_ik_problem")
    r = catalog_recipe()
    w = r["weights"]
    char = catalog_character(device)
    truth_np, x0_np = catalog_draws(batch, seed, char.num_model_parameters)
    truth = torch.as_tensor(truth_np, device=device)
    states = char.skeleton_states(truth)  # (B, nJ, 8)
    cams = _recipe_cameras(r, device)
    loc = char.locators
    world = loc.world_positions(states)  # (B, 80, 3)
    parent, offset = loc.parent.cpu().numpy(), loc.offset.cpu().numpy()
    n_loc = loc.num_locators

    def at(joints):
        return states[:, list(joints)]

    def rep(ef, **tables):
        return dataclasses.replace(ef, **tables)

    z3 = np.zeros((1, 3), np.float32)
    mods = [("position", rep(E.PositionErrorFunction.create(
        parent, offset, np.zeros((n_loc, 3)), device=device), target=world))]
    for label, cam in (("camera_opencv", cams[0]), ("camera_fisheye", cams[1])):
        mods.append((label, rep(E.CameraProjectionErrorFunction.create(
            cam, parent, offset, np.zeros((n_loc, 2)), weight=w["camera"], device=device),
            target=cam.project(world)[0][..., :2])))
    proj = cams[2].projection_matrix()
    q = torch.einsum("ij,...j->...i", proj[:, :3], world) + proj[:, 3]
    mods.append(("projection", rep(E.ProjectionErrorFunction.create(
        parent, offset, np.broadcast_to(proj.cpu().numpy(), (n_loc, 3, 4)),
        np.zeros((n_loc, 2)), weight=w["projection"], device=device),
        target=q[..., :2] / q[..., 2:3])))

    head = at([CATALOG_HEAD])
    fwd = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    aim = ss.transform_points(head, torch.as_tensor(z3, device=device)) + 0.5 * \
        ss.rotate_vectors(head, torch.as_tensor(fwd, device=device))
    for label, cls in (("aim_dir", E.AimDirErrorFunction), ("aim_dist", E.AimDistErrorFunction)):
        mods.append((label, rep(cls.create([CATALOG_HEAD], z3, fwd, z3, device=device),
                                target=aim)))
    up = np.asarray([[0.0, 1.0, 0.0]] * 2, np.float32)
    axes = ss.rotate_vectors(at(CATALOG_AXES), torch.as_tensor(up, device=device))
    for label, cls in (("fixed_axis_diff", E.FixedAxisDiffErrorFunction),
                       ("fixed_axis_cos", E.FixedAxisCosErrorFunction),
                       ("fixed_axis_angle", E.FixedAxisAngleErrorFunction)):
        mods.append((label, rep(cls.create(list(CATALOG_AXES), up, up, device=device),
                                global_axis=axes)))

    n_end = len(CATALOG_ENDS)
    ends = at(CATALOG_ENDS)
    z_end = np.zeros((n_end, 3), np.float32)
    normal = E.NormalErrorFunction.create(list(CATALOG_ENDS), z_end,
                                          np.tile([[0.0, 1.0, 0.0]], (n_end, 1)), z_end,
                                          device=device)
    origin = torch.as_tensor(r["distance_origin"], device=device)
    distance = E.DistanceErrorFunction.create(list(CATALOG_ENDS), z_end, r["distance_origin"],
                                              np.zeros(n_end), device=device)
    mods.append(("union_normal_distance", E.UnionErrorFunction(children=(
        rep(normal, global_point=ends[..., :3]),
        rep(distance, target=torch.linalg.vector_norm(ends[..., :3] - origin, dim=-1))))))

    src, ref = at(CATALOG_WRISTS), at([CATALOG_PELVIS] * len(CATALOG_WRISTS))
    diff = src[..., :3] - ref[..., :3]
    q_ref_inv = quat.conjugate(ref[..., 3:7])
    n_w = len(CATALOG_WRISTS)
    z_w = np.zeros((n_w, 3), np.float32)
    pair = (list(CATALOG_WRISTS), [CATALOG_PELVIS] * n_w)
    mods += [
        ("j2j_position", rep(E.JointToJointPositionErrorFunction.create(
            *pair, z_w, z_w, z_w, device=device), target=quat.rotate_vector(q_ref_inv, diff))),
        ("j2j_distance", rep(E.JointToJointDistanceErrorFunction.create(
            *pair, z_w, z_w, np.zeros(n_w), device=device),
            target=torch.linalg.vector_norm(diff, dim=-1))),
        ("j2j_orientation", rep(E.JointToJointOrientationErrorFunction.create(
            *pair, np.tile([[0.0, 0.0, 0.0, 1.0]], (n_w, 1)), device=device),
            target=quat.multiply(q_ref_inv, src[..., 3:7]))),
        ("state", rep(E.StateErrorFunction.create(states[0].cpu().numpy(), weight=w["state"],
                                                  device=device), target_state=states)),
        ("limits", E.LimitErrorFunction.create(device=device)),
        ("collision", E.CollisionErrorFunction.create(char, device=device)),
        ("plane_collision", E.PlaneCollisionErrorFunction.create(
            char, r["floor_normal"], r["floor_offset"], device=device)),
    ]
    return CatalogProblem(char=char, modules=tuple(mods), truth=truth,
                          x0=torch.as_tensor(x0_np, device=device))


def solve_catalog(problem: CatalogProblem, x0=None, iterations: int = CATALOG_ITERATIONS):
    """Config C's solve: solve_ik's LM (regularization 1e-5), `iterations`
    iterations over every module, from x0 (the problem's warm starts by
    default) → SolveResult."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    fn = SkeletonSolverFunction(problem.char, tuple(ef for _, ef in problem.modules))
    return solve_ik(fn, problem.x0 if x0 is None else x0,
                    options=SolverOptions(max_iterations=iterations, regularization=1e-5),
                    method="levenberg_marquardt")


def catalog_energies(problem: CatalogProblem, params: torch.Tensor) -> dict:
    """Each module's energy (B,) at `params` (B, P), by label, and "total"."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    fn = SkeletonSolverFunction(problem.char, tuple(ef for _, ef in problem.modules))
    ctx = fn.context(params)
    out = {label: ef.error(problem.char, ctx) for label, ef in problem.modules}
    out["total"] = sum(out.values())
    return out


def catalog_figures(problem: CatalogProblem, params: torch.Tensor, params_more: torch.Tensor,
                    rows=slice(None)) -> dict:
    """Config C's figures over the elements `rows`: every module's median
    energy at `params`, conv_at_1e5 (the fraction whose total energy at
    `params` is within 1e-5 of its energy at `params_more`, the solve
    continued CATALOG_MORE iterations) and the divergent count (not finite)."""
    final = {k: v[rows].detach().cpu().numpy().astype(np.float64)
             for k, v in catalog_energies(problem, params).items()}
    longer = catalog_energies(problem, params_more)["total"][rows].cpu().numpy()
    total = final["total"]
    finite = np.isfinite(total)
    return dict(median_energy={k: float(np.median(v)) for k, v in final.items()},
                conv_at_1e5=float(np.mean(finite & (total - longer <= 1e-5))),
                divergent=int(np.sum(~finite)), batch=int(total.shape[0]))


# ---- config 6k: config 6s's clip with 2D keypoints from four cameras ----

# markers carry N(0, 2 mm) per axis (12 mm² a marker), keypoints N(0, 1 px)
# per axis (2 px² a camera, 8 px² over four): 1.5 px⁻²·mm² puts the two on
# a par at the noise
KEYPOINT_PROJECTION_WEIGHT = 1.5
KEYPOINT_NOISE_PX = 1.0
KEYPOINT_UNOBSERVED = 0.05


def keypoint_recipe() -> dict:
    """Config 6k's cameras, numpy only (tools/jax_reference.py has the same
    numbers): four cameras about 4 m from the walk's middle (the clip is
    mm, z-up), looking at it, 1280 × 720: one pinhole, two OpenCV, one
    fisheye."""
    return dict(
        cameras=[
            dict(kind="pinhole", position=(1000.0, -4000.0, 1500.0), fx=1000.0, fy=1000.0,
                 cx=640.0, cy=360.0),
            dict(kind="opencv", position=(1000.0, 4000.0, 1200.0), fx=1100.0, fy=1100.0,
                 cx=630.0, cy=350.0, k=(-0.08, 0.02, 0.0, 0.0, 0.0, 0.0), p=(0.0005, -0.0003)),
            dict(kind="opencv", position=(-3000.0, -500.0, 1300.0), fx=950.0, fy=950.0,
                 cx=645.0, cy=365.0, k=(-0.03, 0.005, 0.0, 0.0, 0.0, 0.0), p=(-0.0002, 0.0004)),
            dict(kind="fisheye", position=(5000.0, 800.0, 1400.0), fx=600.0, fy=600.0,
                 cx=640.0, cy=360.0, k=(0.03, -0.004, 0.0005, 0.0))],
        camera_target=(1000.0, 0.0, 900.0), camera_up=(0.0, 0.0, 1.0), image_size=(1280, 720))


def keypoint_draws(frames: int, seed: int, num_cameras: int, num_locators: int):
    """(pixel noise (C, F, L, 2), unobserved (C, F, L) bool) from their own
    generator (seed + 2), so config 6s's draws stay as they are."""
    rng = np.random.default_rng(seed + 2)
    noise = rng.normal(0.0, KEYPOINT_NOISE_PX, (num_cameras, frames, num_locators, 2))
    return noise.astype(np.float32), rng.random((num_cameras, frames, num_locators)) \
        < KEYPOINT_UNOBSERVED


def build_keypoint_clip(clip: TrackingClip, seed: int = 0) -> tuple:
    """Config 6k's keypoints on clip's device: per camera of keypoint_recipe
    a CameraKeypointData whose targets are the truth locators' projections
    plus `keypoint_draws`' noise, with confidence 1 where the keypoint is
    observed (the 5% draw) and its truth projects into the image in front
    of the camera, 0 elsewhere."""
    r = keypoint_recipe()
    device = clip.truth.device
    cams = _recipe_cameras(r, device)
    world = clip.char.locators.world_positions(clip.char.skeleton_states(clip.truth))
    noise, unobserved = keypoint_draws(clip.truth.shape[0], seed, len(cams), world.shape[1])
    from momentum_tpu_torch.tracking import CameraKeypointData

    out = []
    w, h = r["image_size"]
    for c, cam in enumerate(cams):
        uvz, valid = cam.project(world)
        u, v = uvz[..., 0], uvz[..., 1]
        seen = (valid & (uvz[..., 2] >= 0.01) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
                & ~torch.as_tensor(unobserved[c], device=device))
        out.append(CameraKeypointData(
            camera=cam, targets=uvz[..., :2] + torch.as_tensor(noise[c], device=device),
            confidence=seen.float()))
    return tuple(out)


def _keypoint_configs():
    """Config 6k's settings: config 6's tracking and refine (LM 15; LM 10
    with smoothing 1e-4) with the keypoints' projection weight."""
    import dataclasses as dc

    _, track, refine = _tracking_configs()
    return (dc.replace(track, projection_weight=KEYPOINT_PROJECTION_WEIGHT),
            dc.replace(refine, projection_weight=KEYPOINT_PROJECTION_WEIGHT))


def track_clip_keypoints(char, markers, keypoints, identity: torch.Tensor):
    """Config 6k's first stage: every frame at once from `identity`,
    markers and keypoints (track_poses_batched, LM 15) → TrackingResult."""
    from momentum_tpu_torch.tracking import track_poses_batched

    return track_poses_batched(char, markers, _keypoint_configs()[0], initial=identity,
                               camera_keypoints=keypoints)


def refine_clip_keypoints(char, markers, keypoints, motion: torch.Tensor):
    """Config 6k's second stage: the smoothed whole-clip refine of `motion`
    with the keypoints → TrackingResult."""
    from momentum_tpu_torch.tracking import refine_motion

    return refine_motion(char, markers, motion, _keypoint_configs()[1],
                         camera_keypoints=keypoints)[0]


def clip_reprojection_errors_px(char, keypoints, motion: torch.Tensor) -> np.ndarray:
    """The distances (px) between the observed keypoints and the projections
    of `motion`'s locators, over every camera, flattened."""
    world = char.locators.world_positions(char.skeleton_states(motion))
    out = []
    for kp in keypoints:
        uv = kp.camera.project(world)[0][..., :2]
        d = torch.linalg.vector_norm(uv - kp.targets, dim=-1)
        out.append(d[kp.confidence > 0].cpu().numpy())
    return np.concatenate(out)
