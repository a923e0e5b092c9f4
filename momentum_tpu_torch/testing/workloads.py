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

Differentiable IK (config D): the IK rig and catalog_draws' truths and
warm starts, a ModelParameters prior toward zero at weight 1e-3 (keeping H
full-rank, as tests/test_diff_ik.py), scale_global disabled, GN 20 at
regularization 1e-6 through torch_interop.solve_ik_torch, and the loss
L = Σ w·θ* with w ~ N(0, 1); its gradients to the targets and the
per-constraint weights come by the implicit function theorem. The same
problem without the prior runs through each solver variant
(`variant_recipe`: QR, trust-region QR, CG, line search, gradient descent,
histories). Config 4x is config 4b with three forward-mode vertex modules
added (`vertex_extra_recipe`); config 4ad is config 4b solved with the
forward-mode Jacobian (`force_ad`), bench_suite.py's A/B.

Config SL, skinned-locator IK: the IK rig with its 80 locators turned into
skinned locators, catalog_draws' truths and warm starts, SkinnedLocator
targets from each element's truth and 16 sliding SkinnedLocatorTriangle
constraints (`skinned_triangle_recipe`), LM 10. Config G, glove-fused
tracking: the full-body rig with a glove bone under each wrist (53 joints,
169 parameters), a 343-frame clip of its 80 markers and two 7-finger glove
streams (`glove_clip_draws`), solved by track_sequence and, on its first
32 frames, by per-frame tracking.

The render clip: the full-body character's skinned tube mesh (612 vertices,
612 faces) posed by a 32-frame random walk in its 157 parameters, rendered
with Lambert shading and a 256 × 256 shadow map at 1280 × 960 and box-
filtered to 640 × 480 — the reference rasterizer's one published
performance figure (~45 fps on an 8-core CPU). Config 7p, the pymomentum
renderer's scene on that clip at 640 × 480: the offline viewer
(gui.viewer.render_motion with the ground and the skeleton overlay) and a
Phong scene per frame (render_mesh_phong at 2× supersampling, the ground,
the skeleton's cylinders, a sphere, the locators as dots and a label).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["build_fullbody_ik_problem", "point_jacobian_inputs", "make_solve_stage",
           "make_solve_batch",
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
           "make_render_clip", "clip_vertices", "render_clip_passes", "SCENE_WIDTH",
           "SCENE_HEIGHT", "SCENE_SUPERSAMPLE", "SCENE_BONE_RADIUS", "build_scene_clip",
           "scene_poses", "scene_ground", "scene_frame", "make_scene_render", "scene_passes",
           "CATALOG_BATCH", "CATALOG_MORE", "CatalogProblem", "catalog_recipe", "catalog_draws",
           "catalog_character", "build_catalog_ik_problem", "solve_catalog",
           "catalog_energies", "catalog_figures", "KEYPOINT_PROJECTION_WEIGHT",
           "keypoint_recipe", "keypoint_draws", "build_keypoint_clip", "track_clip_keypoints",
           "refine_clip_keypoints", "clip_reprojection_errors_px", "DIFF_IK_BATCH",
           "DiffIkProblem", "build_diff_ik_problem", "diff_ik_options", "diff_ik_solver_fn",
           "solve_diff_ik", "variant_recipe", "solve_variant", "VertexExtraProblem",
           "vertex_extra_recipe", "build_vertex_extra_problem", "vertex_extra_modules",
           "make_vertex_extra_solve", "make_vertex_fit_ad_solve", "SKINNED_BATCH",
           "skinned_triangle_recipe", "build_skinned_ik_problem", "skinned_marker_sequence",
           "GLOVE_FRAMES", "GLOVE_PER_FRAME_FRAMES", "GloveClip", "glove_clip_draws",
           "quaternion_noise", "glove_character", "glove_relative", "build_glove_clip",
           "track_glove_sequence", "glove_clip_head", "track_glove_per_frame", "rotation_angle_deg",
           "glove_figures"]

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


def point_jacobian_inputs(char, batch: int, seed: int = 0, loss=None):
    """The position rows' Jacobian context on `char`'s locators at `batch`
    poses drawn uniform in ±0.3 from `seed`, their targets the locators at
    other such poses, on the character's device: (jc, world points (B, C,
    3), parents (C,), pt_mat, row scale (C,) under the default L2 loss, or
    (B, C) under `loss`, a GeneralizedLoss), the arguments of K6
    (ops/jacobian.py) and of its plain version."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context

    device = char.parameter_transform.transform.device
    rng = np.random.default_rng(seed)
    x, truth = (torch.as_tensor(rng.uniform(-0.3, 0.3, (batch, char.num_model_parameters))
                                .astype(np.float32), device=device) for _ in range(2))
    ef = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), loss=loss, device=device)
    ef = dataclasses.replace(ef, target=char.locators.world_positions(char.skeleton_states(truth)))
    ctx = SkeletonSolverFunction(char, (ef,)).context(x)
    parents = ef._parents(ctx)
    world = ef._world(ctx, parents)
    f = world - ef.target
    scale = ef._row_scale(ef.cweight, torch.sum(f * f, dim=-1))
    return (make_jacobian_context(char, ctx), world, parents,
            char.parameter_transform.transform, scale)


def projection_jacobian_inputs(char, batch: int, cameras: int, seed: int = 0):
    """The arguments of K6's projection form (ops/jacobian.py::
    projection_jacobian_model) on `char`'s locators at `batch` poses drawn
    uniform in ±0.3 from `seed`: (jc, world points (B, C, 3), parents (C,),
    pt_mat, rotations (K, 3, 3), translations (K, 3), OpenCV intrinsics
    (K, 12), row scales (B, K, C)). The K cameras stand on a ring three
    spreads of the points from their centroid, looking at it, with random
    focal lengths, principal points and all eight distortion coefficients;
    the scales are U(0.5, 1.5), a tenth of them zero (no weight, or behind
    the near clip)."""
    from momentum_tpu_torch.camera.models import (
        Camera, OpenCVIntrinsics, stack_opencv_parameters)
    from momentum_tpu_torch.math import skel_state as ss

    jc, world, parents, pt_mat, _ = point_jacobian_inputs(char, batch, seed)
    device = world.device
    rng = np.random.default_rng(seed + 1)
    centre = world.reshape(-1, 3).mean(0).cpu().numpy().astype(np.float64)
    spread = float(world.reshape(-1, 3).std(0).norm())
    cams = []
    for k in range(cameras):
        az = 2 * np.pi * k / cameras + rng.uniform(-0.2, 0.2)
        pos = centre + 3 * spread * np.array([np.cos(az), np.sin(az), rng.uniform(-0.3, 0.3)])
        intr = OpenCVIntrinsics.create(
            *rng.uniform(900, 1500, 2), *rng.uniform(500, 900, 2),
            k=rng.uniform(-0.05, 0.05, 6) + np.array([-0.2, 0.1, 0.0, 0.0, 0.0, 0.0]),
            p=rng.uniform(-1e-3, 1e-3, 2), device=device)
        cams.append(Camera.create(intr).look_at(pos, centre, (0.0, 0.0, 1.0)))
    eye = torch.stack([c.eye_from_world for c in cams])
    rot = ss.to_matrix(eye)[..., :3, :3]
    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    scale = 0.5 + torch.rand(batch, cameras, parents.shape[0], generator=g)
    scale = torch.where(torch.rand(scale.shape, generator=g) < 0.1, 0.0, scale)
    return (jc, world, parents, pt_mat, rot, eye[:, :3].contiguous(),
            stack_opencv_parameters([c.intrinsics for c in cams]), scale.to(device))


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


# ---- config 7p: the pymomentum renderer's scene on config 7's clip ----

SCENE_WIDTH, SCENE_HEIGHT = 640, 480
SCENE_SUPERSAMPLE = 2
# world sizes (m): rasterize_skeleton's default bone radius, 3.4 to 5.3 px
# wide at the 640 × 480 camera (the joints lie 6.7 to 10.4 m from it; the
# smoke prints the widths), locator dots 2 to 3 px across
SCENE_BONE_RADIUS = 0.02
SCENE_LOCATOR_RADIUS = 0.012
SCENE_SPHERE_RADIUS = 0.05
SCENE_SPHERE_LEVEL = 1  # 80 faces: one K4a pass
SCENE_DOT_COLOR = (0.1, 0.9, 0.2)


def build_scene_clip(frames: int = 32, seed: int = 0, device="cuda"):
    """(char, motion, camera) of config 7p: config 7's character and clip
    (`build_render_clip`) with the camera framed for 640 × 480."""
    return build_render_clip(frames, seed, device, image_height=SCENE_HEIGHT,
                             image_width=SCENE_WIDTH)


def scene_poses(char, motion):
    """character_state of every frame in one batch (FK by K1 on the card):
    (skeleton states (F, nJ, 8), mesh vertices (F, V, 3), locators (F, L, 3))."""
    from momentum_tpu_torch.character.character_state import character_state

    st = character_state(char.with_inverse_bind_pose(), motion, update_collision=False)
    return st.skeleton_state, st.mesh_vertices, st.locator_positions


def scene_ground(cam, vertices0):
    """(z, rgb) of render_motion's ground: the 10 × 10 checkerboard spanning
    three times frame 0's horizontal extent, through the dense rasterizer."""
    from momentum_tpu_torch.rasterizer import rasterize_checkerboard

    extent = float(vertices0[:, [0, 2]].abs().max()) * 3.0 + 1.0
    return rasterize_checkerboard(cam, SCENE_WIDTH, SCENE_HEIGHT, half_extent=extent,
                                  squares=10)


def scene_frame(char, cam, states, verts, locators, ground, label: str) -> dict:
    """One frame of config 7p's Phong scene, each layer z-tested over the
    last: render_mesh_phong (default lights, back-face culling, 2×
    supersampled: a K4b pass at 1280 × 960 on the card) over the ground,
    the skeleton's cylinders (render_mesh, K4b), a sphere at the root (80
    faces, K4a), the locators as filled circles (dense), then `label` as
    billboard text at the root (host). Returns dict(image (H, W, 3) host
    numpy, phong = render_mesh_phong's buffers)."""
    from momentum_tpu_torch.rasterizer import (
        rasterize_circles, rasterize_skeleton, rasterize_spheres, rasterize_text,
        render_mesh_phong)
    from momentum_tpu_torch.rasterizer.utils import _z_test

    w, h = SCENE_WIDTH, SCENE_HEIGHT
    phong = render_mesh_phong(cam, verts, char.mesh.faces, w, h, supersample=SCENE_SUPERSAMPLE)
    z, rgb = _z_test(phong["depth"], phong["color"], *ground, w, h)
    for layer in (rasterize_skeleton(cam, char.skeleton, states, w, h,
                                     bone_radius=SCENE_BONE_RADIUS),
                  rasterize_spheres(cam, states[0, :3].cpu().numpy(), SCENE_SPHERE_RADIUS, w,
                                    h, subdivision_level=SCENE_SPHERE_LEVEL)):
        z, rgb = _z_test(layer["depth"], layer["color"], z, rgb, w, h)
    z, rgb = rasterize_circles(cam, locators, w, h, radius=SCENE_LOCATOR_RADIUS,
                               fill_color=SCENE_DOT_COLOR, z_buffer=z, rgb_buffer=rgb)
    image = rasterize_text(rgb, cam, label, states[0, :3].cpu().numpy(), scale=2)
    return dict(image=image, phong=phong)


def make_scene_render(char, cam):
    """`render_scene(motion) -> (frames, 480, 640, 3)` host images of
    config 7p's Phong scene: `scene_poses`, `scene_ground` once, then
    `scene_frame` per frame, labelled "FRAME i"."""

    def render_scene(motion):
        states, verts, locators = scene_poses(char, motion)
        ground = scene_ground(cam, verts[0])
        return np.stack([scene_frame(char, cam, states[i], verts[i], locators[i], ground,
                                     f"FRAME {i}")["image"]
                         for i in range(motion.shape[0])])

    return render_scene


def scene_passes(char, cam, motion, frame: int = 0) -> dict:
    """The planes passes of frame `frame` of config 7p's Phong scene, each
    (verts_screen, faces, width, height, rasterize_planes keyword
    arguments): "phong" (the culled mesh at the supersampled size), "skeleton"
    (the bones' cylinders, their flat Lambert colours) and "sphere"."""
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.rasterizer.materials import _phong_screen
    from momentum_tpu_torch.rasterizer.primitives import _bones, _cylinders_mesh, _spheres_mesh

    states, verts, _ = scene_poses(char, motion[frame:frame + 1])
    states, verts = states[0], verts[0]
    dev, w, h, k = verts.device, SCENE_WIDTH, SCENE_HEIGHT, SCENE_SUPERSAMPLE
    screen, faces = _phong_screen(cam, verts, char.mesh.faces, k)
    out = dict(phong=(screen, faces, w * k, h * k, {}))
    for name, (v, f) in (("skeleton", _cylinders_mesh(*_bones(char.skeleton, states),
                                                      SCENE_BONE_RADIUS)),
                         ("sphere", _spheres_mesh(states[0, :3].cpu().numpy(),
                                                  SCENE_SPHERE_RADIUS, SCENE_SPHERE_LEVEL))):
        v, f = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        out[name] = (render.screen_vertices(cam, v), f, w, h,
                     dict(face_attrs=render.flat_face_colors(v, f, render.LIGHT_DIR)))
    return out


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


# ---- config D: differentiable IK, and the solver variants on its problem ----

DIFF_IK_BATCH = 2048


class DiffIkProblem(NamedTuple):
    """Config D on one device."""

    char: object  # the full-body rig (157 parameters, 80 locators)
    ef0: object  # PositionErrorFunction on the 80 locators, zero targets
    prior: object  # ModelParametersErrorFunction toward zero, weight 1e-3
    targets: torch.Tensor  # (B, 80, 3) the truths' locator positions
    cweight: torch.Tensor  # (B, 80) ones: per-element constraint weights
    x0: torch.Tensor  # (B, 157) truth + N(0, 0.05)
    mask: torch.Tensor  # (157,) 0 at scale_global
    w: torch.Tensor  # (B, 157) the loss weights, N(0, 1)


def build_diff_ik_problem(batch: int = DIFF_IK_BATCH, seed: int = 0,
                          device="cuda") -> DiffIkProblem:
    """Config D on `device` (the card unless the caller asks for the CPU):
    catalog_draws' truths and warm starts (two generators) and the loss
    weights from a third (seed + 2), so the first n elements are the same at
    every batch size."""
    from momentum_tpu_torch.errors import ModelParametersErrorFunction, PositionErrorFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_diff_ik_problem")
    char = create_fullbody_character(device=device)
    p = char.num_model_parameters
    truth, x0 = catalog_draws(batch, seed, p)
    targets = char.locators.world_positions(
        char.skeleton_states(torch.as_tensor(truth, device=device)))
    loc = char.locators
    ef0 = PositionErrorFunction.create(loc.parent.cpu().numpy(), loc.offset.cpu().numpy(),
                                       np.zeros((loc.num_locators, 3)), device=device)
    prior = ModelParametersErrorFunction.create(np.zeros(p), weight=1e-3, device=device)
    mask = np.ones(p, np.float32)
    mask[char.parameter_transform.names.index("scale_global")] = 0.0
    w = np.random.default_rng(seed + 2).normal(0.0, 1.0, (batch, p)).astype(np.float32)
    return DiffIkProblem(
        char=char, ef0=ef0, prior=prior, targets=targets,
        cweight=torch.ones(batch, loc.num_locators, device=device),
        x0=torch.as_tensor(x0, device=device), mask=torch.as_tensor(mask, device=device),
        w=torch.as_tensor(w, device=device))


def diff_ik_options():
    """Config D's solve: GN 20 at regularization 1e-6."""
    from momentum_tpu_torch.solver import SolverOptions

    return SolverOptions(max_iterations=20, regularization=1e-6)


def diff_ik_solver_fn(problem: DiffIkProblem, inputs: dict):
    """The build function of solve_ik_torch: config D's modules with the
    inputs' targets (B, 80, 3) and per-constraint weights (B, 80)."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    ef = dataclasses.replace(problem.ef0, target=inputs["targets"], cweight=inputs["cweight"])
    return SkeletonSolverFunction(problem.char, (ef, problem.prior))


def solve_diff_ik(problem: DiffIkProblem, targets, cweight, x0) -> torch.Tensor:
    """θ* (B, 157) through torch_interop.solve_ik_torch, differentiable in
    targets, cweight and (at scale_global) x0."""
    from momentum_tpu_torch.torch_interop import solve_ik_torch

    return solve_ik_torch(lambda inputs: diff_ik_solver_fn(problem, inputs), x0,
                          {"targets": targets, "cweight": cweight}, diff_ik_options(),
                          enabled_mask=problem.mask)


def variant_recipe() -> dict:
    """name → (solver class of solver/solvers.py, SolverOptions fields,
    constructor keywords): the solver variants run on config D's problem
    without the prior (tools/jax_reference.py has the same numbers)."""
    gn = dict(max_iterations=5, regularization=1e-3)
    return {
        "gn_qr": ("GaussNewtonSolverQR", gn, {}),
        "trust_region_qr": ("TrustRegionQR", gn, {}),
        "sparse_gn_cg": ("SparseGaussNewtonSolver", dict(gn, cg_iterations=64), {}),
        "gn_line_search": ("GaussNewtonSolver", dict(gn, do_line_search=True), {}),
        "gradient_descent": ("GradientDescentSolver", dict(max_iterations=20),
                             dict(learning_rate=0.01)),
        "gn_history": ("GaussNewtonSolver", dict(gn, store_history=True), {}),
    }


def solve_variant(problem: DiffIkProblem, name: str):
    """The solver of variant `name` on config D's position module alone
    (targets from the truths), from x0; → (the solver, its SolveResult)."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solvers

    cls, opts, kw = variant_recipe()[name]
    fn = SkeletonSolverFunction(problem.char,
                                (dataclasses.replace(problem.ef0, target=problem.targets),))
    solver = getattr(solvers, cls)(fn, SolverOptions(**opts), **kw)
    solver.solve(problem.x0)
    return solver, solver.last_result


# ---- config 4x: config 4b with the three forward-mode vertex modules ----


class VertexExtraProblem(NamedTuple):
    """Config 4x on one device."""

    fit: VertexFitProblem  # config 4b at B = 256
    point_triangle: object  # PointTriangleVertexErrorFunction (no per-element field)
    distance: object  # VertexVertexDistanceErrorFunction, targets (B, C) from the truths
    camera: object  # CameraVertexProjectionErrorFunction, targets (B, C, 2) from the truths


def vertex_extra_recipe(num_vertices: int, faces: np.ndarray) -> dict:
    """Config 4x's constraint tables on a mesh of `num_vertices` with
    `faces` (F, 3): 16 triangles, each pulling a vertex of a nearby face
    (not its own) to its centroid; vertex pairs across the body; every 8th
    vertex seen by catalog_recipe's OpenCV camera."""
    tri = faces[::38][:16]
    src = faces[3::38][:16, 2]
    v1 = np.arange(0, num_vertices // 2, 17)
    return dict(src_vertex=src, tri_vertices=tri, bary=np.full((len(tri), 3), 1.0 / 3.0),
                vertex1=v1, vertex2=(v1 + num_vertices // 2) % num_vertices,
                camera_vertex=np.arange(0, num_vertices, 8),
                weights=dict(point_triangle=0.1, distance=1.0, camera=1e-6))


def build_vertex_extra_problem(batch: int = VERTEX_FIT_BATCH, seed: int = 1,
                               device="cuda") -> VertexExtraProblem:
    """Config 4x on `device` (the card unless the caller asks for the CPU):
    config 4b's problem and the recipe's three modules, the distances and
    pixel targets taken from each element's truth."""
    from momentum_tpu_torch import errors as E
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    device = resolve(device, "build_vertex_extra_problem")
    fit = build_vertex_fit_problem(batch, seed, device)
    mesh = fit.char.mesh
    r = vertex_extra_recipe(mesh.num_vertices, mesh.faces.cpu().numpy())
    w = r["weights"]
    verts = SkeletonSolverFunction(fit.char, (fit.ef0,)).context(fit.gt).mesh_vertices
    cam = _recipe_cameras(catalog_recipe(), device)[0]
    v1, v2 = (torch.as_tensor(r[k], device=device) for k in ("vertex1", "vertex2"))
    dist = torch.linalg.vector_norm(verts[:, v1] - verts[:, v2] + 1e-20, dim=-1)
    seen = verts[:, torch.as_tensor(r["camera_vertex"], device=device)]
    n_cam = len(r["camera_vertex"])
    return VertexExtraProblem(
        fit=fit,
        point_triangle=E.PointTriangleVertexErrorFunction.create(
            r["src_vertex"], r["tri_vertices"], r["bary"], weight=w["point_triangle"],
            device=device),
        distance=dataclasses.replace(E.VertexVertexDistanceErrorFunction.create(
            r["vertex1"], r["vertex2"], np.zeros(len(r["vertex1"])), weight=w["distance"],
            device=device), target=dist),
        camera=dataclasses.replace(E.CameraVertexProjectionErrorFunction.create(
            cam, r["camera_vertex"], np.zeros((n_cam, 2)), weight=w["camera"],
            device=device), target=cam.project(seen)[0][..., :2]))


def vertex_extra_modules(problem: VertexExtraProblem, targets, distance, pixels) -> tuple:
    """Config 4x's modules: 4b's vertex positions, then the three new ones,
    with per-element targets (B, ...)."""
    return (dataclasses.replace(problem.fit.ef0, target=targets), problem.point_triangle,
            dataclasses.replace(problem.distance, target=distance),
            dataclasses.replace(problem.camera, target=pixels))


def make_vertex_extra_solve(problem: VertexExtraProblem):
    """Config 4x's solve `x0 -> SolveResult`: config 4b's (solve_ik's GN at
    regularization 1e-5 on Σ rows², 4 full-batch iterations and 2 on the
    worst quarter), the Jacobian by forward mode since three modules have
    no analytic one (solve_ik's routing, as JAX's)."""
    from momentum_tpu_torch.solver import (
        SkeletonSolverFunction, SolverOptions, solve_compacted, solve_ik)

    k_full, r_refine, cap = VERTEX_FIT_REFINE
    batch = problem.fit.x0.shape[0]
    cap = min(batch, max(1, cap * batch // VERTEX_FIT_BATCH))
    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)
    inputs = (problem.fit.targets, problem.distance.target, problem.camera.target)

    def stage(tables, x0, iters, _lam0):
        fn = SkeletonSolverFunction(problem.fit.char, vertex_extra_modules(problem, *tables))
        return solve_ik(fn, x0, options=dataclasses.replace(opts, max_iterations=iters),
                        method="gauss_newton")

    def solve(x0):
        return solve_compacted(stage, inputs, x0, capacity=cap, k_full=k_full,
                               r_refine=r_refine)

    return solve


# ---- config 4ad: config 4b's forward-mode A/B (bench_suite.py:370-375) ----


def make_vertex_fit_ad_solve(char, ef0):
    """Config 4b's A/B solve `(targets, x0) -> SolveResult`: solve_ik's GN 6
    on the whole batch (regularization 1e-5, Σ rows² as the energy) with
    SkeletonSolverFunction(..., force_ad=True), so the vertex rows'
    Jacobian comes by forward mode through the skinning (K1's jvp rule)
    instead of the analytic LBS walk, as bench_suite.py's
    `shape_pose_vertex_fit_batched_ad`."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    opts = SolverOptions(max_iterations=sum(VERTEX_FIT_REFINE[:2]), regularization=1e-5,
                         energy_from_residual=True)

    def solve(targets, x0):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),),
                                    force_ad=True)
        return solve_ik(fn, x0, options=opts, method="gauss_newton")

    return solve


# ---- config SL: skinned-locator IK ----

SKINNED_BATCH = 2048
SKINNED_TRIANGLE_ROWS = tuple(range(0, 80, 5))  # 16 of the 80 locators
SKINNED_CANDIDATES = 4  # sliding: the snapped triangle's nearest centroids
SKINNED_TRIANGLE_WEIGHT = 0.1


def skinned_triangle_recipe(vertices: np.ndarray, faces: np.ndarray, hits) -> dict:
    """Config SL's triangle constraints from `hits`, one (triangle,
    barycentric, point, distance) per row of SKINNED_TRIANGLE_ROWS as
    closest_point_on_mesh_matching_parent gives them on the rest mesh
    `vertices` (V, 3), `faces` (F, 3): the snapped triangle, its
    barycentric, depth 0, and the SKINNED_CANDIDATES triangles whose rest
    centroids are nearest the snapped point (a stable sort) as the sliding
    candidates."""
    centroids = vertices.astype(np.float64)[faces].mean(axis=1)
    tri = np.asarray([h[0] for h in hits])
    points = np.stack([h[2] for h in hits]).astype(np.float64)
    d2 = ((centroids[None] - points[:, None]) ** 2).sum(-1)
    return dict(tri_indices=faces[tri], bary=np.stack([h[1] for h in hits]),
                candidates=np.argsort(d2, axis=1, kind="stable")[:, :SKINNED_CANDIDATES],
                weight=SKINNED_TRIANGLE_WEIGHT)


def build_skinned_ik_problem(batch: int = SKINNED_BATCH, seed: int = 0,
                             device="cuda") -> CatalogProblem:
    """Config SL on `device` (the card unless the caller asks for the CPU),
    as a CatalogProblem: the full-body rig with its 80 locators turned into
    skinned locators (locators_to_skinned_locators), `catalog_draws`'
    truths and warm starts, and three modules: SkinnedLocator on all 80,
    their targets each element's truth positions; SkinnedLocatorTriangle on
    the 16 of SKINNED_TRIANGLE_ROWS, sliding over skinned_triangle_recipe's
    candidates at weight 0.1 (not satisfiable at the truth); the limits."""
    from momentum_tpu_torch import errors as E
    from momentum_tpu_torch.math import skel_state as ss
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character
    from momentum_tpu_torch.tracking import (
        closest_point_on_mesh_matching_parent, locators_to_skinned_locators)

    device = resolve(device, "build_skinned_ik_problem")
    base = create_fullbody_character(device=device)
    loc = base.locators
    rows = list(SKINNED_TRIANGLE_ROWS)
    world = ss.transform_points(base.bind_pose().index_select(0, loc.parent.long()),
                                loc.offset).cpu().numpy()
    parents = loc.parent.cpu().numpy()
    hits = [closest_point_on_mesh_matching_parent(base, world[i], int(parents[i]))
            for i in rows]
    char = locators_to_skinned_locators(base)
    sl = char.skinned_locators
    if sl.num_locators != loc.num_locators:
        raise AssertionError("a locator of the full-body rig found no triangle")
    r = skinned_triangle_recipe(base.mesh.vertices.cpu().numpy(), base.mesh.faces.cpu().numpy(),
                                hits)
    truth_np, x0_np = catalog_draws(batch, seed, char.num_model_parameters)
    truth = torch.as_tensor(truth_np, device=device)
    sl_np = [t.cpu().numpy() for t in (sl.parents, sl.skin_weights, sl.rest_position)]
    position = dataclasses.replace(
        E.SkinnedLocatorErrorFunction.create(*sl_np, np.zeros((sl.num_locators, 3)),
                                             device=device),
        target=sl.world_positions(char, char.skeleton_states(truth)))
    triangle = E.SkinnedLocatorTriangleErrorFunction.create(
        *(a[rows] for a in sl_np), r["tri_indices"], r["bary"], weight=r["weight"],
        candidates=r["candidates"], faces=base.mesh.faces.cpu().numpy(), device=device)
    return CatalogProblem(char=char, modules=(
        ("skinned_locator", position), ("skinned_locator_triangle", triangle),
        ("limits", E.LimitErrorFunction.create(device=device))),
        truth=truth, x0=torch.as_tensor(x0_np, device=device))


def skinned_marker_sequence(problem: CatalogProblem, frames: int = 32):
    """The skinned-locator targets of the first `frames` elements as a
    MarkerSequence named after the skinned locators, none occluded (the
    input of get_locator_error's skinned branch)."""
    from momentum_tpu_torch.tracking import MarkerSequence

    target = problem.modules[0][1].target[:frames]
    return MarkerSequence(positions=target,
                          occluded=torch.zeros(target.shape[:2], dtype=torch.bool,
                                               device=target.device),
                          names=problem.char.skinned_locators.names)


# ---- config G: glove-fused tracking ----

GLOVE_FRAMES = 343  # config 6s's length
GLOVE_PER_FRAME_FRAMES = 32  # the per-frame stage's cut: it is host-bound
GLOVE_WRISTS = ("l_arm3", "r_arm3")
GLOVE_FINGERS = (tuple(f"l_hand{i}" for i in range(7)), tuple(f"r_hand{i}" for i in range(7)))
# each glove bone's baked offset: translation (m), then Euler XYZ (rad)
GLOVE_OFFSETS = ((0.03, -0.01, 0.02, 0.1, -0.05, 0.2), (-0.03, 0.01, 0.02, -0.1, 0.05, -0.2))
GLOVE_MARKER_NOISE = 0.002  # m
GLOVE_SENSOR_NOISE = 0.002  # m
GLOVE_SENSOR_ROTATION_NOISE = np.deg2rad(1.0)
GLOVE_INVALID = 0.05
GLOVE_INIT_NOISE = 0.02


class GloveClip(NamedTuple):
    """Config G on one device."""

    char: object  # the full-body rig with glove bones and calibration parameters (P = 169)
    config: object  # GloveConfig
    markers: object  # MarkerSequence (F, 80, 3)
    gloves: tuple  # ((GloveSequence, hand), ...), 7 finger joints a hand
    truth: torch.Tensor  # (F, 169)
    initial: torch.Tensor  # (F, 169) truth + N(0, GLOVE_INIT_NOISE)


def glove_clip_draws(frames: int, seed: int, num_params: int, num_markers: int,
                     num_fingers: int = 7) -> dict:
    """Config G's numpy draws, in order: the motion (F, P) (every rotation
    amp·sin(2πt + phase), amp U(0.05, 0.3) rad, phase U(0, 2π); the root
    walks x 0 → 2 m, y = 0.02·sin(2πt) m, z = 0; the scale and the glove
    calibration parameters 0), the marker noise (m) and occlusion, the
    initial motion's noise, then per hand the sensors' position noise (m),
    rotation noise (axis-angle, rad) and invalid mask."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, frames)[:, None]
    amp = rng.uniform(0.05, 0.3, num_params)
    phase = rng.uniform(0.0, 2 * np.pi, num_params)
    motion = amp * np.sin(2 * np.pi * t + phase)
    motion[:, 0] = np.linspace(0.0, 2.0, frames)
    motion[:, 1] = 0.02 * np.sin(2 * np.pi * t[:, 0])
    motion[:, 2] = 0.0
    motion[:, 6] = 0.0
    motion[:, 157:] = 0.0
    out = dict(motion=motion.astype(np.float32),
               marker_noise=rng.normal(0.0, GLOVE_MARKER_NOISE, (frames, num_markers, 3)),
               occluded=rng.random((frames, num_markers)) < 0.05,
               init_noise=rng.normal(0.0, GLOVE_INIT_NOISE, (frames, num_params)))
    for h in range(2):
        out[f"position_noise{h}"] = rng.normal(0.0, GLOVE_SENSOR_NOISE,
                                               (frames, num_fingers, 3))
        out[f"rotation_noise{h}"] = rng.normal(0.0, GLOVE_SENSOR_ROTATION_NOISE,
                                               (frames, num_fingers, 3))
        out[f"invalid{h}"] = rng.random((frames, num_fingers)) < GLOVE_INVALID
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}


def quaternion_noise(q: np.ndarray, axis_angle: np.ndarray) -> np.ndarray:
    """q ∘ exp(axis_angle) in numpy float32, (x, y, z, w) order."""
    aa = axis_angle.astype(np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(angle, 1e-12)
    r = np.concatenate([axis * np.sin(angle / 2), np.cos(angle / 2)], axis=-1)
    q = q.astype(np.float64)
    v1, w1, v2, w2 = q[..., :3], q[..., 3:], r[..., :3], r[..., 3:]
    out = np.concatenate([w1 * v2 + w2 * v1 + np.cross(v1, v2),
                          w1 * w2 - np.sum(v1 * v2, axis=-1, keepdims=True)], axis=-1)
    return out.astype(np.float32)


def glove_character(device="cuda"):
    """(the full-body rig with a glove bone under each of GLOVE_WRISTS at
    GLOVE_OFFSETS and their 12 calibration parameters, its GloveConfig)."""
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character
    from momentum_tpu_torch.tracking.glove_utils import (
        GloveConfig, GloveOffset, add_glove_bones, add_glove_calibration_parameters)

    cfg = GloveConfig(wrist_joint_names=GLOVE_WRISTS)
    offsets = tuple(GloveOffset(translation=np.asarray(o[:3], np.float32),
                                rotation_euler_xyz=np.asarray(o[3:], np.float32))
                    for o in GLOVE_OFFSETS)
    base = create_fullbody_character(device=resolve(device, "glove_character"))
    return add_glove_calibration_parameters(add_glove_bones(base, cfg, offsets), cfg), cfg


def glove_relative(char, states: torch.Tensor, hand: int, cfg):
    """(positions (..., S, 3), orientations (..., S, 4)) of the hand's
    fingers in its glove bone's frame under global states (..., nJ, 8)."""
    from momentum_tpu_torch.math import quaternion as quat

    names = char.skeleton.joint_names
    bone = names.index("glove_" + cfg.wrist_joint_names[hand])
    fingers = torch.as_tensor([names.index(n) for n in GLOVE_FINGERS[hand]],
                              device=states.device)
    ref, src = states[..., bone:bone + 1, :], states.index_select(-2, fingers)
    q_inv = quat.conjugate(ref[..., 3:7])
    return (quat.rotate_vector(q_inv, src[..., :3] - ref[..., :3]),
            quat.multiply(q_inv, src[..., 3:7]))


def build_glove_clip(frames: int = GLOVE_FRAMES, seed: int = 0, device="cuda") -> GloveClip:
    """Config G on `device` (the card unless the caller asks for the CPU):
    glove_character, glove_clip_draws' motion, the locators' positions by
    the port's FK plus the noise, the occlusion, and per hand a
    GloveSequence of its 7 fingers relative to its glove bone with the
    position and rotation noise and the invalid samples."""
    from momentum_tpu_torch.tracking import MarkerSequence
    from momentum_tpu_torch.tracking.glove_utils import GloveSequence

    device = resolve(device, "build_glove_clip")
    char, cfg = glove_character(device)
    d = glove_clip_draws(frames, seed, char.num_model_parameters, char.locators.num_locators)
    truth = torch.as_tensor(d["motion"], device=device)
    states = char.skeleton_states(truth)
    markers = MarkerSequence(
        positions=char.locators.world_positions(states)
        + torch.as_tensor(d["marker_noise"], device=device),
        occluded=torch.as_tensor(d["occluded"], device=device), names=char.locators.names)
    names = char.skeleton.joint_names
    gloves = []
    for h in range(2):
        pos, ori = (t.cpu().numpy() for t in glove_relative(char, states, h, cfg))
        gloves.append((GloveSequence(
            joint_index=np.asarray([names.index(n) for n in GLOVE_FINGERS[h]], np.int32),
            positions=pos + d[f"position_noise{h}"],
            orientations=quaternion_noise(ori, d[f"rotation_noise{h}"]),
            valid=~d[f"invalid{h}"]), h))
    return GloveClip(char=char, config=cfg, markers=markers, gloves=tuple(gloves), truth=truth,
                     initial=truth + torch.as_tensor(d["init_noise"], device=device))


def _glove_tracking_configs():
    """(the sequence solve's settings, the per-frame stage's): LM with line
    search, 10 iterations, smoothing 1e-4; per frame LM 15 (config 6s's)."""
    from momentum_tpu_torch.tracking import TrackingConfig

    lm = "levenberg_marquardt"
    return (TrackingConfig(max_iter=10, regularization=1e-3, smoothing=1e-4, method=lm),
            TrackingConfig(max_iter=15, regularization=1e-3, method=lm))


def track_glove_sequence(clip: GloveClip):
    """The whole clip by track_sequence from `clip.initial`, markers and
    both gloves (one stacked position and orientation module per hand) →
    TrackingResult."""
    from momentum_tpu_torch.tracking import track_sequence

    return track_sequence(clip.char, clip.markers, _glove_tracking_configs()[0],
                          initial=clip.initial, glove_data=clip.gloves,
                          glove_config=clip.config)[0]


def glove_clip_head(clip: GloveClip, frames: int = GLOVE_PER_FRAME_FRAMES) -> GloveClip:
    """The clip cut to its first `frames` frames."""
    from momentum_tpu_torch.tracking import MarkerSequence
    from momentum_tpu_torch.tracking.glove_utils import GloveSequence

    m = clip.markers
    return clip._replace(
        markers=MarkerSequence(positions=m.positions[:frames], occluded=m.occluded[:frames],
                               names=m.names),
        gloves=tuple((GloveSequence(joint_index=g.joint_index, positions=g.positions[:frames],
                                    orientations=g.orientations[:frames],
                                    valid=g.valid[:frames]), h) for g, h in clip.gloves),
        truth=clip.truth[:frames], initial=clip.initial[:frames])


def track_glove_per_frame(clip: GloveClip):
    """Warm-started per-frame tracking of the clip (LM 15) from its first
    initial pose, markers and both gloves → TrackingResult."""
    from momentum_tpu_torch.tracking import track_poses_per_frame

    return track_poses_per_frame(clip.char, clip.markers, _glove_tracking_configs()[1],
                                 initial=clip.initial[0], glove_data=clip.gloves,
                                 glove_config=clip.config)


def rotation_angle_deg(q: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The angle (degrees) of the rotation between quaternions q and
    target (..., 4), from conj(target) ∘ q in float64: 2·atan2(‖v‖, |w|),
    accurate for the small angles a solve leaves."""
    t = target.astype(np.float64)
    q = q.astype(np.float64)
    tv, tw, qv, qw = -t[..., :3], t[..., 3:], q[..., :3], q[..., 3:]
    v = tw * qv + qw * tv + np.cross(tv, qv)
    w = tw[..., 0] * qw[..., 0] - np.sum(tv * qv, axis=-1)
    return np.rad2deg(2 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w)))


def glove_figures(clip: GloveClip, motion: torch.Tensor) -> dict:
    """The median and p90 marker error (mm) over the visible markers, and
    the median glove residuals over the valid samples: position (mm) and
    orientation (degrees, the angle between the sensed and the solved
    relative rotation)."""
    from momentum_tpu_torch.tracking.tracker import _match_locators

    char, markers = clip.char, clip.markers
    states = char.skeleton_states(motion)
    li, mi = _match_locators(char, markers)
    world = char.locators.world_positions(states).cpu().numpy()
    pos, occ = markers.positions.cpu().numpy(), markers.occluded.cpu().numpy()
    err = 1e3 * np.linalg.norm(world[:, li] - pos[:, mi], axis=-1)[~occ[:, mi]]
    gp, go = [], []
    for g, h in clip.gloves:
        p, q = (t.cpu().numpy().astype(np.float64) for t in glove_relative(char, states, h,
                                                                           clip.config))
        gp.append(1e3 * np.linalg.norm(p - g.positions, axis=-1)[g.valid])
        go.append(rotation_angle_deg(q, g.orientations)[g.valid])
    return dict(median_mm=float(np.median(err)), p90_mm=float(np.percentile(err, 90)),
                glove_position_median_mm=float(np.median(np.concatenate(gp))),
                glove_orientation_median_deg=float(np.median(np.concatenate(go))))


# ---- config SC: SDF-collision IK; config 5c: config 5 held off a ground ----

SDF_BATCH = 2048
SDF_JOINT_BATCH = 256  # the joint-attached grid's cut: its rows come by forward mode
SDF_RESOLUTION = (64, 64, 64)
SDF_OBSTACLE_LEVEL = 3  # make_sphere(3): 1280 faces
SDF_OBSTACLE_CENTER = (0.0, 0.8, 0.5)  # in front of the belly: ~28% of warm starts cut it
SDF_OBSTACLE_RADIUS = 0.35
SDF_COLLISION_WEIGHT = 1e3
SDF_GROUND_VERTICES = 32
# the truths' feet are up to ~0.3 m off the ground, so holding them at 0
# conflicts with the markers: at weight 0.1 the LM 10 stops far from its
# optimum (conv_at_1e5 0.19 on the CPU at B = 64; 0.0 at weight 100), at
# 0.01 it converges (0.86) with the ground's rows and Jacobian still in
SDF_GROUND_WEIGHT = 0.01
# the slab's half width in x and z, and its depth: mesh_to_sdf pads each
# axis by a tenth of its extent, so 8 m of depth puts 0.8 m of the grid
# above the top, past the knees (0.56 m above the soles at rest)
SDF_GROUND_HALF_EXTENT = 2.5
SDF_GROUND_DEPTH = 8.0
SDF_HAND = 36  # r_hand0: the joint-attached grid (a handle held in the right hand)
SDF_HAND_FINGER = 40  # r_hand4: the held vertices are the rest mesh's nearest to it
SDF_HAND_VERTICES = 16
SDF_HAND_RESOLUTION = (32, 32, 32)
SDF_HAND_WEIGHT = 100.0
SDF_CONTACT_HEIGHT = 0.1  # the support contacts' margin above the ground (m)
SDF_SEQUENCE_VERTICES = 8  # config 5c: the test rig's lowest rest vertices
SDF_SEQUENCE_WEIGHT = 100.0


def ground_slab(top: float, half_extent: float = SDF_GROUND_HALF_EXTENT,
                depth: float = SDF_GROUND_DEPTH):
    """A closed box (8 vertices, 12 faces wound outward) whose top face is
    y = top, |x|, |z| ≤ half_extent, `depth` deep: (vertices (8, 3) float32,
    faces (12, 3) int32)."""
    h = half_extent
    v = np.asarray([[x, y, z] for x in (-h, h) for y in (top - depth, top) for z in (-h, h)],
                   np.float32)
    # quads by corner index (x·4 + y·2 + z), each wound outward
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [[a, b, c] for a, b, c, _ in quads] + [[a, c, d] for a, _, c, d in quads]
    return v, np.asarray(f, np.int32)


def _rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """v rotated by the unit quaternion q = (x, y, z, w), float64."""
    u, w = q[..., :3], q[..., 3:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def sdf_recipe(rest_vertices: np.ndarray, bind_states: np.ndarray) -> dict:
    """Config SC's fixed inputs, numpy only, so that the port and
    tools/jax_reference.py build identical ones from the full-body rig's
    rest mesh (V, 3) and bind states (nJ, 8):

      * the obstacle, make_sphere(SDF_OBSTACLE_LEVEL) scaled to
        SDF_OBSTACLE_RADIUS at SDF_OBSTACLE_CENTER;
      * the ground, ground_slab with its top at the rest mesh's lowest
        height, and the SDF_GROUND_VERTICES lowest rest vertices (a stable
        sort) it holds at distance 0;
      * the handle held in the right hand: the SDF_HAND_VERTICES rest
        vertices nearest r_hand4, and a capsule mesh in r_hand0's frame
        along its local x through them, its radius 1 cm past the farthest
        of them, so all lie inside its grid;
      * the support contacts' capsules: config C's ten (catalog_recipe)
        and one along each foot (foot0 → foot2)."""
    from momentum_tpu_torch.rasterizer.primitives import make_capsule, make_sphere

    rest = rest_vertices.astype(np.float64)
    sv, sf = make_sphere(SDF_OBSTACLE_LEVEL)
    obstacle = (sv.astype(np.float64) * SDF_OBSTACLE_RADIUS
                + np.asarray(SDF_OBSTACLE_CENTER)).astype(np.float32)
    top = float(rest[:, 1].min())
    gv, gf = ground_slab(top)
    finger = bind_states[SDF_HAND_FINGER, :3].astype(np.float64)
    hand_vertices = np.argsort(np.linalg.norm(rest - finger, axis=-1), kind="stable")[
        :SDF_HAND_VERTICES]
    hb = bind_states[SDF_HAND].astype(np.float64)
    q_inv = hb[3:7] * np.asarray([-1.0, -1.0, -1.0, 1.0])
    local = _rotate(q_inv, rest[hand_vertices] - hb[:3]) / hb[7]
    x0, x1 = float(local[:, 0].min()), float(local[:, 0].max())
    axis_yz = local[:, 1:].mean(0)
    radius = float(np.linalg.norm(local[:, 1:] - axis_yz, axis=-1).max()) + 0.01
    cv, cf = make_capsule(radius, radius, x1 - x0, radius_subdivisions=12, cap_subdivisions=4)
    handle = (cv.astype(np.float64) + np.asarray([x0, *axis_yz])).astype(np.float32)
    r = catalog_recipe()
    s = np.sqrt(0.5)
    foot = [0.0, -0.5, -0.5, s]  # local x onto (0, −1, 1)/√2, the foot's direction
    caps = dict(parent=np.concatenate([r["capsule_parent"], [28, 48]]).astype(np.int32),
                transform=np.concatenate([r["capsule_transform"],
                                          [[0.0, 0.0, 0.0] + foot + [1.0]] * 2]).astype(
                                              np.float32),
                radius=np.concatenate([r["capsule_radius"], [[0.04, 0.03]] * 2]).astype(
                    np.float32),
                length=np.concatenate([r["capsule_length"], [0.23, 0.23]]).astype(np.float32))
    return dict(obstacle_vertices=obstacle, obstacle_faces=np.asarray(sf, np.int32),
                ground_vertices=gv, ground_faces=gf, ground_top=top,
                ground_index=np.argsort(rest[:, 1], kind="stable")[:SDF_GROUND_VERTICES]
                .astype(np.int32),
                hand_index=hand_vertices.astype(np.int32), handle_vertices=handle,
                handle_faces=np.asarray(cf, np.int32), contact_capsules=caps)


class SdfCollisionProblem(NamedTuple):
    """Config SC on one device."""

    char: object  # the full-body rig with the support contacts' capsules
    modules: tuple  # (("position", ...), ("sdf_collision", ...), ("vertex_sdf", ...))
    truth: torch.Tensor  # (B, 157)
    x0: torch.Tensor  # (B, 157)
    obstacle: object  # SignedDistanceField of the sphere (winding number)
    ground: object  # SignedDistanceField of the slab (closest face's normal)
    handle: object  # SignedDistanceField of the handle, in r_hand0's frame
    plane: object  # SupportPlane of the ground's top
    recipe: dict


def build_sdf_collision_problem(batch: int = SDF_BATCH, seed: int = 0,
                                device="cuda") -> SdfCollisionProblem:
    """Config SC on `device` (the card unless the caller asks for the CPU):
    the full-body rig, catalog_draws' truths and warm starts (truth +
    N(0, 0.05)), and three modules: Position on the 80 locators with each
    element's truth targets; SdfCollision of all 612 vertices against the
    obstacle's field (mesh_to_sdf at 64³ by winding number, built on
    `device`), weight SDF_COLLISION_WEIGHT; VertexSdf holding the 32 lowest
    rest vertices at distance 0 from the ground slab's field (64³, by the
    closest face's normal), weight SDF_GROUND_WEIGHT. Solved by
    solve_catalog (LM 10)."""
    from momentum_tpu_torch import errors as E
    from momentum_tpu_torch.axel import mesh_to_sdf
    from momentum_tpu_torch.character import CollisionGeometry
    from momentum_tpu_torch.math.support_polygon import SupportPlane
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "build_sdf_collision_problem")
    base = create_fullbody_character(device=device)
    r = sdf_recipe(base.mesh.vertices.cpu().numpy(), base.bind_pose().cpu().numpy())
    char = dataclasses.replace(base, collision=CollisionGeometry(
        **{k: torch.as_tensor(v, device=device) for k, v in r["contact_capsules"].items()}))
    obstacle = mesh_to_sdf(r["obstacle_vertices"], r["obstacle_faces"], SDF_RESOLUTION,
                           sign_method="winding", device=device)
    ground = mesh_to_sdf(r["ground_vertices"], r["ground_faces"], SDF_RESOLUTION,
                         sign_method="normal", device=device)
    handle = mesh_to_sdf(r["handle_vertices"], r["handle_faces"], SDF_HAND_RESOLUTION,
                         sign_method="winding", device=device)
    truth_np, x0_np = catalog_draws(batch, seed, char.num_model_parameters)
    truth = torch.as_tensor(truth_np, device=device)
    loc = char.locators
    position = dataclasses.replace(
        E.PositionErrorFunction.create(loc.parent.cpu().numpy(), loc.offset.cpu().numpy(),
                                       np.zeros((loc.num_locators, 3)), device=device),
        target=loc.world_positions(char.skeleton_states(truth)))
    collision = E.SdfCollisionErrorFunction.create(
        obstacle, np.arange(char.mesh.num_vertices), weight=SDF_COLLISION_WEIGHT, device=device)
    floor = E.VertexSdfErrorFunction.create(ground, r["ground_index"], weight=SDF_GROUND_WEIGHT,
                                            device=device)
    return SdfCollisionProblem(
        char=char, modules=(("position", position), ("sdf_collision", collision),
                            ("vertex_sdf", floor)),
        truth=truth, x0=torch.as_tensor(x0_np, device=device), obstacle=obstacle,
        ground=ground, handle=handle,
        plane=SupportPlane.create(offset=r["ground_top"], device=device), recipe=r)


def sdf_joint_problem(problem: SdfCollisionProblem, batch: int = SDF_JOINT_BATCH):
    """Config SC's joint-attached case on the first `batch` elements, as a
    CatalogProblem: the position module, and VertexSdf on the recipe's
    finger vertices against the handle's field attached to r_hand0
    (sdf_parent ≥ 0, so its rows come by forward mode), each element's
    target distances those of its truth pose, weight SDF_HAND_WEIGHT."""
    from momentum_tpu_torch import errors as E
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    char, r = problem.char, problem.recipe
    device = problem.x0.device
    position = problem.modules[0][1]
    position = dataclasses.replace(position, target=position.target[:batch])
    hand = E.VertexSdfErrorFunction.create(problem.handle, r["hand_index"],
                                           weight=SDF_HAND_WEIGHT, sdf_parent=SDF_HAND,
                                           device=device)
    truth = problem.truth[:batch]
    ctx = SkeletonSolverFunction(char, (hand,)).context(truth)
    target = problem.handle.sample(hand._to_sdf_space(ctx, hand._vertices(ctx)))
    return CatalogProblem(char=char, modules=(
        ("position", position), ("vertex_sdf_joint", dataclasses.replace(
            hand, target_distance=target))),
        truth=truth, x0=problem.x0[:batch].contiguous())


def sdf_penetration(problem: SdfCollisionProblem, params: torch.Tensor, rows=slice(None)):
    """(the fraction of elements `rows` with a vertex inside the obstacle,
    each element's deepest penetration max(0, −min φ) (numpy)) at
    `params`."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    collision = problem.modules[1][1]
    ctx = SkeletonSolverFunction(problem.char, (collision,)).context(params[rows])
    depth = torch.clamp(-problem.obstacle.sample(ctx.mesh_vertices).amin(-1), min=0.0)
    depth = depth.cpu().numpy().astype(np.float64)
    return float(np.mean(depth > 0)), depth


def sdf_support_contacts(problem: SdfCollisionProblem, params: torch.Tensor, polygons: int = 0):
    """The support contacts of the poses `params` (B, P) against the
    ground's top plane, margin SDF_CONTACT_HEIGHT: (active (B, L + C) bool
    numpy, the support polygons' areas of the first `polygons` elements
    (float64, shoelace over the hull, 0 below three points))."""
    from momentum_tpu_torch.character.support_contacts import (
        support_contact_positions, support_polygon_from_contacts)

    states = problem.char.skeleton_states(params)
    _, active = support_contact_positions(problem.char, states, SDF_CONTACT_HEIGHT,
                                          problem.plane)
    areas = []
    for i in range(polygons):
        hull = support_polygon_from_contacts(problem.char, states[i], SDF_CONTACT_HEIGHT,
                                             problem.plane).astype(np.float64)
        areas.append(polygon_area(hull))
    return active.cpu().numpy(), np.asarray(areas, np.float64)


def polygon_area(hull: np.ndarray) -> float:
    """The shoelace area of a CCW polygon (H, 2); 0 below three points."""
    if len(hull) < 3:
        return 0.0
    x, y = hull[:, 0], hull[:, 1]
    return float(0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def build_sdf_sequence_problem(frames: int = SEQUENCE_FRAMES, seed: int = 0,
                               device="cuda") -> SequenceProblem:
    """Config 5c on `device` (the card unless the caller asks for the CPU):
    config 5's sequence problem (the 16-joint test rig) with
    SdfCollisionSequence on its SDF_SEQUENCE_VERTICES lowest rest vertices
    (a stable sort) against a ground slab under them (ground_slab, its top
    at their lowest height, mesh_to_sdf at 64³ by the closest face's
    normal), weight SDF_SEQUENCE_WEIGHT."""
    from momentum_tpu_torch.axel import mesh_to_sdf
    from momentum_tpu_torch.sequence import SdfCollisionSequenceErrorFunction

    device = resolve(device, "build_sdf_sequence_problem")
    prob = build_sequence_problem(frames, seed=seed, device=device)
    rest = prob.fn.character.mesh.vertices.cpu().numpy()
    gv, gf = ground_slab(float(rest[:, 1].min()))
    ground = mesh_to_sdf(gv, gf, SDF_RESOLUTION, sign_method="normal", device=device)
    sdf_seq = SdfCollisionSequenceErrorFunction.create(
        ground, np.argsort(rest[:, 1], kind="stable")[:SDF_SEQUENCE_VERTICES],
        weight=SDF_SEQUENCE_WEIGHT, device=device)
    fn = dataclasses.replace(prob.fn, sequence_errors=prob.fn.sequence_errors + (sdf_seq,))
    return prob._replace(fn=fn)


# ---- config U: retargeting and character surgery on the full-body rig ----

UTILITY_BATCH = 2048
UTILITY_INTEROP = 256  # the 4×4 form of torch_interop.transform_pose runs on these
UTILITY_TURN = 0.7  # U1's move: a turn about y (rad) ...
UTILITY_SHIFT = (4.0, 0.0, -1.5)  # ... and a shift (m) across a capture volume
UTILITY_SCALE = 1.15  # U3: the subject 15% taller than the rig
UTILITY_TOTAL_MASS = 70.0  # kg over the bodies, split by bone length
UTILITY_COM_WEIGHT = 1.0
UTILITY_DROPPED = ("_leg", "_foot")  # U4: the joints whose parameters are disabled


class UtilityProblem(NamedTuple):
    """Config U on one device."""

    char: object  # the full-body rig with one body per joint
    xform: torch.Tensor  # (8,) U1's move
    truth: torch.Tensor  # (B, 157)
    x0: torch.Tensor  # (B, 157)
    scaled: CatalogProblem  # U3: the rig scaled, markers and centre of mass
    simplified: CatalogProblem  # U4: the legs and feet dropped, markers on the kept joints
    enabled: np.ndarray  # (157,) bool: U4's enabled parameters


def utility_bodies(parents: np.ndarray, offsets: np.ndarray) -> dict:
    """Config U's bodies, numpy only, so that the port and
    tools/jax_reference.py build identical ones from the rig's parents (nJ,)
    and translation offsets (nJ, 3): one body a joint along its bone (its
    first child's offset; a leaf's own offset), UTILITY_TOTAL_MASS split by
    bone length, the centre of mass at the bone's middle, a thin rod's
    inertia m·L²/12·(I − ûûᵀ) about it, the inertia frame the joint's."""
    parents = np.asarray(parents, np.int64)
    offsets = np.asarray(offsets, np.float64)
    nj = len(parents)
    bone = offsets.copy()
    for j in range(nj - 1, 0, -1):  # the first child's offset wins
        bone[parents[j]] = offsets[j]
    length = np.linalg.norm(bone, axis=-1)
    mass = UTILITY_TOTAL_MASS * length / length.sum()
    u = bone / np.maximum(length, 1e-12)[:, None]
    inertia = (mass * length ** 2 / 12.0)[:, None, None] * (np.eye(3) - u[:, :, None]
                                                             * u[:, None, :])
    return dict(joint_index=np.arange(nj, dtype=np.int32), mass=mass.astype(np.float32),
                center_of_mass_offset=(0.5 * bone).astype(np.float32),
                inertia=inertia.astype(np.float32),
                inertia_rotation=np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (nj, 1)))


def utility_xform() -> np.ndarray:
    """U1's move as an (8,) skel_state: UTILITY_TURN about y, UTILITY_SHIFT."""
    half = 0.5 * UTILITY_TURN
    return np.asarray([*UTILITY_SHIFT, 0.0, np.sin(half), 0.0, np.cos(half), 1.0], np.float32)


def utility_enabled(parameter_names, dropped=UTILITY_DROPPED) -> np.ndarray:
    """U4's enabled parameters: all but those of joints named with `dropped`."""
    return np.asarray([not any(d in n for d in dropped) for n in parameter_names], bool)


def utility_character(device="cuda"):
    """The full-body rig with config U's bodies (utility_bodies)."""
    from momentum_tpu_torch.character import PhysicalProperties
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = resolve(device, "utility_character")
    char = create_fullbody_character(device=device)
    skel = char.skeleton
    bodies = utility_bodies(skel.parents_np, skel.translation_offset.cpu().numpy())
    return dataclasses.replace(char, physical_properties=PhysicalProperties(
        **{k: torch.as_tensor(v, device=device) for k, v in bodies.items()},
        joint_names=skel.joint_names))


def center_of_mass(char, states: torch.Tensor) -> torch.Tensor:
    """(..., 3) centre of mass of the character's bodies under global states."""
    pp = char.physical_properties
    from momentum_tpu_torch.math import skel_state as ss

    pos = ss.transform_points(states.index_select(-2, pp.joint_index.long()),
                              pp.center_of_mass_offset)
    return torch.einsum("...ji,j->...i", pos, pp.mass) / pp.mass.sum()


def simplified_character(char, enabled: np.ndarray):
    """U4's rig: the mesh reduced to the vertices whose largest weight is on
    a joint the enabled parameters keep (compat.reduce_mesh_to_bones, done
    before the surgery: after it every influence lies on a kept joint), then
    `simplify` to those joints."""
    from momentum_tpu_torch import compat
    from momentum_tpu_torch.character.utility import parameters_to_active_joints, simplify

    active = parameters_to_active_joints(char.parameter_transform, enabled)
    active[0] = True
    return simplify(compat.reduce_mesh_to_bones(char, np.nonzero(active)[0]), enabled)


def build_utility_problem(batch: int = UTILITY_BATCH, seed: int = 0,
                          device="cuda") -> UtilityProblem:
    """Config U on `device` (the card unless the caller asks for the CPU):
    the full-body rig with one body a joint (utility_character),
    catalog_draws' truths and warm starts (truth + N(0, 0.05)), U1's move,
    and the two solve problems of solve_catalog (LM 10):

      * U3: the rig scaled by UTILITY_SCALE (scale_character,
        "preserve_mass"); Position on its 80 locators and
        CenterOfMass.from_physical_properties, their targets those of each
        element's truth on the scaled rig;
      * U4: simplified_character with every parameter enabled but the legs'
        and feet's; Position on the locators it keeps, the targets of each
        element's truth (its kept parameters)."""
    from momentum_tpu_torch import errors as E

    device = resolve(device, "build_utility_problem")
    char = utility_character(device)
    truth_np, x0_np = catalog_draws(batch, seed, char.num_model_parameters)
    truth = torch.as_tensor(truth_np, device=device)
    x0 = torch.as_tensor(x0_np, device=device)

    def markers(rig, t):
        loc = rig.locators
        return dataclasses.replace(
            E.PositionErrorFunction.create(loc.parent.cpu().numpy(), loc.offset.cpu().numpy(),
                                           np.zeros((loc.num_locators, 3)), device=device),
            target=loc.world_positions(rig.skeleton_states(t)))

    scaled = char.scaled(UTILITY_SCALE, "preserve_mass")
    com = dataclasses.replace(
        E.CenterOfMassErrorFunction.from_physical_properties(
            scaled, np.zeros(3), weight=UTILITY_COM_WEIGHT, device=device),
        target=center_of_mass(scaled, scaled.skeleton_states(truth)))
    enabled = utility_enabled(char.parameter_transform.names)
    simple = simplified_character(char, enabled)
    cols = torch.as_tensor([char.parameter_transform.names.index(n)
                            for n in simple.parameter_transform.names], device=device)
    truth_s = truth.index_select(1, cols)
    return UtilityProblem(
        char=char, xform=torch.as_tensor(utility_xform(), device=device), truth=truth, x0=x0,
        scaled=CatalogProblem(char=scaled, modules=(("position", markers(scaled, truth)),
                                                    ("center_of_mass", com)),
                              truth=truth, x0=x0),
        simplified=CatalogProblem(char=simple, modules=(("position", markers(simple, truth_s)),),
                                  truth=truth_s, x0=x0.index_select(1, cols).contiguous()),
        enabled=enabled)


def retarget(problem: UtilityProblem, params: torch.Tensor) -> torch.Tensor:
    """U1: transform_pose of `params` (B, P) by the problem's move."""
    from momentum_tpu_torch.character.transform_pose import transform_pose

    return transform_pose(problem.char, params, problem.xform)


def retarget_figures(problem: UtilityProblem, params: torch.Tensor,
                     moved: torch.Tensor) -> dict:
    """U1's holds in float64: compare_skeleton_states of FK(moved) against
    xform·FK(params) (max and mean position and rotation error; the
    quaternions normalized first, since FK's float32 products leave their
    norms ~1e-6 off 1, which the angle 2·acos|q·q'| reads as ~3e-3 rad), and
    the largest distance between the skinned vertices of `moved` and those
    of `params` moved by xform."""
    from momentum_tpu_torch import compat
    from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

    def unit(states):
        return torch.cat([states[..., :3], quat.normalize(states[..., 3:7]), states[..., 7:]],
                         dim=-1)

    char, xf = problem.char, problem.xform
    got = unit(char.skeleton_states(moved).double())
    want = unit(ss.multiply(xf.double(), char.skeleton_states(params).double()))
    cmp = {k: float(v) for k, v in compat.compare_skeleton_states(got, want).items()}
    skin_new = compat.skin_points_from_model_parameters(char, moved).double()
    skin_old = ss.transform_points(xf.double(),
                                   compat.skin_points_from_model_parameters(char, params).double())
    cmp["max_vertex_error"] = float(torch.linalg.vector_norm(skin_new - skin_old, dim=-1).max())
    return cmp


def inverse_fk_figures(problem: UtilityProblem, params: torch.Tensor) -> dict:
    """U2: (joint parameters by inverse FK of FK(params), and in float64 the
    largest re-FK position error, the largest joint-parameter error against
    the forward ones, and the same through the local states
    (model_parameters_to_local_skeleton_state and back))."""
    from momentum_tpu_torch import compat

    char = problem.char
    jp = char.parameter_transform.apply(params)
    states = compat.joint_parameters_to_skeleton_state(char, jp)
    jp_back = compat.skeleton_state_to_joint_parameters(char, states)
    again = compat.joint_parameters_to_skeleton_state(char, jp_back)
    local = compat.model_parameters_to_local_skeleton_state(char, params)
    jp_local = compat.local_skeleton_state_to_joint_parameters(char, local)
    return jp_back, dict(
        max_refk_position_error=float(torch.linalg.vector_norm(
            again[..., :3].double() - states[..., :3].double(), dim=-1).max()),
        max_joint_parameter_error=float((jp_back.double() - jp.double()).abs().max()),
        max_local_joint_parameter_error=float((jp_local.double() - jp.double()).abs().max()))


def array_digest(a) -> str:
    """sha256 of an array's bytes, little-endian float32 or int32 (the
    tables config U holds equal to JAX CPU's)."""
    import hashlib

    a = np.asarray(a)
    a = a.astype("<f4") if a.dtype.kind == "f" else a.astype("<i4")
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def simplified_tables(char) -> dict:
    """U4's rig as the tables config U holds equal to JAX CPU's: the joint
    parents, locator parents and parameter names as lists; the transform,
    every limit table and the mesh faces by array_digest."""
    lim = char.limits
    return dict(joint_parents=char.skeleton.parents_np.tolist(),
                locator_parents=char.locators.parent.cpu().numpy().tolist(),
                parameter_names=list(char.parameter_transform.names),
                transform=array_digest(char.parameter_transform.transform.cpu().numpy()),
                limits={f.name: array_digest(getattr(lim, f.name).cpu().numpy())
                        for f in dataclasses.fields(lim)},
                mesh_faces=array_digest(char.mesh.faces.cpu().numpy()),
                num_vertices=int(char.mesh.num_vertices))


# ---- config IO: the file layer (momentum_tpu_torch/io) ----

IO_REFERENCE_DIR = "tools/jax_reference_io"  # python tools/jax_reference.py --configs io
IO_LIMIT_KEYS = (
    "minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
    "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive", "linear_ref",
    "linear_tgt", "linear_scale", "linear_offset", "linear_range", "linear_weight",
    "linear_joint_ref", "linear_joint_tgt", "linear_joint_scale", "linear_joint_offset",
    "linear_joint_range", "linear_joint_weight", "halfplane_idx1", "halfplane_idx2",
    "halfplane_normal", "halfplane_offset", "halfplane_weight", "ellipsoid_parent",
    "ellipsoid_frame_parent", "ellipsoid_point_offset", "ellipsoid_mat", "ellipsoid_inv",
    "ellipsoid_weight")
# the tables a loader computes by FK rather than reads: held within a
# tolerance, every other table bit for bit
IO_COMPUTED_KEYS = ("inverse_bind_pose", "states")


def character_tables(char, prefix: str) -> dict:
    """A character's tables as host numpy arrays under `prefix.`: skeleton,
    parameter transform (its sets and pose presets as JSON), every limit
    table, locators, mesh, skin, inverse bind pose and bodies, with their
    names (tools/jax_reference.py::io_tables gives the same keys for a JAX
    character)."""
    import json

    from momentum_tpu_torch.device import to_host

    sk, pt, lo = char.skeleton, char.parameter_transform, char.locators
    d = dict(joint_parent=sk.joint_parent, pre_rotation=sk.pre_rotation,
             translation_offset=sk.translation_offset, joint_names=list(sk.joint_names),
             transform=pt.transform, offsets=pt.offsets, parameter_names=list(pt.names),
             parameter_sets=json.dumps({k: list(v) for k, v in pt.parameter_sets.items()}),
             pose_constraints=json.dumps({k: [list(p) for p in v]
                                          for k, v in pt.pose_constraints.items()}))
    d.update({k: getattr(char.limits, k) for k in IO_LIMIT_KEYS})
    if lo is not None:
        d.update(locator_parent=lo.parent, locator_offset=lo.offset, locator_weight=lo.weight,
                 locator_names=list(lo.names))
    if char.mesh is not None:
        d.update(mesh_vertices=char.mesh.vertices, mesh_faces=char.mesh.faces)
        if char.mesh.normals is not None:
            d.update(mesh_normals=char.mesh.normals)
    if char.skin_weights is not None:
        d.update(skin_index=char.skin_weights.index, skin_weight=char.skin_weights.weight)
    if char.inverse_bind_pose is not None:
        d.update(inverse_bind_pose=char.inverse_bind_pose)
    pp = char.physical_properties
    if pp is not None:
        d.update(body_joint_index=pp.joint_index, body_mass=pp.mass,
                 body_center_of_mass_offset=pp.center_of_mass_offset,
                 body_inertia=pp.inertia, body_inertia_rotation=pp.inertia_rotation,
                 body_joint_names=list(pp.joint_names))
    return {f"{prefix}.{k}": np.asarray(to_host(v)) for k, v in d.items()}


def io_reference_loads(directory: str, device="cuda") -> dict:
    """What the port's loaders give for each file of `directory` (written by
    python tools/jax_reference.py --configs io), loaded onto `device` (the
    card unless the caller asks for the CPU), under the keys of
    jax_reference_io.npz."""
    import os

    from momentum_tpu_torch import io as tio
    from momentum_tpu_torch.device import to_host
    from momentum_tpu_torch.io.gltf import load_character_glb_with_skel_states

    device = resolve(device, "io_reference_loads")
    path = lambda name: os.path.join(directory, name)  # noqa: E731
    out = {}
    char, motion, fps, markers = tio.load_character_glb(path("fullbody.glb"),
                                                        return_markers=True, device=device)
    out.update(character_tables(char, "glb"))
    lm_motion, lm_names, lm_identity, lm_joints = tio.load_motion(path("fullbody.glb"))
    out.update({"glb.motion": to_host(motion), "glb.fps": np.asarray(fps),
                "glb.marker_positions": to_host(markers.positions),
                "glb.marker_occluded": to_host(markers.occluded),
                "glb.marker_names": np.asarray(list(markers.names)),
                "glb.timestamps": tio.gltf.load_motion_timestamps(path("fullbody.glb")),
                "glb.load_motion": lm_motion, "glb.load_motion_names": np.asarray(lm_names),
                "glb.identity": lm_identity, "glb.identity_joint_names": np.asarray(lm_joints)})
    got, states, fps = load_character_glb_with_skel_states(path("fullbody_skel_states.glb"),
                                                           device=device)
    out.update(character_tables(got, "skel"))
    out.update({"skel.states": to_host(states), "skel.fps": np.asarray(fps)})
    pt, limits = tio.load_model_definition(path("fullbody.model"), char.skeleton)
    keep = ("transform", "offsets", "parameter_names", "parameter_sets",
            "pose_constraints") + IO_LIMIT_KEYS
    out.update({k: v for k, v in character_tables(dataclasses.replace(
        char, parameter_transform=pt, limits=limits), "model").items()
        if k.split(".", 1)[1] in keep})
    loc = tio.load_locators(path("fullbody.locators"), char)
    out.update({f"locators.{k}": to_host(getattr(loc, k)) for k in (
        "parent", "offset", "weight", "locked", "limit_weight", "limit_origin",
        "attached_to_skin", "skin_offset")})
    out["locators.names"] = np.asarray(list(loc.names))
    out.update(character_tables(tio.load_legacy_json(path("fullbody.json"), device=device),
                                "json"))
    mp = tio.load_mppca(path("fullstack.mppca"), device=device)
    out.update({f"mppca.{k}": to_host(getattr(mp, k)) for k in ("mu", "cinv", "l", "rpre")})
    out["mppca.names"] = np.asarray(list(mp.names))
    poses, scale, pnames, jnames = tio.load_mmo(path("fullbody.mmo"))
    out.update({"mmo.poses": poses, "mmo.scale": scale,
                "mmo.parameter_names": np.asarray(pnames), "mmo.joint_names": np.asarray(jnames)})
    for key, name in (("trc", "take.trc"), ("c3d_real", "take_real.c3d"),
                      ("c3d_integer", "take_integer.c3d")):
        raw = tio.load_markers(path(name))[0]
        out.update({f"{key}.positions": raw.positions, f"{key}.occluded": raw.occluded,
                    f"{key}.names": np.asarray(raw.names), f"{key}.fps": np.asarray(raw.fps)})
    return out


IO2_REFERENCE_DIR = "tools/jax_reference_io2"  # python tools/jax_reference.py --configs io2
IO2_FPS = 30.0  # the reference files' rate (the tool's IO_FPS)
# the io2 tables computed rather than read, beside IO_COMPUTED_KEYS: the USD
# joints' rest rotations and offsets (from_matrix of the rest transforms,
# float32 on the host) and the BVH motion (Euler angles re-extracted from
# rotation matrices in float32 on the host)
IO2_COMPUTED = ("usda.pre_rotation", "usda.translation_offset", "usdc.pre_rotation",
                "usdc.translation_offset", "cmu.pre_rotation", "cmu.translation_offset",
                "bvh.motion")


def io2_reference_loads(directory: str, device="cuda") -> dict:
    """What the port's loaders give for each file of `directory` (written by
    python tools/jax_reference.py --configs io2), loaded onto `device` (the
    card unless the caller asks for the CPU), under the keys of
    jax_reference_io2.npz. The USD files' skeleton states come from one
    batched FK over their frames (K1 on the card)."""
    import os

    from momentum_tpu_torch import io as tio
    from momentum_tpu_torch.device import to_host
    from momentum_tpu_torch.io import usd

    device = resolve(device, "io2_reference_loads")
    path = lambda name: os.path.join(directory, name)  # noqa: E731
    out = {}
    got, motion, fps = tio.load_fbx_with_motion(path("fullbody.fbx"), fps=IO2_FPS, device=device)
    out.update(character_tables(got, "fbx"))
    out.update({"fbx.motion": to_host(motion), "fbx.fps": np.asarray(fps)})
    for ext in ("usda", "usdc"):
        got, motion = tio.load_usd(path(f"fullbody.{ext}"), device=device)
        _, states, fps = usd.load_character_with_skel_states(path(f"fullbody.{ext}"),
                                                             device=device)
        out.update(character_tables(got, ext))
        out.update({f"{ext}.motion": to_host(motion), f"{ext}.states": to_host(states),
                    f"{ext}.fps": np.asarray(fps), f"{ext}.name": np.asarray(got.name)})
    got, motion, fps = tio.load_bvh(path("fullbody.bvh"), device=device)
    out.update(character_tables(got, "bvh"))
    out.update({"bvh.motion": to_host(motion), "bvh.fps": np.asarray(fps)})
    out.update(character_tables(tio.load_full_character(path("cmu.usda"), path("cmu.model"),
                                                        device=device), "cmu"))
    out.update(character_tables(tio.load_urdf(path("arm.urdf"), device=device), "urdf"))
    return out


def io_mismatches(got: dict, want: dict, computed_tol: float, computed=()) -> list:
    """The keys on which two io table dicts differ: missing on either side,
    a dtype kind or shape apart, or values not equal bit for bit (NaN equal
    to NaN) — within `computed_tol` for IO_COMPUTED_KEYS and the keys in
    `computed`."""
    bad = sorted(set(got) ^ set(want))
    for k in sorted(set(got) & set(want)):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype.kind != b.dtype.kind or a.shape != b.shape:
            bad.append(k)
        elif k.rsplit(".", 1)[-1] in IO_COMPUTED_KEYS or k in computed:
            if not np.allclose(a, b, rtol=0.0, atol=computed_tol):
                bad.append(k)
        elif not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            bad.append(k)
    return bad
