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
           "make_vertex_fit_solve", "solve_vertex_fit_frame", "build_render_clip",
           "make_render_clip", "clip_vertices", "render_clip_passes"]

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
