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
half by marker energy.

The render clip: the full-body character's skinned tube mesh (612 vertices,
612 faces) posed by a 32-frame random walk in its 157 parameters, rendered
with Lambert shading and a 256 × 256 shadow map at 1280 × 960 and box-
filtered to 640 × 480 — the reference rasterizer's one published
performance figure (~45 fps on an 8-core CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["build_fullbody_ik_problem", "make_solve_stage", "make_solve_batch",
           "DEFAULT_REFINE", "DEFAULT_BATCH", "build_fullstack_problem",
           "make_fullstack_solve", "FULLSTACK_REFINE", "build_render_clip",
           "make_render_clip", "clip_vertices", "render_clip_passes"]

# 5 full-batch LM iterations + 6 compacted iterations on the worst 128 of 2048
DEFAULT_REFINE = (5, 6, 128)
DEFAULT_BATCH = 2048
# full stack: 2 full-batch GN iterations + 1 on the worst 1024 of 2048 (bench.py:277)
FULLSTACK_REFINE = (2, 1, 1024)


def _device(device, entry: str) -> torch.device:
    """The device a workload is built on: the card unless the caller asks for
    the CPU; no silent fallback when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} builds on the CUDA card by default and this machine "
                           "has none: pass device='cpu' to build it on the CPU")
    return device


def build_fullbody_ik_problem(batch: int, seed: int = 0, noise: float = 0.05,
                              device="cuda", return_states: bool = False):
    """(char, ef0, targets, x0[, states]) on `device` (the card unless the
    caller asks for the CPU): targets are exact locator positions of
    uniform-random ground-truth poses; x0 is truth + `noise` gaussian;
    return_states adds the ground truth's global states."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = _device(device, "build_fullbody_ik_problem")
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


def build_fullstack_problem(batch: int, seed: int = 0, noise: float = 0.05,
                            device="cuda"):
    """(char, efs, targets, q_targets, x0) on `device` (the card unless the
    caller asks for the CPU): the IK problem of
    build_fullbody_ik_problem with bench.py's full-stack modules
    efs = (position, orientation, limit, pose prior), the first two with
    placeholder targets; q_targets (B, 51, 4) are the ground truth's global
    rotations."""
    from momentum_tpu_torch.errors import (
        LimitErrorFunction, Mppca, OrientationErrorFunction, PosePriorErrorFunction)

    device = _device(device, "build_fullstack_problem")
    char, ef_pos, targets, x0, states = build_fullbody_ik_problem(
        batch, seed=seed, noise=noise, device=device, return_states=True)
    nj, p = char.num_joints, char.num_model_parameters
    ef_ori = OrientationErrorFunction.create(
        np.arange(nj, dtype=np.int32), np.tile(np.asarray([0, 0, 0, 1], np.float32), (nj, 1)),
        device=device)
    names = char.parameter_transform.names
    prior = Mppca.from_components(
        pi=np.asarray([0.6, 0.4]), mu=np.zeros((2, p), np.float32),
        w_list=[np.full((p, 4), 0.01, np.float32)] * 2, sigma2=np.asarray([1.0, 2.0]),
        names=names, device=device)
    efs = (ef_pos, ef_ori, LimitErrorFunction.create(device=device),
           PosePriorErrorFunction.create(prior, names))
    return char, efs, targets, states[..., 3:7], x0


def make_fullstack_solve(char, efs, batch: int):
    """bench.py's full-stack solve `(targets, q_targets, x0) -> (params,
    marker energy (B,))`: GN (regularization 1e-5, Σ rows² as the energy)
    through solve_ik for 2 iterations on the whole batch, then 1 more on
    the 1024 elements of highest marker energy (NaN and inf first;
    FULLSTACK_REFINE). GN keeps no state between iterations, so the refined
    elements follow the (k_full + r_refine)-iteration solve exactly. The
    capacity, quoted at B = 2048, scales with the batch."""
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
                        method="gauss_newton").params

    def marker_energy(targets, params):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef_pos, target=targets),))
        return fn.error(params)

    def solve(targets, q_targets, x0):
        params = stage(targets, q_targets, x0, k_full)
        energy = marker_energy(targets, params)
        key = torch.nan_to_num(energy, nan=3.0e38, posinf=3.0e38)
        _, idx = torch.topk(key, cap)
        sub = stage(targets[idx], q_targets[idx], params[idx], r_refine)
        return (params.index_copy(0, idx, sub),
                energy.index_copy(0, idx, marker_energy(targets[idx], sub)))

    return solve


def build_render_clip(frames: int = 32, seed: int = 0, device="cuda",
                      image_height: int = 960, image_width: int = 1280):
    """(char, motion (frames, 157), camera) on `device` (the card unless the
    caller asks for the CPU): config 7's character, its random-walk clip
    (cumulative 0.02·N(0, 1) steps from numpy, as the JAX recipe draws them)
    and the camera framing every frame at the render size."""
    from momentum_tpu_torch.rasterizer.utils import create_camera_for_body
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    device = _device(device, "build_render_clip")
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
