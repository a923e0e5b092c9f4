"""The workloads of the port: the bench.py IK workload of
momentum_tpu/testing/workloads.py, and the shadowed render of a posed clip
of benchmarks/bench_suite.py::config7.

Full-body marker IK (51-joint / 157-parameter rig, 80 position constraints),
warm-started batch-native LM: `k_full` full-batch iterations, then `r_refine`
compacted iterations on the worst `capacity` elements
(solver/compaction.py). The random numbers come from numpy exactly as the
JAX workload draws them, so both packages solve the same problem from the
same seed.

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
           "DEFAULT_REFINE", "DEFAULT_BATCH", "build_render_clip", "make_render_clip"]

# 5 full-batch LM iterations + 6 compacted iterations on the worst 128 of 2048
DEFAULT_REFINE = (5, 6, 128)
DEFAULT_BATCH = 2048


def build_fullbody_ik_problem(batch: int, seed: int = 0, noise: float = 0.05,
                              device=None):
    """(char, ef0, targets, x0): targets are exact locator positions of
    uniform-random ground-truth poses; x0 is truth + `noise` gaussian."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(seed)
    gt_np = rng.uniform(-0.3, 0.3, (batch, char.num_model_parameters)).astype(np.float32)
    gt = torch.as_tensor(gt_np, device=device)
    targets = char.locators.world_positions(char.skeleton_states(gt))
    ef0 = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device=device)
    x0 = gt + torch.as_tensor(rng.normal(0, noise, gt_np.shape).astype(np.float32),
                              device=device)
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


def build_render_clip(frames: int = 32, seed: int = 0, device=None, image_height: int = 960,
                      image_width: int = 1280):
    """(char, motion (frames, 157), camera): config 7's character, its
    random-walk clip (cumulative 0.02·N(0, 1) steps from numpy, as the JAX
    recipe draws them) and the camera framing every frame at the render
    size."""
    from momentum_tpu_torch.rasterizer.utils import create_camera_for_body
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    char = create_fullbody_character(device=device)
    rng = np.random.default_rng(seed)
    steps = 0.02 * rng.normal(0, 1, (frames, char.num_model_parameters)).astype(np.float32)
    motion = torch.as_tensor(np.cumsum(steps, axis=0), device=device)
    cam = create_camera_for_body(char, char.skeleton_states(motion), image_height,
                                 image_width)
    return char, motion, cam


def make_render_clip(char, cam, width: int = 640, height: int = 480, supersample: int = 2,
                     shadow_resolution: int = 256):
    """`render_clip(motion) -> (frames, height, width, 3)` colour images:
    FK of every frame in one batch (kernel K1 on the card), LBS skinning,
    then per frame `render_mesh_shadowed` at (supersample·height,
    supersample·width) (two rasterizer passes, kernel K4b on the card) and a
    supersample × supersample box filter."""
    from momentum_tpu_torch.character.skinning import skin_points
    from momentum_tpu_torch.rasterizer import render_mesh_shadowed

    ss = supersample

    def render_clip(motion):
        states = char.skeleton_states(motion)
        verts = skin_points(char.skin_weights, states, char.inverse_bind_pose,
                            char.mesh.vertices)
        frames = []
        for v in verts:
            out = render_mesh_shadowed(cam, v, char.mesh.faces, width * ss, height * ss,
                                       shadow_resolution=shadow_resolution)
            frames.append(out["color"].reshape(height, ss, width, ss, 3).mean(dim=(1, 3)))
        return torch.stack(frames)

    return render_clip
