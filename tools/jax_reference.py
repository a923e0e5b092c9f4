"""The JAX package's CPU figures that chip_smoke.py holds the port against,
for benchmarks/bench_suite.py's configs 2 and 4, on the recipes of
momentum_tpu_torch/testing/workloads.py:

  * config 2: the single frame's final energy (LM 20, default options);
    2b on bench.py's full-stack problem (seed 0): Gauss-Newton 2 + 1 on the
    worst B/2 by marker energy, against each element's 40-iteration LM
    optimum on the normal equations: conv_at_1e5 and median_excess_vs_40it;
  * config 4: the single frame's final energy (LM 20 from zero); 4b (seed 1):
    GN 4 + 2 on the worst B/4, median_param_sq_err and the divergent count;
  * config 5 (the 16-joint test rig) and 5f (the full-body rig): the
    sequence solve of F frames (GN 8, universal parameters the rig's
    "scaling" set): the final error, iterations and converged;
  * config 6s, config 6's marker pipeline (bench_suite.py:441-560) on the
    synthetic 343-frame clip of testing/workloads.py::build_tracking_clip
    (the same numpy motion, noise and occlusion; the markers by JAX's FK):
    the calibrated scale_global, the locators' largest offset change (mm),
    and per stage the median and p90 marker error (mm) over the visible
    markers (over calibration's 10 sampled frames for the two calibration
    stages), with the tracking stages' median per-frame energy; with
    --out-6s, also the calibrated identity and locator offsets and the
    per-frame motion, which the smoke feeds to the port's tracking stages
    and refine.

  * config C, batched IK over the whole rigid error catalog (the recipe
    of workloads.py::build_catalog_ik_problem, vmapped per element: JAX's
    Projection Jacobian holds only unbatched, ROADMAP F15): each module's
    median energy after LM 10, conv_at_1e5 against 20 more iterations,
    the divergent count, at --catalog-batch (256: the smoke holds the
    port's first 256 of 2048);
  * config 6k, config 6s's clip with four cameras' 2D keypoints (the
    recipe of workloads.py::build_keypoint_clip), from the files that
    --out-6s writes: batched tracking from the calibrated identity and the
    refine of the per-frame motion, both with markers and keypoints; the
    median and p90 marker error (mm) and the median reprojection error (px).

  * config D, differentiable IK (the recipe of
    workloads.py::build_diff_ik_problem): GN 20 by solve_ik_ift with
    scale_global disabled and the loss Σ w·θ*, vmapped per element (JAX's
    IFT backward holds only unbatched, ROADMAP F20): each element's energy at
    θ*, its gradient rmse and the gradients to its targets and constraint
    weights, at --diffik-batch (256: the smoke holds the port's first 256 of
    2048); with --out-diffik, the figures to a JSON file and the
    per-element arrays beside it as <name>.npz;
  * the solver variants on config D's position problem
    (workloads.py::variant_recipe): each one's median final energy and
    divergent count, and the history's shapes, at --diffik-batch;
  * config 4x, config 4b (seed 1, B = --batch) with the three forward-mode
    vertex modules of workloads.py::vertex_extra_recipe: GN 4 + 2 on the
    worst B/4, each module's median final energy on the first 64 elements
    and on all, the divergent count.

  * config 4ad, config 4b solved with the forward-mode Jacobian
    (force_ad, bench_suite.py:370-375): GN 6 on the whole batch,
    median_param_sq_err and the divergent count;
  * config SL, skinned-locator IK (the recipe of
    workloads.py::build_skinned_ik_problem), each element one vmapped solve:
    each module's median energy after LM 10, conv_at_1e5, the divergent
    count at --skinned-batch, get_locator_error of the first 32 solves, and
    the skinned-locator tables;
  * config G, glove-fused tracking (the recipe of
    workloads.py::build_glove_clip): track_sequence over --tracking-frames
    frames with the gloves split per joint (ROADMAP F21), per-frame tracking
    of the first 32; the final error, the marker errors (mm) and the glove
    residuals.

  * config 7p, the pymomentum renderer's scene on config 7's clip at
    640 × 480 (workloads.py's build_scene_clip): frames 0 and 1 of the
    offline viewer and of the Phong scene, windowed (JAX's CPU "auto") and
    through the planes kernel in interpret mode: coverage and mean colour.

  * config SC, SDF-collision IK (workloads.py::build_sdf_collision_problem:
    its fields built by JAX's mesh_to_sdf from the same numpy meshes), each
    element one vmapped solve: each module's median energy after LM 10,
    conv_at_1e5, the divergent count, the obstacle's penetration before
    and after, the support contacts and polygon areas of the solved poses,
    and the joint-attached case, at --sdf-batch; with --out-sdf, JAX's
    solved parameters beside the figures as <name>.npz; and config 5c
    (workloads.py::build_sdf_sequence_problem) at --frames: the final
    error.

  * config U, retargeting and character surgery (the recipe of
    workloads.py::build_utility_problem) at --utility-batch: U1,
    transform_pose by the config's move (its largest FK position error,
    ROADMAP F25); U2, inverse FK's joint parameters (to <name>.npz); U3,
    IK on the rig scaled by 1.15 with the bodies' centre of mass, and U4,
    IK on the rig simplified to the parameters off the legs and feet, each
    element one vmapped solve: each module's median energy after LM 3
    (far above float32 roundoff) and after LM 10, conv_at_1e5, the
    divergent count; U4's tables; with --utility-seeds, U3's and U4's
    figures on those seeds' draws too.

  * io, the file layer's reference files (--out-io, default
    tools/jax_reference_io/): the full-body rig with config U's bodies as
    .glb (8 frames of motion, a marker sequence, an identity and
    timestamps), the same rig's 8 frames' skeleton states by GltfBuilder,
    its .model, .locators and legacy .json, the full stack's MPPCA as
    .mppca, the 8 frames as .mmo, and the first 64 frames of config 6s's
    clip as .trc and as real and integer .c3d (tools/c3d_writer.py); beside
    them jax_reference_io.npz, what JAX's loaders return for each file.

  * io2, the file layer's second part (--out-io2, default
    tools/jax_reference_io2/): the full-body rig with config U's bodies and
    8 frames of motion as binary .fbx, .usda, .usdc and .bvh, config 6's
    CMU rig as .usda with its .model (USD carries no limits), and the arm
    URDF of tests/test_io.py; beside them jax_reference_io2.npz, what JAX's
    loaders return for each file (the USD files' skeleton states by FK
    too).

    python tools/jax_reference.py [--batch 256] [--configs 2,2b,4,5,5f,6s,catalog,6k,diffik,variants,4x,4ad,skinned,glove,7p,sdf,utility,io,io2]
        [--frames 1024] [--out-6s tools/jax_reference_6s.json]
        [--out-catalog tools/jax_reference_catalog.json] [--out-6k tools/jax_reference_6k.json]
        [--out-diffik tools/jax_reference_diffik.json] [--out-variants tools/jax_reference_variants.json]
        [--out-4x tools/jax_reference_4x.json] [--out-4ad tools/jax_reference_4ad.json]
        [--skinned-batch 256] [--out-skinned tools/jax_reference_skinned.json]
        [--out-glove tools/jax_reference_glove.json] [--out-7p tools/jax_reference_7p.json]
        [--sdf-batch 256] [--out-sdf tools/jax_reference_sdf.json]
        [--utility-batch 256] [--utility-seeds 1 2 3 4] [--out-utility tools/jax_reference_utility.json]
        [--out-io tools/jax_reference_io] [--out-io2 tools/jax_reference_io2]

Runs the JAX package on the CPU only (no part of momentum_tpu_torch); prints
one JSON line per figure.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def fullstack_modules(char):
    """bench.py's four full-stack modules with placeholder targets."""
    from momentum_tpu import errors as jerr
    from momentum_tpu.errors.pose_prior import Mppca

    p, nj = char.num_model_parameters, char.skeleton.num_joints
    pos = jerr.PositionErrorFunction.create(
        np.asarray(char.locators.parent), np.asarray(char.locators.offset),
        np.zeros((char.locators.num_locators, 3)))
    ori = jerr.OrientationErrorFunction.create(
        np.arange(nj, dtype=np.int32), np.tile(np.asarray([0, 0, 0, 1], np.float32), (nj, 1)))
    prior = Mppca.from_components(
        pi=np.asarray([0.6, 0.4]), mu=np.zeros((2, p), np.float32),
        w_list=[np.full((p, 4), 0.01, np.float32)] * 2, sigma2=np.asarray([1.0, 2.0]),
        names=char.parameter_transform.names)
    return (pos, ori, jerr.LimitErrorFunction.create(),
            jerr.PosePriorErrorFunction.create(prior, char.parameter_transform.names))


def config2_frame():
    """bench_suite.py config 2's single frame: the final LM energy."""
    from momentum_tpu.math import skel_state as ss
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    p = char.num_model_parameters
    rng = np.random.default_rng(0)
    gt = jnp.asarray(rng.uniform(-0.3, 0.3, p).astype(np.float32))
    states = char.skeleton_states(gt)
    pos, ori, lim, pp = fullstack_modules(char)
    fn = SkeletonSolverFunction(char, (
        dataclasses.replace(pos, target=char.locators.world_positions(states)),
        dataclasses.replace(ori, target=ss.split(states)[1]), lim, pp))
    x0 = gt + 0.05 * jnp.asarray(rng.normal(0, 1, p).astype(np.float32))
    res = jax.jit(lambda x: solve_ik(fn, x, None, SolverOptions(max_iterations=20),
                                     method="levenberg_marquardt"))(x0)
    return dict(config="2", figure="frame_lm_energy", value=float(res.error))


def config2b(batch):
    """2b on bench.py's full-stack problem (seed 0): GN 2 + 1 against the
    40-iteration LM optimum."""
    from momentum_tpu.math import skel_state as ss
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.testing.workloads import build_fullbody_ik_problem

    char, ef0, targets, x0, states = build_fullbody_ik_problem(batch, seed=0,
                                                               return_states=True)
    q = ss.split(states)[1]
    pos, ori, lim, pp = fullstack_modules(char)
    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)

    def fn_of(tg, qt):
        return SkeletonSolverFunction(char, (dataclasses.replace(pos, target=tg),
                                             dataclasses.replace(ori, target=qt), lim, pp),
                                      prefer_fused=True)

    def marker(tg, params):
        return SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=tg),)).error(params)

    @jax.jit
    def solve(tg, qt, x):
        r1 = solve_ik(fn_of(tg, qt), x, None, dataclasses.replace(opts, max_iterations=2),
                      method="gauss_newton")
        e1 = marker(tg, r1.params)
        _, idx = jax.lax.top_k(jnp.nan_to_num(e1, nan=3e38, posinf=3e38), batch // 2)
        r2 = solve_ik(fn_of(tg[idx], qt[idx]), r1.params[idx], None,
                      dataclasses.replace(opts, max_iterations=1), method="gauss_newton")
        return r1.params.at[idx].set(r2.params), r1.error.at[idx].set(r2.error)

    params, err = solve(targets, q, x0)
    ref = jax.jit(lambda x: solve_ik(fn_of(targets, q), x, None,
                                     dataclasses.replace(opts, max_iterations=40),
                                     method="levenberg_marquardt"))(x0)
    excess = np.asarray(err - ref.error)
    return dict(config="2b", batch=batch, conv_at_1e5=float(np.mean(excess < 1e-5)),
                median_excess_vs_40it=float(np.median(excess)),
                marker_conv_at_1e5=float(np.mean(np.asarray(marker(targets, params)) < 1e-5)))


def config4(batch):
    """Config 4's single frame (LM 20 from zero) and 4b (GN 4 + 2 on the
    worst B/4, seed 1)."""
    from momentum_tpu.character.blend_shape import BlendShape
    from momentum_tpu.character.utility import add_blend_shape_parameters
    from momentum_tpu.errors.vertex import VertexPositionErrorFunction
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions, solve_compacted
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    rng = np.random.default_rng(0)
    v, k = char.mesh.num_vertices, 8
    char = add_blend_shape_parameters(char, BlendShape(
        base_shape=char.mesh.vertices,
        shape_vectors=jnp.asarray(rng.normal(0, 0.01, (k, v, 3)).astype(np.float32))))
    p = char.num_model_parameters
    gt = jnp.asarray(np.concatenate([rng.uniform(-0.2, 0.2, p - k),
                                     rng.uniform(-1, 1, k)]), jnp.float32)
    vid = np.arange(0, v, max(v // 256, 1), dtype=np.int32)
    ef0 = VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)))
    fn0 = SkeletonSolverFunction(char, (ef0,))
    ef = dataclasses.replace(ef0, target=jnp.take(fn0.context(gt).mesh_vertices,
                                                  jnp.asarray(vid), axis=-2))
    res = jax.jit(lambda x: solve_ik(SkeletonSolverFunction(char, (ef,)), x, None,
                                     SolverOptions(max_iterations=20),
                                     method="levenberg_marquardt"))(jnp.zeros(p))
    frame = dict(config="4", figure="frame_lm_energy", value=float(res.error))

    rng_b = np.random.default_rng(1)
    gt_b = jnp.asarray(np.concatenate([rng_b.uniform(-0.2, 0.2, (batch, p - k)),
                                       rng_b.uniform(-1, 1, (batch, k))], axis=-1),
                       jnp.float32)
    targets_b = jnp.take(jax.vmap(fn0.context)(gt_b).mesh_vertices, jnp.asarray(vid), axis=-2)
    x0_b = gt_b + 0.05 * jnp.asarray(rng_b.normal(0, 1, (batch, p)), jnp.float32)
    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)

    def stage(tg, x, it, _lam0):
        return solve_ik(SkeletonSolverFunction(char, (dataclasses.replace(ef, target=tg),)),
                        x, None, dataclasses.replace(opts, max_iterations=it),
                        method="gauss_newton")

    res_b = jax.jit(lambda x: solve_compacted(stage, targets_b, x, capacity=max(1, batch // 4),
                                              k_full=4, r_refine=2))(x0_b)
    sq = np.asarray(jnp.sum((res_b.params - gt_b) ** 2, axis=-1))
    return frame, dict(config="4b", batch=batch, median_param_sq_err=float(np.median(sq)),
                       divergent=int(np.sum(~np.isfinite(sq))),
                       median_energy=float(np.median(np.asarray(res_b.error))))


def config5(frames, fullbody):
    """bench_suite.py config 5 (:378-418): the sequence solve of `frames`
    frames on the 16-joint test rig or the full-body rig (5f)."""
    from momentum_tpu.errors import PositionErrorFunction
    from momentum_tpu.sequence.errors import ModelParametersSequenceErrorFunction
    from momentum_tpu.sequence.solver import solve_sequence
    from momentum_tpu.sequence.solver_function import SequenceSolverFunction
    from momentum_tpu.solver import SolverOptions
    from momentum_tpu.testing.fixtures import create_fullbody_character, create_test_character

    char = create_fullbody_character() if fullbody else create_test_character(16)
    p = char.num_model_parameters
    rng = np.random.default_rng(0)
    gt = jnp.asarray(rng.uniform(-0.2, 0.2, (frames, p)), jnp.float32)
    targets = jax.vmap(char.locators.world_positions)(jax.vmap(char.skeleton_states)(gt))
    ef0 = PositionErrorFunction.create(
        np.asarray(char.locators.parent), np.asarray(char.locators.offset),
        np.zeros((char.locators.num_locators, 3)))
    stacked = jax.vmap(lambda t: dataclasses.replace(ef0, target=t))(targets)
    smooth = ModelParametersSequenceErrorFunction.create(p, weight=0.1)
    universal = np.zeros(p, bool)
    if "scaling" in char.parameter_transform.parameter_sets:
        universal[list(char.parameter_transform.parameter_sets["scaling"])] = True
    fn = SequenceSolverFunction.create(char, frames, universal=universal,
                                       per_frame_errors=(stacked,), sequence_errors=(smooth,))
    pf0, u0 = fn.split(jnp.zeros((frames, p)))
    res = jax.jit(lambda pf, u: solve_sequence(fn, pf, u, SolverOptions(max_iterations=8)))(
        pf0, u0)
    return dict(config="5f" if fullbody else "5", frames=frames, error=float(res.error),
                iterations=int(res.iterations), converged=bool(res.converged))


def tracking_clip_draws(frames, seed, num_params, num_markers):
    """testing/workloads.py::tracking_clip_draws, the same numpy draws in
    the same order: (motion, noise (mm), occluded)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, frames)[:, None]
    amp = rng.uniform(0.05, 0.3, num_params)
    phase = rng.uniform(0.0, 2 * np.pi, num_params)
    motion = amp * np.sin(2 * np.pi * t + phase)
    motion[:, 0] = np.linspace(0.0, 2000.0, frames)
    motion[:, 1] = 0.0
    motion[:, 2] = 900.0 + 20.0 * np.sin(2 * np.pi * t[:, 0])
    motion[:, 6] = 0.1
    noise = rng.normal(0.0, 2.0, (frames, num_markers, 3))
    occluded = rng.random((frames, num_markers)) < 0.05
    return motion.astype(np.float32), noise.astype(np.float32), occluded


def config6s(frames, seed=0):
    """Config 6's five stages (bench_suite.py:459-558) on the synthetic clip."""
    from momentum_tpu.tracking import (
        CalibrationConfig, MarkerSequence, TrackingConfig, calibrate_model, refine_motion,
        track_poses_hierarchical, track_poses_per_frame)
    from momentum_tpu.tracking.cmu import create_cmu_character
    from momentum_tpu.tracking.config import RefineConfig
    from momentum_tpu.tracking.tracker import _match_locators

    char = create_cmu_character()
    p = char.num_model_parameters
    motion, noise, occluded = tracking_clip_draws(frames, seed, p, char.locators.num_locators)
    states = jax.vmap(char.skeleton_states)(jnp.asarray(motion))
    positions = jax.vmap(char.locators.world_positions)(states) + jnp.asarray(noise)
    seq = MarkerSequence(positions=positions, occluded=jnp.asarray(occluded),
                         names=tuple(char.locators.names))
    seed_params = jnp.zeros(p).at[:3].set(jnp.mean(seq.positions[0], axis=0))
    cfg = CalibrationConfig(calib_frames=10, major_iter=2, max_iter=25, regularization=1e-3,
                            method="levenberg_marquardt")
    out = dict(config="6s", frames=frames)
    t0 = time.perf_counter()
    identity, calib_motion = calibrate_model(char, seq, cfg, initial=seed_params)
    out["calibrate_s"] = time.perf_counter() - t0
    cfg_loc = dataclasses.replace(cfg, locators_only=True, major_iter=1)
    _, loc_motion, char2 = calibrate_model(char, seq, cfg_loc, initial=identity)
    li, mi = _match_locators(char2, seq)
    sampled = np.arange(0, frames, max(1, frames // 10))[:10]  # calibrate_model's frames

    def err_mm(c, m, rows=slice(None)):
        wp = jax.vmap(c.locators.world_positions)(jax.vmap(c.skeleton_states)(m))
        pos, occ = np.asarray(seq.positions)[rows], np.asarray(seq.occluded)[rows]
        d = np.linalg.norm(np.asarray(wp[:, li]) - pos[:, mi], axis=-1)[~occ[:, mi]]
        return dict(median_mm=float(np.median(d)), p90_mm=float(np.percentile(d, 90)))

    tcfg = TrackingConfig(max_iter=15, regularization=1e-3, method="levenberg_marquardt")
    out["scale_global"] = float(identity[6])
    out["calibrate"] = err_mm(char, calib_motion, sampled)
    out["locators"] = err_mm(char2, loc_motion, sampled)
    tr = track_poses_per_frame(char2, seq, tcfg, initial=identity)
    out["per_frame"] = dict(err_mm(char2, tr.motion),
                            median_energy=float(np.median(np.asarray(tr.errors))))
    rcfg = RefineConfig(max_iter=10, regularization=1e-3, smoothing=1e-4,
                        method="levenberg_marquardt")
    refined, _ = refine_motion(char2, seq, tr.motion, rcfg)
    out["refine"] = dict(err_mm(char2, refined.motion), energy=float(refined.errors[0]))
    bcfg = dataclasses.replace(tcfg, refine=(10, 5, 64))
    hier = track_poses_hierarchical(char2, seq, bcfg, initial=identity, stride=8)
    out["hierarchical"] = dict(err_mm(char2, hier.motion),
                               median_energy=float(np.median(np.asarray(hier.errors))))
    out["locator_offset_shift_mm"] = float(np.abs(
        np.asarray(char2.locators.offset) - np.asarray(char.locators.offset)).max())
    # the calibration's outputs and the per-frame motion: the inputs of the
    # tracking stages and of the refine
    out["identity"] = np.asarray(identity).tolist()
    out["locator_offsets"] = np.asarray(char2.locators.offset).tolist()
    out["per_frame_motion"] = np.asarray(tr.motion)
    return out


# ---- config C: batched IK over the whole rigid error catalog ----

CATALOG_HEAD, CATALOG_AXES, CATALOG_ENDS, CATALOG_WRISTS, CATALOG_PELVIS = (
    10, (0, 6), (22, 42, 30, 50), (16, 36), 0)


def catalog_recipe():
    """momentum_tpu_torch/testing/workloads.py::catalog_recipe, the same
    numbers (tests/test_torch_port_catalog.py holds the two equal)."""
    def rz(angle):
        return [0.0, 0.0, np.sin(angle / 2), np.cos(angle / 2)]

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
        linear=[(43, 40, 0.5, 0.0, -big, big, 1.0)],
        linear_joint=[(33 * 7 + 3, 32 * 7 + 3, 0.5, 0.0, -big, big, 1.0)],
        halfplane=[(76, 79, 0.6, 0.8, -0.1, 1.0)],
        ellipsoid=[(16, 6, np.zeros(3, np.float32), ell, 1.0)],
        floor_normal=(0.0, 1.0, 0.0), floor_offset=-1.35,
        distance_origin=np.asarray([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0], [0.0, -2.0, 1.0],
                                    [0.0, -2.0, -1.0]], np.float32),
        weights=dict(camera=1e-6, projection=1e-6, state=1e-2))


def catalog_draws(batch, seed, num_params, noise=0.05):
    """workloads.py::catalog_draws: truths and warm starts from two generators."""
    truth = np.random.default_rng(seed).uniform(-0.3, 0.3, (batch, num_params))
    x0 = truth + np.random.default_rng(seed + 1).normal(0.0, noise, (batch, num_params))
    return truth.astype(np.float32), x0.astype(np.float32)


def recipe_cameras(r):
    from momentum_tpu.camera import (
        Camera, OpenCVFisheyeIntrinsics, OpenCVIntrinsics, PinholeIntrinsics)

    cams = []
    for c in r["cameras"]:
        args = (c["fx"], c["fy"], c["cx"], c["cy"])
        if c["kind"] == "opencv":
            intr = OpenCVIntrinsics.create(*args, k=c["k"], p=c["p"], image_size=r["image_size"])
        elif c["kind"] == "fisheye":
            intr = OpenCVFisheyeIntrinsics.create(*args, k=c["k"], image_size=r["image_size"])
        else:
            intr = PinholeIntrinsics.create(*args, image_size=r["image_size"])
        cams.append(Camera.create(intr).look_at(c["position"], r["camera_target"],
                                                r["camera_up"]))
    return cams


def catalog_character():
    from momentum_tpu.character.character import CollisionGeometry
    from momentum_tpu.character.limits import concat_limits, make_limits
    from momentum_tpu.testing.fixtures import create_fullbody_character

    r = catalog_recipe()
    char = create_fullbody_character()
    extra = make_limits(linear=r["linear"], linear_joint=r["linear_joint"],
                        halfplane=r["halfplane"], ellipsoid=r["ellipsoid"])
    col = CollisionGeometry(**{k: jnp.asarray(r[f"capsule_{k}"])
                               for k in ("parent", "transform", "radius", "length")})
    return dataclasses.replace(char, limits=concat_limits(char.limits, extra), collision=col)


def catalog_modules(char):
    """(labels, make(states) -> modules): config C's modules and each one's
    label (a label may repeat: the energies of its modules add), their targets
    from one element's truth states (nJ, 8), as workloads.py's
    build_catalog_ik_problem builds them."""
    from momentum_tpu import errors as E
    from momentum_tpu.math import quaternion as quat, skel_state as ss

    r = catalog_recipe()
    w = r["weights"]
    cams = recipe_cameras(r)
    loc = char.locators
    parent, offset = np.asarray(loc.parent), np.asarray(loc.offset)
    n_loc = loc.num_locators
    z3 = np.zeros((1, 3), np.float32)
    fwd = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    up = np.asarray([[0.0, 1.0, 0.0]] * 2, np.float32)
    n_end, n_w = len(CATALOG_ENDS), len(CATALOG_WRISTS)
    z_end, z_w = np.zeros((n_end, 3), np.float32), np.zeros((n_w, 3), np.float32)
    pair = (list(CATALOG_WRISTS), [CATALOG_PELVIS] * n_w)
    proj = cams[2].projection_matrix()
    t = dict(
        position=E.PositionErrorFunction.create(parent, offset, np.zeros((n_loc, 3))),
        camera_opencv=E.CameraProjectionErrorFunction.create(
            cams[0], parent, offset, np.zeros((n_loc, 2)), weight=w["camera"]),
        camera_fisheye=E.CameraProjectionErrorFunction.create(
            cams[1], parent, offset, np.zeros((n_loc, 2)), weight=w["camera"]),
        projection=E.ProjectionErrorFunction.create(
            parent, offset, np.broadcast_to(np.asarray(proj), (n_loc, 3, 4)),
            np.zeros((n_loc, 2)), weight=w["projection"]),
        aim_dir=E.AimDirErrorFunction.create([CATALOG_HEAD], z3, fwd, z3),
        aim_dist=E.AimDistErrorFunction.create([CATALOG_HEAD], z3, fwd, z3),
        fixed_axis_diff=E.FixedAxisDiffErrorFunction.create(list(CATALOG_AXES), up, up),
        fixed_axis_cos=E.FixedAxisCosErrorFunction.create(list(CATALOG_AXES), up, up),
        fixed_axis_angle=E.FixedAxisAngleErrorFunction.create(list(CATALOG_AXES), up, up),
        normal=E.NormalErrorFunction.create(list(CATALOG_ENDS), z_end,
                                            np.tile([[0.0, 1.0, 0.0]], (n_end, 1)), z_end),
        distance=E.DistanceErrorFunction.create(list(CATALOG_ENDS), z_end,
                                                r["distance_origin"], np.zeros(n_end)),
        j2j_position=E.JointToJointPositionErrorFunction.create(*pair, z_w, z_w, z_w),
        j2j_distance=E.JointToJointDistanceErrorFunction.create(*pair, z_w, z_w,
                                                                np.zeros(n_w)),
        # one module per wrist: JAX's JointToJointOrientation Jacobian holds
        # for one constraint only (ROADMAP F16); the port's module takes both
        j2j_orientation=E.JointToJointOrientationErrorFunction.create(
            [CATALOG_WRISTS[0]], [CATALOG_PELVIS], np.asarray([[0.0, 0.0, 0.0, 1.0]])),
        state=E.StateErrorFunction.create(np.asarray(char.bind_pose()), weight=w["state"]),
        limits=E.LimitErrorFunction.create(),
        collision=E.CollisionErrorFunction.create(char),
        plane_collision=E.PlaneCollisionErrorFunction.create(char, r["floor_normal"],
                                                             r["floor_offset"]))
    rep = dataclasses.replace
    origin = jnp.asarray(r["distance_origin"])

    def make(states):
        world = loc.world_positions(states)
        q = world @ proj[:, :3].T + proj[:, 3]
        head = states[jnp.asarray([CATALOG_HEAD])]
        aim = ss.transform_points(head, z3) + 0.5 * ss.rotate_vectors(head, fwd)
        axes = ss.rotate_vectors(states[jnp.asarray(CATALOG_AXES)], up)
        ends = states[jnp.asarray(CATALOG_ENDS)]
        src, ref = states[jnp.asarray(pair[0])], states[jnp.asarray(pair[1])]
        diff = src[..., :3] - ref[..., :3]
        q_ref_inv = quat.conjugate(ref[..., 3:7])
        return (
            rep(t["position"], target=world),
            rep(t["camera_opencv"], target=cams[0].project(world)[0][..., :2]),
            rep(t["camera_fisheye"], target=cams[1].project(world)[0][..., :2]),
            rep(t["projection"], target=q[..., :2] / q[..., 2:3]),
            rep(t["aim_dir"], target=aim), rep(t["aim_dist"], target=aim),
            rep(t["fixed_axis_diff"], global_axis=axes),
            rep(t["fixed_axis_cos"], global_axis=axes),
            rep(t["fixed_axis_angle"], global_axis=axes),
            E.UnionErrorFunction(children=(
                rep(t["normal"], global_point=ends[..., :3]),
                rep(t["distance"], target=jnp.linalg.norm(ends[..., :3] - origin, axis=-1)))),
            rep(t["j2j_position"], target=quat.rotate_vector(q_ref_inv, diff)),
            rep(t["j2j_distance"], target=jnp.linalg.norm(diff, axis=-1)),
            *(dataclasses.replace(t["j2j_orientation"], source=jnp.asarray([w_], jnp.int32),
                                  target=quat.multiply(q_ref_inv, src[..., 3:7])[i:i + 1])
              for i, w_ in enumerate(CATALOG_WRISTS)),
            rep(t["state"], target_state=states), t["limits"], t["collision"],
            t["plane_collision"])

    labels = ("position", "camera_opencv", "camera_fisheye", "projection", "aim_dir",
              "aim_dist", "fixed_axis_diff", "fixed_axis_cos", "fixed_axis_angle",
              "union_normal_distance", "j2j_position", "j2j_distance", "j2j_orientation",
              "j2j_orientation", "state", "limits", "collision", "plane_collision")
    return labels, make


def catalog(batch, seed=0, iterations=10, more=20):
    """Config C at B = `batch`: solve_ik's LM (regularization 1e-5) for
    `iterations` iterations, then `more` from its result; per module the
    median final energy, conv_at_1e5 (the fraction whose energy after
    `iterations` is within 1e-5 of its energy after `more` further ones) and
    the divergent count. Each element is one vmapped solve: JAX's
    ProjectionErrorFunction.jacobian holds only unbatched (ROADMAP F15)."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik

    char = catalog_character()
    labels, make = catalog_modules(char)
    truth, x0 = catalog_draws(batch, seed, char.num_model_parameters)
    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(truth))

    def one(st, x):
        efs = make(st)
        fn = SkeletonSolverFunction(char, efs)
        opts = SolverOptions(max_iterations=iterations, regularization=1e-5)
        res = solve_ik(fn, x, None, opts, method="levenberg_marquardt")
        res2 = solve_ik(fn, res.params, None, dataclasses.replace(opts, max_iterations=more),
                        method="levenberg_marquardt")
        ctx = fn.context(res.params)
        per = jnp.stack([ef.error(char, ctx) for ef in efs])
        return per, fn.error(res2.params)

    t0 = time.perf_counter()
    per, longer = jax.jit(jax.vmap(one))(states, jnp.asarray(x0))
    per, longer = np.asarray(per, np.float64), np.asarray(longer, np.float64)
    total = per.sum(axis=1)
    finite = np.isfinite(total)
    by_label = {}
    for i, lab in enumerate(labels):
        by_label[lab] = by_label.get(lab, 0.0) + per[:, i]
    med = {lab: float(np.median(v)) for lab, v in by_label.items()}
    med["total"] = float(np.median(total))
    return dict(config="catalog", batch=batch, iterations=iterations, more=more,
                median_energy=med, conv_at_1e5=float(np.mean(finite & (total - longer <= 1e-5))),
                divergent=int(np.sum(~finite)), seconds=time.perf_counter() - t0)


# ---- config 6k: config 6s's clip with 2D keypoints from four cameras ----

KEYPOINT_PROJECTION_WEIGHT = 1.5


def keypoint_recipe():
    """momentum_tpu_torch/testing/workloads.py::keypoint_recipe, the same numbers."""
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


def keypoint_draws(frames, seed, num_cameras, num_locators):
    """workloads.py::keypoint_draws: pixel noise and the unobserved mask."""
    rng = np.random.default_rng(seed + 2)
    noise = rng.normal(0.0, 1.0, (num_cameras, frames, num_locators, 2))
    return noise.astype(np.float32), rng.random((num_cameras, frames, num_locators)) < 0.05


def config6k(frames, seed=0, reference_file=None):
    """Config 6k: config 6s's clip and, from JAX CPU's config 6s calibration
    (tools/jax_reference_6s.json: the identity and locator offsets),
    track_poses_batched of every frame with markers and the four cameras'
    keypoints (LM 15, projection weight 1.5), then refine_motion of JAX CPU's
    config 6s per-frame motion with them (LM 10, smoothing 1e-4): per stage
    the median and p90 marker error (mm) and the median reprojection error
    (px) over the observed keypoints."""
    from momentum_tpu.tracking import MarkerSequence, TrackingConfig, refine_motion
    from momentum_tpu.tracking import track_poses_batched
    from momentum_tpu.tracking.cmu import create_cmu_character
    from momentum_tpu.tracking.config import RefineConfig
    from momentum_tpu.tracking.tracker import CameraKeypointData, _match_locators

    here = os.path.dirname(os.path.abspath(__file__))
    with open(reference_file or os.path.join(here, "jax_reference_6s.json")) as f:
        ref6s = json.load(f)
    per_frame_motion = jnp.asarray(np.load(os.path.join(here, "jax_reference_6s_per_frame.npy")))
    char = create_cmu_character()
    p = char.num_model_parameters
    motion, noise, occluded = tracking_clip_draws(frames, seed, p, char.locators.num_locators)
    states = jax.vmap(char.skeleton_states)(jnp.asarray(motion))
    world = jax.vmap(char.locators.world_positions)(states)
    seq = MarkerSequence(positions=world + jnp.asarray(noise), occluded=jnp.asarray(occluded),
                         names=tuple(char.locators.names))
    r = keypoint_recipe()
    cams = recipe_cameras(r)
    kp_noise, unobserved = keypoint_draws(frames, seed, len(cams), world.shape[1])
    w, h = r["image_size"]
    kps = []
    for c, cam in enumerate(cams):
        uvz, valid = cam.project(world)
        u, v = uvz[..., 0], uvz[..., 1]
        seen = (valid & (uvz[..., 2] >= 0.01) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
                & ~jnp.asarray(unobserved[c]))
        kps.append(CameraKeypointData(camera=cam, targets=uvz[..., :2] + kp_noise[c],
                                      confidence=seen.astype(jnp.float32)))
    rig = dataclasses.replace(char, locators=dataclasses.replace(
        char.locators, offset=jnp.asarray(ref6s["locator_offsets"], jnp.float32)))
    identity = jnp.asarray(ref6s["identity"], jnp.float32)
    li, mi = _match_locators(rig, seq)

    def figures(m):
        wp = np.asarray(jax.vmap(rig.locators.world_positions)(jax.vmap(rig.skeleton_states)(m)))
        pos, occ = np.asarray(seq.positions), np.asarray(seq.occluded)
        d = np.linalg.norm(wp[:, li] - pos[:, mi], axis=-1)[~occ[:, mi]]
        px = []
        for kp in kps:
            uv = np.asarray(kp.camera.project(jnp.asarray(wp))[0][..., :2])
            e = np.linalg.norm(uv - np.asarray(kp.targets), axis=-1)
            px.append(e[np.asarray(kp.confidence) > 0])
        return dict(median_mm=float(np.median(d)), p90_mm=float(np.percentile(d, 90)),
                    median_px=float(np.median(np.concatenate(px))))

    lm = "levenberg_marquardt"
    tcfg = TrackingConfig(max_iter=15, regularization=1e-3, method=lm,
                          projection_weight=KEYPOINT_PROJECTION_WEIGHT)
    out = dict(config="6k", frames=frames, projection_weight=KEYPOINT_PROJECTION_WEIGHT,
               observed=[float(np.mean(np.asarray(kp.confidence))) for kp in kps])
    t0 = time.perf_counter()
    tr = jax.jit(lambda m: track_poses_batched(rig, m, tcfg, initial=identity,
                                               camera_keypoints=tuple(kps)))(seq)
    out["batched"] = dict(figures(tr.motion), seconds=time.perf_counter() - t0)
    rcfg = RefineConfig(max_iter=10, regularization=1e-3, smoothing=1e-4, method=lm,
                        projection_weight=KEYPOINT_PROJECTION_WEIGHT)
    t0 = time.perf_counter()
    refined, _ = refine_motion(rig, seq, per_frame_motion, rcfg, camera_keypoints=tuple(kps))
    out["refine"] = dict(figures(refined.motion), seconds=time.perf_counter() - t0)
    return out


# ---- config D: differentiable IK; the solver variants on its problem ----


def diffik_problem(batch, seed=0):
    """workloads.py::build_diff_ik_problem: (char, ef0, prior, targets, x0,
    mask, w)."""
    from momentum_tpu.errors import ModelParametersErrorFunction, PositionErrorFunction
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    p = char.num_model_parameters
    truth, x0 = catalog_draws(batch, seed, p)
    targets = jax.jit(jax.vmap(lambda t: char.locators.world_positions(
        char.skeleton_states(t))))(jnp.asarray(truth))
    ef0 = PositionErrorFunction.create(np.asarray(char.locators.parent),
                                       np.asarray(char.locators.offset),
                                       np.zeros((char.locators.num_locators, 3)))
    prior = ModelParametersErrorFunction.create(np.zeros(p), weight=1e-3)
    mask = np.ones(p, np.float32)
    mask[char.parameter_transform.names.index("scale_global")] = 0.0
    w = np.random.default_rng(seed + 2).normal(0.0, 1.0, (batch, p)).astype(np.float32)
    return char, ef0, prior, targets, jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(w)


def diffik(batch, seed=0):
    """Config D: per element, θ* of GN 20 (regularization 1e-6) by
    solve_ik_ift and the gradients of Σ w·θ* to the element's targets and
    constraint weights; the energy and gradient rmse at θ*. Returns the
    figures and the per-element arrays."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.diff_ik import gradient_rmse, solve_ik_ift

    char, ef0, prior, targets, x0, mask, w = diffik_problem(batch, seed)
    opts = SolverOptions(max_iterations=20, regularization=1e-6)
    cweight = jnp.ones(targets.shape[:2], jnp.float32)

    def fn_of(tg, cw):
        return SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=tg, cweight=cw),
                                             prior))

    def one(tg, cw, x, wi):
        def loss(tg, cw):
            theta = solve_ik_ift(fn_of(tg, cw), x, mask, opts)
            return jnp.sum(wi * theta), theta

        (_, theta), (g_t, g_c) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(tg, cw)
        return theta, g_t, g_c

    def at_optimum(tg, cw, theta):
        fn = fn_of(tg, cw)
        return fn.error(theta), gradient_rmse(fn, theta, mask)

    t0 = time.perf_counter()
    theta, g_t, g_c = jax.jit(jax.vmap(one))(targets, cweight, x0, w)
    energy, rmse = jax.jit(jax.vmap(at_optimum))(targets, cweight, theta)
    arrays = dict(energy=np.asarray(energy), gradient_rmse=np.asarray(rmse),
                  grad_targets=np.asarray(g_t), grad_cweight=np.asarray(g_c),
                  theta=np.asarray(theta))
    fig = dict(config="diffik", batch=batch, iterations=opts.max_iterations,
               median_energy=float(np.median(arrays["energy"])),
               median_gradient_rmse=float(np.median(arrays["gradient_rmse"])),
               divergent=int(np.sum(~np.isfinite(arrays["energy"]))),
               seconds=time.perf_counter() - t0)
    return fig, arrays


def variant_recipe():
    """momentum_tpu_torch/testing/workloads.py::variant_recipe, the same
    numbers (tests/test_torch_port_solvers.py holds the two equal)."""
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


def variants(batch, seed=0):
    """Each solver variant on config D's position module alone, batch-native
    from config D's warm starts: the median final energy (the energy at the
    returned parameters), the divergent count and the wall."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions, solvers

    char, ef0, _, targets, x0, _, _ = diffik_problem(batch, seed)
    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    out = dict(config="variants", batch=batch)
    for name, (cls, opts, kw) in variant_recipe().items():
        t0 = time.perf_counter()
        solver = getattr(solvers, cls)(fn, SolverOptions(**opts), **kw)
        params = solver.solve(x0)
        e = np.asarray(fn.error(params), np.float64)
        out[name] = dict(median_energy=float(np.median(e)),
                         divergent=int(np.sum(~np.isfinite(e))),
                         seconds=time.perf_counter() - t0)
        if solver.error_history is not None:
            out[name]["history_shapes"] = [list(solver.error_history.shape),
                                           list(solver.parameter_history.shape)]
    return out


# ---- config 4x: config 4b with the three forward-mode vertex modules ----


def vertex_extra_recipe(num_vertices, faces):
    """momentum_tpu_torch/testing/workloads.py::vertex_extra_recipe, the same numbers."""
    tri = faces[::38][:16]
    src = faces[3::38][:16, 2]
    v1 = np.arange(0, num_vertices // 2, 17)
    return dict(src_vertex=src, tri_vertices=tri, bary=np.full((len(tri), 3), 1.0 / 3.0),
                vertex1=v1, vertex2=(v1 + num_vertices // 2) % num_vertices,
                camera_vertex=np.arange(0, num_vertices, 8),
                weights=dict(point_triangle=0.1, distance=1.0, camera=1e-6))


def config4x(batch, held=64):
    """Config 4x: config 4b's problem (seed 1) plus the recipe's
    point-triangle, vertex-distance and camera-vertex projection modules,
    their targets from each element's truth; GN 4 + 2 on the worst B/4
    (solve_ik's GN at regularization 1e-5 on Σ rows², the Jacobian by forward
    mode): each module's median final energy on the first `held` elements and
    on all, and the divergent count."""
    from momentum_tpu import errors as E
    from momentum_tpu.character.blend_shape import BlendShape
    from momentum_tpu.character.utility import add_blend_shape_parameters
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions, solve_compacted
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    rng = np.random.default_rng(0)
    v, k = char.mesh.num_vertices, 8
    char = add_blend_shape_parameters(char, BlendShape(
        base_shape=char.mesh.vertices,
        shape_vectors=jnp.asarray(rng.normal(0, 0.01, (k, v, 3)).astype(np.float32))))
    p = char.num_model_parameters
    rng.uniform(-0.2, 0.2, p - k), rng.uniform(-1, 1, k)  # config 4's frame draws
    vid = np.arange(0, v, max(v // 256, 1), dtype=np.int32)
    ef0 = E.VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)))
    fn0 = SkeletonSolverFunction(char, (ef0,))
    rng_b = np.random.default_rng(1)
    gt_b = jnp.asarray(np.concatenate([rng_b.uniform(-0.2, 0.2, (batch, p - k)),
                                       rng_b.uniform(-1, 1, (batch, k))], axis=-1), jnp.float32)
    x0_b = gt_b + 0.05 * jnp.asarray(rng_b.normal(0, 1, (batch, p)), jnp.float32)
    verts = jax.jit(jax.vmap(lambda g: fn0.context(g).mesh_vertices))(gt_b)
    r = vertex_extra_recipe(v, np.asarray(char.mesh.faces))
    w = r["weights"]
    cam = recipe_cameras(catalog_recipe())[0]
    v1, v2 = jnp.asarray(r["vertex1"]), jnp.asarray(r["vertex2"])
    seen = verts[:, jnp.asarray(r["camera_vertex"])]
    n_cam = len(r["camera_vertex"])
    pt = E.PointTriangleVertexErrorFunction.create(r["src_vertex"], r["tri_vertices"],
                                                   r["bary"], weight=w["point_triangle"])
    dist0 = E.VertexVertexDistanceErrorFunction.create(
        r["vertex1"], r["vertex2"], np.zeros(len(r["vertex1"])), weight=w["distance"])
    cam0 = E.CameraVertexProjectionErrorFunction.create(
        cam, r["camera_vertex"], np.zeros((n_cam, 2)), weight=w["camera"])
    tables = (verts[:, jnp.asarray(vid)],
              jnp.linalg.norm(verts[:, v1] - verts[:, v2] + 1e-20, axis=-1),
              cam.project(seen)[0][..., :2])

    def modules(tg, dist, px):
        return (dataclasses.replace(ef0, target=tg), pt,
                dataclasses.replace(dist0, target=dist), dataclasses.replace(cam0, target=px))

    opts = SolverOptions(regularization=1e-5, energy_from_residual=True)

    def stage(tabs, x, it, _lam0):
        return solve_ik(SkeletonSolverFunction(char, modules(*tabs)), x, None,
                        dataclasses.replace(opts, max_iterations=it), method="gauss_newton")

    t0 = time.perf_counter()
    res = jax.jit(lambda x: solve_compacted(stage, tables, x, capacity=max(1, batch // 4),
                                            k_full=4, r_refine=2))(x0_b)
    fn = SkeletonSolverFunction(char, modules(*tables))
    ctx = jax.jit(fn.context)(res.params)
    labels = ("vertex_position", "point_triangle", "vertex_distance", "camera_vertex")
    per = {lab: np.asarray(ef.error(char, ctx), np.float64)
           for lab, ef in zip(labels, fn.error_functions)}
    total = sum(per.values())
    return dict(config="4x", batch=batch, held=held,
                median_energy={lab: float(np.median(e[:held])) for lab, e in per.items()},
                median_energy_all={lab: float(np.median(e)) for lab, e in per.items()},
                divergent=int(np.sum(~np.isfinite(total))), seconds=time.perf_counter() - t0)


# ---- config 4ad: config 4b's forward-mode A/B (bench_suite.py:370-375) ----


def config4ad(batch, chunk=32):
    """Config 4b's problem (seed 1) solved by solve_ik's GN 6 on the whole
    batch with SkeletonSolverFunction(..., force_ad=True), bench_suite.py's
    A/B: median_param_sq_err and the divergent count. The batch goes through
    in chunks of `chunk` elements (GN freezes each element once it
    converges, so a chunk's results are the whole batch's): the forward-mode
    Jacobian through the skinning would hold ~10 GB at once on the CPU."""
    from momentum_tpu.character.blend_shape import BlendShape
    from momentum_tpu.character.utility import add_blend_shape_parameters
    from momentum_tpu.errors.vertex import VertexPositionErrorFunction
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    rng = np.random.default_rng(0)
    v, k = char.mesh.num_vertices, 8
    char = add_blend_shape_parameters(char, BlendShape(
        base_shape=char.mesh.vertices,
        shape_vectors=jnp.asarray(rng.normal(0, 0.01, (k, v, 3)).astype(np.float32))))
    p = char.num_model_parameters
    rng.uniform(-0.2, 0.2, p - k), rng.uniform(-1, 1, k)  # config 4's frame draws
    vid = np.arange(0, v, max(v // 256, 1), dtype=np.int32)
    ef0 = VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)))
    fn0 = SkeletonSolverFunction(char, (ef0,))
    rng_b = np.random.default_rng(1)
    gt_b = jnp.asarray(np.concatenate([rng_b.uniform(-0.2, 0.2, (batch, p - k)),
                                       rng_b.uniform(-1, 1, (batch, k))], axis=-1), jnp.float32)
    x0_b = gt_b + 0.05 * jnp.asarray(rng_b.normal(0, 1, (batch, p)), jnp.float32)
    targets = jnp.take(jax.jit(jax.vmap(lambda g: fn0.context(g).mesh_vertices))(gt_b),
                       jnp.asarray(vid), axis=-2)
    opts = SolverOptions(max_iterations=6, regularization=1e-5, energy_from_residual=True)
    solve = jax.jit(lambda tg, x: solve_ik(
        SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=tg),), force_ad=True),
        x, None, opts, method="gauss_newton").params)
    t0 = time.perf_counter()
    params = jnp.concatenate([solve(targets[i:i + chunk], x0_b[i:i + chunk])
                              for i in range(0, batch, chunk)])
    sq = np.asarray(jnp.sum((params - gt_b) ** 2, axis=-1))
    return dict(config="4ad", batch=batch, median_param_sq_err=float(np.median(sq)),
                divergent=int(np.sum(~np.isfinite(sq))), seconds=time.perf_counter() - t0)


# ---- config SL: skinned-locator IK ----

SKINNED_TRIANGLE_ROWS = tuple(range(0, 80, 5))
SKINNED_CANDIDATES = 4
SKINNED_TRIANGLE_WEIGHT = 0.1


def skinned_triangle_recipe(vertices, faces, hits):
    """workloads.py::skinned_triangle_recipe, the same numbers."""
    centroids = vertices.astype(np.float64)[faces].mean(axis=1)
    tri = np.asarray([h[0] for h in hits])
    points = np.stack([h[2] for h in hits]).astype(np.float64)
    d2 = ((centroids[None] - points[:, None]) ** 2).sum(-1)
    return dict(tri_indices=faces[tri], bary=np.stack([h[1] for h in hits]),
                candidates=np.argsort(d2, axis=1, kind="stable")[:, :SKINNED_CANDIDATES],
                weight=SKINNED_TRIANGLE_WEIGHT)


def skinned_problem(batch, seed=0):
    """(character, (position module, triangle module, limits), truth, x0,
    targets (B, 80, 3), the recipe) of config SL, as
    workloads.py::build_skinned_ik_problem builds it."""
    from momentum_tpu import errors as E
    from momentum_tpu.math import skel_state as ss
    from momentum_tpu.testing.fixtures import create_fullbody_character
    from momentum_tpu.tracking.tracker_utils import (
        closest_point_on_mesh_matching_parent, locators_to_skinned_locators)

    base = create_fullbody_character()
    loc = base.locators
    rows = list(SKINNED_TRIANGLE_ROWS)
    world = np.asarray(ss.transform_points(jnp.take(base.bind_pose(), loc.parent, axis=0),
                                           loc.offset))
    parents = np.asarray(loc.parent)
    hits = [closest_point_on_mesh_matching_parent(base, world[i], int(parents[i]))
            for i in rows]
    char = locators_to_skinned_locators(base)
    sl = char.skinned_locators
    faces = np.asarray(base.mesh.faces)
    r = skinned_triangle_recipe(np.asarray(base.mesh.vertices), faces, hits)
    truth, x0 = catalog_draws(batch, seed, char.num_model_parameters)
    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(truth))
    targets = jax.jit(jax.vmap(lambda st: sl.world_positions(char, st)))(states)
    sl_np = [np.asarray(a) for a in (sl.parents, sl.skin_weights, sl.rest_position)]
    position = E.SkinnedLocatorErrorFunction.create(*sl_np, np.zeros((sl.num_locators, 3)))
    triangle = E.SkinnedLocatorTriangleErrorFunction.create(
        *(a[rows] for a in sl_np), r["tri_indices"], r["bary"], weight=r["weight"],
        candidates=r["candidates"], faces=faces)
    return (char, (position, triangle, E.LimitErrorFunction.create()), truth, x0, targets, r)


def skinned(batch, seed=0, iterations=10, more=20, chunk=32, frames=32):
    """Config SL at B = `batch`: solve_ik's LM (regularization 1e-5) for
    `iterations` iterations, then `more` from its result, each element one
    vmapped solve, `chunk` elements a call (the forward-mode Jacobian through
    the skinning holds ~1 GB for 32); per module the median final energy,
    conv_at_1e5 and the divergent count; get_locator_error of the first
    `frames` elements' solves against their targets; the skinned-locator
    tables and the triangle recipe."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik
    from momentum_tpu.tracking import MarkerSequence, get_locator_error

    char, (position, triangle, limits), truth, x0, targets, r = skinned_problem(batch, seed)
    labels = ("skinned_locator", "skinned_locator_triangle", "limits")

    def one(tgt, x):
        efs = (dataclasses.replace(position, target=tgt), triangle, limits)
        fn = SkeletonSolverFunction(char, efs)
        opts = SolverOptions(max_iterations=iterations, regularization=1e-5)
        res = solve_ik(fn, x, None, opts, method="levenberg_marquardt")
        res2 = solve_ik(fn, res.params, None, dataclasses.replace(opts, max_iterations=more),
                        method="levenberg_marquardt")
        ctx = fn.context(res.params)
        return res.params, jnp.stack([ef.error(char, ctx) for ef in efs]), fn.error(res2.params)

    t0 = time.perf_counter()
    run = jax.jit(jax.vmap(one))
    outs = [run(targets[i:i + chunk], jnp.asarray(x0[i:i + chunk]))
            for i in range(0, batch, chunk)]
    params, per, longer = (np.concatenate([np.asarray(o[j]) for o in outs]) for j in range(3))
    per, longer = per.astype(np.float64), longer.astype(np.float64)
    total = per.sum(axis=1)
    finite = np.isfinite(total)
    med = {lab: float(np.median(per[:, i])) for i, lab in enumerate(labels)}
    med["total"] = float(np.median(total))
    ms = MarkerSequence(positions=targets[:frames],
                        occluded=jnp.zeros((frames, targets.shape[1]), bool),
                        names=char.skinned_locators.names)
    avg, mx = get_locator_error(char, ms, jnp.asarray(params[:frames]))
    sl = char.skinned_locators
    return dict(config="skinned", batch=batch, iterations=iterations, more=more,
                median_energy=med, conv_at_1e5=float(np.mean(finite & (total - longer <= 1e-5))),
                divergent=int(np.sum(~finite)), locator_error=dict(frames=frames, average=avg,
                                                                    max=mx),
                tables=dict(parents=np.asarray(sl.parents).tolist(),
                            skin_weights=np.asarray(sl.skin_weights).tolist(),
                            rest_position=np.asarray(sl.rest_position).tolist(),
                            names=list(sl.names), tri_indices=r["tri_indices"].tolist(),
                            candidates=r["candidates"].tolist()),
                seconds=time.perf_counter() - t0)


# ---- config G: glove-fused tracking ----

GLOVE_WRISTS = ("l_arm3", "r_arm3")
GLOVE_FINGERS = (tuple(f"l_hand{i}" for i in range(7)), tuple(f"r_hand{i}" for i in range(7)))
GLOVE_OFFSETS = ((0.03, -0.01, 0.02, 0.1, -0.05, 0.2), (-0.03, 0.01, 0.02, -0.1, 0.05, -0.2))


def glove_clip_draws(frames, seed, num_params, num_markers, num_fingers=7):
    """workloads.py::glove_clip_draws, the same numpy draws in the same order."""
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
               marker_noise=rng.normal(0.0, 0.002, (frames, num_markers, 3)),
               occluded=rng.random((frames, num_markers)) < 0.05,
               init_noise=rng.normal(0.0, 0.02, (frames, num_params)))
    for h in range(2):
        out[f"position_noise{h}"] = rng.normal(0.0, 0.002, (frames, num_fingers, 3))
        out[f"rotation_noise{h}"] = rng.normal(0.0, np.deg2rad(1.0), (frames, num_fingers, 3))
        out[f"invalid{h}"] = rng.random((frames, num_fingers)) < 0.05
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}


def quaternion_noise(q, axis_angle):
    """workloads.py::quaternion_noise: q ∘ exp(axis_angle) in numpy."""
    aa = axis_angle.astype(np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(angle, 1e-12)
    r = np.concatenate([axis * np.sin(angle / 2), np.cos(angle / 2)], axis=-1)
    q = q.astype(np.float64)
    v1, w1, v2, w2 = q[..., :3], q[..., 3:], r[..., :3], r[..., 3:]
    out = np.concatenate([w1 * v2 + w2 * v1 + np.cross(v1, v2),
                          w1 * w2 - np.sum(v1 * v2, axis=-1, keepdims=True)], axis=-1)
    return out.astype(np.float32)


def glove_clip(frames, seed=0):
    """(character, GloveConfig, MarkerSequence, ((GloveSequence, hand), ...),
    initial motion) of config G, as workloads.py::build_glove_clip builds
    them, the markers and glove samples by JAX's FK."""
    from momentum_tpu.math import quaternion as quat
    from momentum_tpu.testing.fixtures import create_fullbody_character
    from momentum_tpu.tracking import MarkerSequence
    from momentum_tpu.tracking.glove_utils import (
        GloveConfig, GloveOffset, GloveSequence, add_glove_bones,
        add_glove_calibration_parameters)

    cfg = GloveConfig(wrist_joint_names=GLOVE_WRISTS)
    offsets = tuple(GloveOffset(translation=np.asarray(o[:3], np.float32),
                                rotation_euler_xyz=np.asarray(o[3:], np.float32))
                    for o in GLOVE_OFFSETS)
    char = add_glove_calibration_parameters(
        add_glove_bones(create_fullbody_character(), cfg, offsets), cfg)
    d = glove_clip_draws(frames, seed, char.num_model_parameters, char.locators.num_locators)
    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(d["motion"]))
    markers = MarkerSequence(
        positions=jax.vmap(char.locators.world_positions)(states) + jnp.asarray(d["marker_noise"]),
        occluded=jnp.asarray(d["occluded"]), names=tuple(char.locators.names))
    names = char.skeleton.joint_names
    gloves = []
    for h in range(2):
        bone = names.index("glove_" + GLOVE_WRISTS[h])
        ji = np.asarray([names.index(n) for n in GLOVE_FINGERS[h]], np.int32)
        ref, src = states[:, bone:bone + 1], states[:, ji]
        q_inv = quat.conjugate(ref[..., 3:7])
        pos = np.asarray(quat.rotate_vector(q_inv, src[..., :3] - ref[..., :3]))
        ori = np.asarray(quat.multiply(q_inv, src[..., 3:7]))
        gloves.append((GloveSequence(joint_index=ji, positions=pos + d[f"position_noise{h}"],
                                     orientations=quaternion_noise(ori, d[f"rotation_noise{h}"]),
                                     valid=~d[f"invalid{h}"]), h))
    return char, cfg, markers, tuple(gloves), jnp.asarray(d["motion"] + d["init_noise"])


def split_gloves(gloves):
    """One (GloveSequence, hand) per finger joint: JAX's track_sequence
    holds only one orientation constraint per module at P ≥ 64 (ROADMAP
    F21); the energy is the same sum."""
    from momentum_tpu.tracking.glove_utils import GloveSequence

    return tuple((GloveSequence(joint_index=g.joint_index[s:s + 1],
                                positions=g.positions[:, s:s + 1],
                                orientations=g.orientations[:, s:s + 1],
                                valid=g.valid[:, s:s + 1]), h)
                 for g, h in gloves for s in range(len(g.joint_index)))


def rotation_angle_deg(q, target):
    """workloads.py::rotation_angle_deg: the angle (degrees) between
    quaternions q and target, from conj(target) ∘ q in float64."""
    t = target.astype(np.float64)
    q = q.astype(np.float64)
    tv, tw, qv, qw = -t[..., :3], t[..., 3:], q[..., :3], q[..., 3:]
    v = tw * qv + qw * tv + np.cross(tv, qv)
    w = tw[..., 0] * qw[..., 0] - np.sum(tv * qv, axis=-1)
    return np.rad2deg(2 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w)))


def glove_figures(char, markers, gloves, motion):
    """workloads.py::glove_figures on JAX's FK."""
    from momentum_tpu.math import quaternion as quat
    from momentum_tpu.tracking.tracker import _match_locators

    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(motion))
    li, mi = _match_locators(char, markers)
    world = np.asarray(jax.vmap(char.locators.world_positions)(states))
    pos, occ = np.asarray(markers.positions), np.asarray(markers.occluded)
    err = 1e3 * np.linalg.norm(world[:, li] - pos[:, mi], axis=-1)[~occ[:, mi]]
    names = char.skeleton.joint_names
    gp, go = [], []
    for g, h in gloves:
        bone = names.index("glove_" + GLOVE_WRISTS[h])
        ref, src = states[:, bone:bone + 1], states[:, np.asarray(g.joint_index)]
        q_inv = quat.conjugate(ref[..., 3:7])
        p = np.asarray(quat.rotate_vector(q_inv, src[..., :3] - ref[..., :3]), np.float64)
        q = np.asarray(quat.multiply(q_inv, src[..., 3:7]), np.float64)
        gp.append(1e3 * np.linalg.norm(p - g.positions, axis=-1)[g.valid])
        go.append(rotation_angle_deg(q, g.orientations)[g.valid])
    return dict(median_mm=float(np.median(err)), p90_mm=float(np.percentile(err, 90)),
                glove_position_median_mm=float(np.median(np.concatenate(gp))),
                glove_orientation_median_deg=float(np.median(np.concatenate(go))))


def glove(frames, seed=0, per_frame=32):
    """Config G: track_sequence over all `frames` frames (LM 10 with line
    search, smoothing 1e-4, from the initial motion; the gloves split per
    joint, ROADMAP F21) and per-frame tracking (LM 15) of the first
    `per_frame` frames from the first initial pose, both gloves one module a
    hand: the final error, the marker and glove figures, the per-frame
    median energy."""
    from momentum_tpu.tracking import (
        MarkerSequence, TrackingConfig, track_poses_per_frame, track_sequence)
    from momentum_tpu.tracking.glove_utils import GloveSequence

    char, cfg, markers, gloves, initial = glove_clip(frames, seed)
    lm = "levenberg_marquardt"
    t0 = time.perf_counter()
    res, _ = track_sequence(char, markers, TrackingConfig(
        max_iter=10, regularization=1e-3, smoothing=1e-4, method=lm), initial=initial,
        glove_data=split_gloves(gloves), glove_config=cfg)
    out = dict(config="glove", frames=frames, sequence=dict(
        error=float(res.errors[0]), **glove_figures(char, markers, gloves, res.motion)),
        sequence_s=time.perf_counter() - t0)
    head = MarkerSequence(positions=markers.positions[:per_frame],
                          occluded=markers.occluded[:per_frame], names=markers.names)
    head_gloves = tuple((GloveSequence(joint_index=g.joint_index,
                                       positions=g.positions[:per_frame],
                                       orientations=g.orientations[:per_frame],
                                       valid=g.valid[:per_frame]), h) for g, h in gloves)
    t0 = time.perf_counter()
    pf = track_poses_per_frame(char, head, TrackingConfig(
        max_iter=15, regularization=1e-3, method=lm), initial=initial[0],
        glove_data=head_gloves, glove_config=cfg)
    out["per_frame"] = dict(frames=per_frame, median_energy=float(np.median(np.asarray(
        pf.errors))), **glove_figures(char, head, head_gloves, pf.motion))
    out["per_frame_s"] = time.perf_counter() - t0
    return out


SCENE = dict(width=640, height=480, supersample=2, bone_radius=0.02, locator_radius=0.012,
             sphere_radius=0.05, sphere_level=1, dot_color=(0.1, 0.9, 0.2))


def scene_clip(frames, seed=0):
    """Config 7p's character, motion and camera: config 7's clip
    (workloads.py::build_render_clip's numpy draws) with the camera framed
    for 640 × 480."""
    from momentum_tpu.rasterizer.utils import create_camera_for_body
    from momentum_tpu.testing.fixtures import create_fullbody_character

    char = create_fullbody_character()
    rng = np.random.default_rng(seed)
    steps = 0.02 * rng.normal(0, 1, (frames, char.num_model_parameters)).astype(np.float32)
    motion = jnp.asarray(np.cumsum(steps, axis=0))
    states = jax.vmap(char.skeleton_states)(motion)
    return char, motion, create_camera_for_body(char, states, SCENE["height"], SCENE["width"])


def scene_figures(image, ground_rgb):
    """Mean coverage (the share of pixels that differ from the ground alone)
    and the mean colour of those pixels."""
    image = np.asarray(image)
    covered = np.abs(image - np.asarray(ground_rgb)).max(-1) > 0
    return dict(coverage=float(covered.mean()),
                mean_color=[float(c) for c in image[covered].mean(0)])


def config7p(seed=0, frames=(0, 1), clip_frames=32):
    """Config 7p, the pymomentum renderer's scene on config 7's clip at
    640 × 480 (workloads.py's build_scene_clip, make_scene_render and
    gui.viewer.render_motion): for each of `frames`, the offline viewer's
    frame (render_motion with the ground and the skeleton overlay; its
    rasterizer is JAX's CPU "auto", windowed, and the planes kernel in
    interpret mode) and the Phong scene's frame (render_mesh_phong at 2×
    supersampling over the ground, the skeleton's cylinders, a sphere at the
    root, the locators as dots, the label "FRAME i"; method windowed and
    planes): coverage and mean colour (scene_figures)."""
    from momentum_tpu.character.character_state import character_state
    from momentum_tpu.gui.viewer import render_motion
    from momentum_tpu.ops import raster_pallas
    from momentum_tpu.rasterizer import (
        rasterize_checkerboard, rasterize_circles, rasterize_skeleton, rasterize_spheres,
        rasterize_text, render_mesh_phong)

    w, h = SCENE["width"], SCENE["height"]
    char, motion, cam = scene_clip(clip_frames, seed)
    st = character_state(char.with_inverse_bind_pose(), motion[0], update_collision=False)
    extent = float(np.abs(np.asarray(st.mesh_vertices)[:, [0, 2]]).max()) * 3.0 + 1.0
    gz, gc = rasterize_checkerboard(cam, w, h, half_extent=extent, squares=10)
    out = dict(config="7p", seed=seed, width=w, height=h, scene=SCENE, viewer={}, phong={})
    available = raster_pallas.raster_pallas_available
    for method in ("windowed", "planes"):
        t0 = time.perf_counter()
        # render_motion takes no method: its "auto" is planes where the kernel is available
        raster_pallas.raster_pallas_available = (lambda: True) if method == "planes" \
            else available
        try:
            views = render_motion(char, motion[:max(frames) + 1], w, h, camera=cam,
                                  ground=True, skeleton_overlay=True)
        finally:
            raster_pallas.raster_pallas_available = available
        out["viewer"][method] = {str(i): scene_figures(views[i], gc) for i in frames}
        out["phong"][method] = {}
        for i in frames:
            st = character_state(char.with_inverse_bind_pose(), motion[i],
                                 update_collision=False)
            states = st.skeleton_state
            root = np.asarray(states[0, :3])
            ph = render_mesh_phong(cam, st.mesh_vertices, char.mesh.faces, w, h,
                                   supersample=SCENE["supersample"], method=method)
            win = ph["depth"] < gz
            z, rgb = jnp.where(win, ph["depth"], gz), jnp.where(win[..., None], ph["color"], gc)
            for layer in (rasterize_skeleton(cam, char.skeleton, states, w, h,
                                             bone_radius=SCENE["bone_radius"], method=method),
                          rasterize_spheres(cam, root, SCENE["sphere_radius"], w, h,
                                            subdivision_level=SCENE["sphere_level"],
                                            method=method)):
                win = layer["depth"] < z
                z, rgb = jnp.where(win, layer["depth"], z), jnp.where(win[..., None],
                                                                     layer["color"], rgb)
            z, rgb = rasterize_circles(cam, st.locator_positions, w, h,
                                       radius=SCENE["locator_radius"],
                                       fill_color=SCENE["dot_color"], z_buffer=z,
                                       rgb_buffer=rgb)
            image = rasterize_text(rgb, cam, f"FRAME {i}", root, scale=2)
            out["phong"][method][str(i)] = dict(
                scene_figures(image, gc), phong_mask=float(np.asarray(ph["mask"]).mean()))
        out[f"{method}_s"] = time.perf_counter() - t0
    return out


# ---- config SC: SDF-collision IK; config 5c: config 5 held off a ground ----

SDF_RESOLUTION = (64, 64, 64)
SDF_OBSTACLE_LEVEL = 3
SDF_OBSTACLE_CENTER = (0.0, 0.8, 0.5)
SDF_OBSTACLE_RADIUS = 0.35
SDF_COLLISION_WEIGHT = 1e3
SDF_GROUND_VERTICES = 32
SDF_GROUND_WEIGHT = 0.01
SDF_GROUND_HALF_EXTENT = 2.5
SDF_GROUND_DEPTH = 8.0
SDF_HAND = 36
SDF_HAND_FINGER = 40
SDF_HAND_VERTICES = 16
SDF_HAND_RESOLUTION = (32, 32, 32)
SDF_HAND_WEIGHT = 100.0
SDF_CONTACT_HEIGHT = 0.1
SDF_SEQUENCE_VERTICES = 8
SDF_SEQUENCE_WEIGHT = 100.0


def ground_slab(top, half_extent=SDF_GROUND_HALF_EXTENT, depth=SDF_GROUND_DEPTH):
    """workloads.py::ground_slab, the same numbers."""
    h = half_extent
    v = np.asarray([[x, y, z] for x in (-h, h) for y in (top - depth, top) for z in (-h, h)],
                   np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [[a, b, c] for a, b, c, _ in quads] + [[a, c, d] for a, _, c, d in quads]
    return v, np.asarray(f, np.int32)


def _rotate(q, v):
    u, w = q[..., :3], q[..., 3:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def sdf_recipe(rest_vertices, bind_states):
    """workloads.py::sdf_recipe, the same numbers (the JAX package's
    primitives)."""
    from momentum_tpu.rasterizer.primitives import make_capsule, make_sphere

    rest = rest_vertices.astype(np.float64)
    sv, sf = make_sphere(SDF_OBSTACLE_LEVEL)
    obstacle = (np.asarray(sv, np.float64) * SDF_OBSTACLE_RADIUS
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
    handle = (np.asarray(cv, np.float64) + np.asarray([x0, *axis_yz])).astype(np.float32)
    r = catalog_recipe()
    s = np.sqrt(0.5)
    foot = [0.0, -0.5, -0.5, s]
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


def sdf_problem(batch, seed=0):
    """(character with the contact capsules, recipe, the obstacle, ground
    and handle fields, truth, x0) of config SC, as
    workloads.py::build_sdf_collision_problem builds them."""
    from momentum_tpu.axel import mesh_to_sdf
    from momentum_tpu.character.character import CollisionGeometry
    from momentum_tpu.testing.fixtures import create_fullbody_character

    base = create_fullbody_character()
    r = sdf_recipe(np.asarray(base.mesh.vertices), np.asarray(base.bind_pose()))
    char = dataclasses.replace(base, collision=CollisionGeometry(
        **{k: jnp.asarray(v) for k, v in r["contact_capsules"].items()}))
    fields = dict(
        obstacle=mesh_to_sdf(r["obstacle_vertices"], r["obstacle_faces"], SDF_RESOLUTION,
                             sign_method="winding"),
        ground=mesh_to_sdf(r["ground_vertices"], r["ground_faces"], SDF_RESOLUTION,
                           sign_method="normal"),
        handle=mesh_to_sdf(r["handle_vertices"], r["handle_faces"], SDF_HAND_RESOLUTION,
                           sign_method="winding"))
    truth, x0 = catalog_draws(batch, seed, char.num_model_parameters)
    return char, r, fields, truth, x0


def sdf_modules(char, r, fields):
    """(make(truth states) -> (position, collision, floor), make_joint(truth
    params) -> (position, hand)) of config SC, per element."""
    from momentum_tpu import errors as E
    from momentum_tpu.solver import SkeletonSolverFunction

    loc = char.locators
    position = E.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                              np.zeros((loc.num_locators, 3)))
    collision = E.SdfCollisionErrorFunction.create(
        fields["obstacle"], np.arange(char.mesh.num_vertices), weight=SDF_COLLISION_WEIGHT)
    floor = E.VertexSdfErrorFunction.create(fields["ground"], r["ground_index"],
                                            weight=SDF_GROUND_WEIGHT)
    hand = E.VertexSdfErrorFunction.create(fields["handle"], r["hand_index"],
                                           weight=SDF_HAND_WEIGHT, sdf_parent=SDF_HAND)

    def make(states):
        return (dataclasses.replace(position, target=loc.world_positions(states)), collision,
                floor)

    def make_joint(theta):
        ctx = SkeletonSolverFunction(char, (hand,)).context(theta)
        v = jnp.take(ctx.mesh_vertices, hand.vertex_index, axis=-2)
        target = hand.sdf.sample(hand._to_sdf_space(ctx, v))
        return (dataclasses.replace(position, target=loc.world_positions(ctx.skel_states)),
                dataclasses.replace(hand, target_distance=target))

    return make, make_joint


def _solve_chunks(char, make, truth_in, x0, iterations, more, chunk):
    """Each element one vmapped LM solve (regularization 1e-5) of
    `iterations`, then `more` from its result, `chunk` elements a call →
    (params, per-module energies (B, M), energy after `more`)."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik

    def one(t, x):
        efs = make(t)
        fn = SkeletonSolverFunction(char, efs)
        opts = SolverOptions(max_iterations=iterations, regularization=1e-5)
        res = solve_ik(fn, x, None, opts, method="levenberg_marquardt")
        res2 = solve_ik(fn, res.params, None, dataclasses.replace(opts, max_iterations=more),
                        method="levenberg_marquardt")
        ctx = fn.context(res.params)
        return res.params, jnp.stack([ef.error(char, ctx) for ef in efs]), fn.error(res2.params)

    run = jax.jit(jax.vmap(one))
    outs = [run(truth_in[i:i + chunk], jnp.asarray(x0[i:i + chunk]))
            for i in range(0, x0.shape[0], chunk)]
    return tuple(np.concatenate([np.asarray(o[j]) for o in outs]) for j in range(3))


def _figures(labels, per, longer):
    per, longer = per.astype(np.float64), longer.astype(np.float64)
    total = per.sum(axis=1)
    finite = np.isfinite(total)
    med = {lab: float(np.median(per[:, i])) for i, lab in enumerate(labels)}
    med["total"] = float(np.median(total))
    return dict(median_energy=med, conv_at_1e5=float(np.mean(finite & (total - longer <= 1e-5))),
                divergent=int(np.sum(~finite)))


def sdf_penetration(char, obstacle, params):
    """Each element's deepest penetration max(0, −min φ) of its posed mesh
    in the obstacle (float64)."""
    from momentum_tpu.errors import SdfCollisionErrorFunction
    from momentum_tpu.solver import SkeletonSolverFunction

    ef = SdfCollisionErrorFunction.create(obstacle, np.arange(char.mesh.num_vertices))
    fn = SkeletonSolverFunction(char, (ef,))

    def deepest(x):
        return jnp.maximum(-jnp.min(obstacle.sample(fn.context(x).mesh_vertices)), 0.0)

    return np.asarray(jax.jit(jax.vmap(deepest))(jnp.asarray(params)), np.float64)


def sdf_contacts(char, plane, params):
    """(active (B, L + C), the support polygons' areas (B,)) of the poses
    `params` against the ground plane, each element unbatched (JAX's
    per-parent dedup holds unbatched only, ROADMAP F23)."""
    from momentum_tpu.character.support_contacts import (
        support_contact_positions, support_polygon_from_contacts)

    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(params))
    active = jax.jit(jax.vmap(lambda st: support_contact_positions(
        char, st, SDF_CONTACT_HEIGHT, plane)[1]))(states)
    areas = []
    for i in range(params.shape[0]):
        hull = np.asarray(support_polygon_from_contacts(char, states[i], SDF_CONTACT_HEIGHT,
                                                        plane), np.float64)
        if len(hull) < 3:
            areas.append(0.0)
            continue
        x, y = hull[:, 0], hull[:, 1]
        areas.append(float(0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))
    return np.asarray(active), np.asarray(areas, np.float64)


def config_sc(batch, seed=0, iterations=10, more=20, chunk=32):
    """Config SC at B = `batch` (workloads.py::build_sdf_collision_problem):
    each element one vmapped LM 10 solve, then 20 more; each module's
    median final energy, conv_at_1e5, the divergent count; the penetration
    before and after; the support contacts and polygon areas on the solved
    poses; the joint-attached case (the handle's field on r_hand0, rows by
    forward mode) on the same elements; JAX's solved parameters go to the
    arrays (the smoke computes the port's contacts on them)."""
    from momentum_tpu.math.support_polygon import SupportPlane

    t0 = time.perf_counter()
    char, r, fields, truth, x0 = sdf_problem(batch, seed)
    build_s = time.perf_counter() - t0
    make, make_joint = sdf_modules(char, r, fields)
    states = jax.jit(jax.vmap(char.skeleton_states))(jnp.asarray(truth))
    params, per, longer = _solve_chunks(char, make, states, x0, iterations, more, chunk)
    fig = _figures(("position", "sdf_collision", "vertex_sdf"), per, longer)
    before = sdf_penetration(char, fields["obstacle"], x0)
    after = sdf_penetration(char, fields["obstacle"], params)
    pen = before > 0
    plane = SupportPlane.create(offset=r["ground_top"])
    active, areas = sdf_contacts(char, plane, params)
    _, jper, jlonger = _solve_chunks(char, make_joint, jnp.asarray(truth), x0, iterations,
                                     more, chunk)
    fig.update(config="sdf", batch=batch, iterations=iterations, more=more,
               penetration=dict(before_fraction=float(np.mean(pen)),
                                after_fraction=float(np.mean(after > 0)),
                                before_median_depth=float(np.median(before[pen])),
                                after_median_depth=float(np.median(after[pen]))),
               contacts=dict(active=active.astype(int).tolist(), areas=areas.tolist(),
                             active_count=int(active.sum())),
               joint_attached=_figures(("position", "vertex_sdf_joint"), jper, jlonger),
               build_seconds=build_s, seconds=time.perf_counter() - t0)
    return fig, dict(params=params)


def config5c(frames, seed=0):
    """Config 5c (workloads.py::build_sdf_sequence_problem): config 5's
    sequence solve plus SdfCollisionSequence on the test rig's lowest rest
    vertices against a ground slab's field; the final error."""
    from momentum_tpu.axel import mesh_to_sdf
    from momentum_tpu.errors import PositionErrorFunction
    from momentum_tpu.sequence.errors import (
        ModelParametersSequenceErrorFunction, SdfCollisionSequenceErrorFunction)
    from momentum_tpu.sequence.solver import solve_sequence
    from momentum_tpu.sequence.solver_function import SequenceSolverFunction
    from momentum_tpu.solver import SolverOptions
    from momentum_tpu.testing.fixtures import create_test_character

    char = create_test_character(16)
    p = char.num_model_parameters
    rng = np.random.default_rng(seed)
    gt = jnp.asarray(rng.uniform(-0.2, 0.2, (frames, p)), jnp.float32)
    targets = jax.vmap(char.locators.world_positions)(jax.vmap(char.skeleton_states)(gt))
    ef0 = PositionErrorFunction.create(
        np.asarray(char.locators.parent), np.asarray(char.locators.offset),
        np.zeros((char.locators.num_locators, 3)))
    stacked = jax.vmap(lambda t: dataclasses.replace(ef0, target=t))(targets)
    rest = np.asarray(char.mesh.vertices)
    gv, gf = ground_slab(float(rest[:, 1].min()))
    ground = mesh_to_sdf(gv, gf, SDF_RESOLUTION, sign_method="normal")
    sdf_seq = SdfCollisionSequenceErrorFunction.create(
        ground, np.argsort(rest[:, 1], kind="stable")[:SDF_SEQUENCE_VERTICES],
        weight=SDF_SEQUENCE_WEIGHT)
    smooth = ModelParametersSequenceErrorFunction.create(p, weight=0.1)
    fn = SequenceSolverFunction.create(char, frames, per_frame_errors=(stacked,),
                                       sequence_errors=(smooth, sdf_seq))
    pf0, u0 = fn.split(jnp.zeros((frames, p)))
    t0 = time.perf_counter()
    res = jax.jit(lambda pf, u: solve_sequence(fn, pf, u, SolverOptions(max_iterations=8)))(
        pf0, u0)
    return dict(config="5c", frames=frames, error=float(res.error),
                iterations=int(res.iterations), converged=bool(res.converged),
                seconds=time.perf_counter() - t0)


# ---- config U: retargeting and character surgery ----

UTILITY_TURN = 0.7
UTILITY_SHIFT = (4.0, 0.0, -1.5)
UTILITY_SCALE = 1.15
UTILITY_TOTAL_MASS = 70.0
UTILITY_COM_WEIGHT = 1.0
UTILITY_DROPPED = ("_leg", "_foot")
UTILITY_EARLY = 3  # LM iterations of the early medians


def utility_bodies(parents, offsets):
    """workloads.py::utility_bodies, the same numbers."""
    parents = np.asarray(parents, np.int64)
    offsets = np.asarray(offsets, np.float64)
    nj = len(parents)
    bone = offsets.copy()
    for j in range(nj - 1, 0, -1):
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


def utility_xform():
    """workloads.py::utility_xform."""
    half = 0.5 * UTILITY_TURN
    return np.asarray([*UTILITY_SHIFT, 0.0, np.sin(half), 0.0, np.cos(half), 1.0], np.float32)


def array_digest(a):
    """workloads.py::array_digest."""
    import hashlib

    a = np.asarray(a)
    a = a.astype("<f4") if a.dtype.kind == "f" else a.astype("<i4")
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def utility_problem():
    """(the rig with config U's bodies, the scaled rig, the simplified rig,
    U4's kept parameter columns) as workloads.py::build_utility_problem
    builds them."""
    from momentum_tpu import compat
    from momentum_tpu.character.character import PhysicalProperties
    from momentum_tpu.character.utility import (
        parameters_to_active_joints, scale_character, simplify)
    from momentum_tpu.testing.fixtures import create_fullbody_character

    base = create_fullbody_character()
    bodies = utility_bodies(np.asarray(base.skeleton.joint_parent),
                            np.asarray(base.skeleton.translation_offset))
    char = dataclasses.replace(base, physical_properties=PhysicalProperties(
        **{k: jnp.asarray(v) for k, v in bodies.items()},
        joint_names=base.skeleton.joint_names))
    scaled = scale_character(char, UTILITY_SCALE, "preserve_mass")
    names = char.parameter_transform.names
    enabled = np.asarray([not any(d in n for d in UTILITY_DROPPED) for n in names], bool)
    active = np.asarray(parameters_to_active_joints(char.parameter_transform, enabled))
    active[0] = True
    simple = simplify(compat.reduce_mesh_to_bones(char, np.nonzero(active)[0]), enabled)
    cols = np.asarray([names.index(n) for n in simple.parameter_transform.names])
    return char, scaled, simple, cols


def utility_tables(char):
    """workloads.py::simplified_tables on a JAX character."""
    lim = char.limits
    return dict(joint_parents=np.asarray(char.skeleton.joint_parent).tolist(),
                locator_parents=np.asarray(char.locators.parent).tolist(),
                parameter_names=list(char.parameter_transform.names),
                transform=array_digest(char.parameter_transform.transform),
                limits={f.name: array_digest(getattr(lim, f.name))
                        for f in dataclasses.fields(lim)},
                mesh_faces=array_digest(char.mesh.faces),
                num_vertices=int(char.mesh.num_vertices))


def utility_solves(scaled, simple, cols, truth, x0, iterations=10, more=20, chunk=32):
    """U3's and U4's figures (each element one vmapped solve) from the
    draws `truth`, `x0`: _figures of LM `iterations` then `more`, and each
    module's median energy after LM UTILITY_EARLY."""
    from momentum_tpu import errors as E
    from momentum_tpu.math import skel_state as ss

    def com_of(rig, st):
        pp = rig.physical_properties
        pos = ss.transform_points(jnp.take(st, pp.joint_index, axis=-2), pp.center_of_mass_offset)
        return jnp.einsum("...ji,j->...i", pos, pp.mass) / jnp.sum(pp.mass)

    def markers(rig):
        loc = rig.locators
        return E.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                              np.zeros((loc.num_locators, 3)))

    pos_s = markers(scaled)
    com = E.CenterOfMassErrorFunction.from_physical_properties(scaled, np.zeros(3),
                                                               weight=UTILITY_COM_WEIGHT)

    def make_scaled(st):
        return (dataclasses.replace(pos_s, target=scaled.locators.world_positions(st)),
                dataclasses.replace(com, target=com_of(scaled, st)))

    pos_4 = markers(simple)

    def make_simple(st):
        return (dataclasses.replace(pos_4, target=simple.locators.world_positions(st)),)

    truth_4 = jnp.asarray(truth[:, cols])
    out = []
    for rig, make, labels, t, x in (
            (scaled, make_scaled, ("position", "center_of_mass"), jnp.asarray(truth), x0),
            (simple, make_simple, ("position",), truth_4, np.ascontiguousarray(x0[:, cols]))):
        states = jax.jit(jax.vmap(rig.skeleton_states))(t)
        _, per, longer = _solve_chunks(rig, make, states, x, iterations, more, chunk)
        _, early, longer_early = _solve_chunks(rig, make, states, x, UTILITY_EARLY, 0, chunk)
        out.append(dict(_figures(labels, per, longer), early_median_energy=_figures(
            labels, early, longer_early)["median_energy"]))
    return tuple(out)


def utility(batch, seed=0, iterations=10, more=20, chunk=32, seeds=()):
    """Config U at B = `batch`: U1's largest FK position error of JAX's
    transform_pose on the config's move (F25) and on a move inside π; U2's
    joint parameters; U3's and U4's figures (utility_solves), and the same
    on each of `seeds`' draws; U4's tables."""
    from momentum_tpu.character.inverse_fk import joint_parameters_from_skeleton_states
    from momentum_tpu.character.transform_pose import transform_pose
    from momentum_tpu.math import skel_state as ss

    t0 = time.perf_counter()
    char, scaled, simple, cols = utility_problem()
    truth, x0 = catalog_draws(batch, seed, char.num_model_parameters)
    fk = jax.jit(jax.vmap(char.skeleton_states))
    states = fk(jnp.asarray(truth))

    def move_error(xf):
        moved = jax.jit(lambda t: transform_pose(char, t, xf))(jnp.asarray(truth))
        want = ss.multiply(xf, states)
        return float(jnp.max(jnp.linalg.norm(fk(moved)[..., :3] - want[..., :3], axis=-1)))

    xform = jnp.asarray(utility_xform())
    inside = xform.at[:3].set(jnp.asarray([1.0, 0.0, -0.5]))
    u1 = dict(max_position_error=move_error(xform),
              max_position_error_inside_pi=move_error(inside))
    jp = np.asarray(jax.jit(lambda s: joint_parameters_from_skeleton_states(char.skeleton, s))(
        states))
    u3, u4 = utility_solves(scaled, simple, cols, truth, x0, iterations, more, chunk)
    u4["tables"] = utility_tables(simple)
    more_seeds = {}
    for s in seeds:
        t_s, x_s = catalog_draws(batch, s, char.num_model_parameters)
        more_seeds[str(s)] = dict(zip(("u3", "u4"), utility_solves(
            scaled, simple, cols, t_s, x_s, iterations, more, chunk)))
    fig = dict(config="utility", batch=batch, seed=seed, iterations=iterations, more=more,
               early_iterations=UTILITY_EARLY, u1=u1, u3=u3, u4=u4, seeds=more_seeds,
               bodies=dict(mass=array_digest(char.physical_properties.mass),
                           scaled_inertia=array_digest(scaled.physical_properties.inertia)),
               seconds=time.perf_counter() - t0)
    return fig, dict(joint_parameters=jp)


# ---- io: the file layer's reference files ----

IO_FRAMES = 8  # the rig's motion in the .glb, the skeleton states and the .mmo
IO_TAKE_FRAMES = 64  # config 6s's first frames in the .trc and .c3d files
IO_FPS = 30.0
IO_SEED = 17
IO_LIMIT_KEYS = (
    "minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
    "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive", "linear_ref",
    "linear_tgt", "linear_scale", "linear_offset", "linear_range", "linear_weight",
    "linear_joint_ref", "linear_joint_tgt", "linear_joint_scale", "linear_joint_offset",
    "linear_joint_range", "linear_joint_weight", "halfplane_idx1", "halfplane_idx2",
    "halfplane_normal", "halfplane_offset", "halfplane_weight", "ellipsoid_parent",
    "ellipsoid_frame_parent", "ellipsoid_point_offset", "ellipsoid_mat", "ellipsoid_inv",
    "ellipsoid_weight")


def io_tables(char, prefix):
    """workloads.py::character_tables on a JAX character, each key under
    `prefix`."""
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
    return {f"{prefix}.{k}": np.asarray(v) for k, v in d.items()}


def io_character():
    """The full-body rig with config U's bodies (workloads.py::utility_character)."""
    from momentum_tpu.character.character import PhysicalProperties
    from momentum_tpu.testing.fixtures import create_fullbody_character

    base = create_fullbody_character()
    bodies = utility_bodies(np.asarray(base.skeleton.joint_parent),
                            np.asarray(base.skeleton.translation_offset))
    return dataclasses.replace(base, physical_properties=PhysicalProperties(
        **{k: jnp.asarray(v) for k, v in bodies.items()}, joint_names=base.skeleton.joint_names))


def io_draws(num_params, num_markers, num_joints):
    """(motion (8, P), marker occlusion (8, M), identity (nJ·7,),
    timestamps (8,)) of the reference .glb, numpy from IO_SEED."""
    rng = np.random.default_rng(IO_SEED)
    motion = rng.uniform(-0.3, 0.3, (IO_FRAMES, num_params)).astype(np.float32)
    occluded = rng.random((IO_FRAMES, num_markers)) < 0.1
    identity = rng.normal(0.0, 0.01, num_joints * 7).astype(np.float32)
    timestamps = 1_000_000 + 33_333 * np.arange(IO_FRAMES, dtype=np.int64)
    return motion, occluded, identity, timestamps


def io_take():
    """The first IO_TAKE_FRAMES frames of config 6s's clip (JAX's FK on the
    CMU rig): (positions (F, 41, 3) mm, NaN where occluded, occluded, names)."""
    from momentum_tpu.tracking.cmu import create_cmu_character

    char = create_cmu_character()
    motion, noise, occluded = tracking_clip_draws(343, 0, char.num_model_parameters,
                                                  char.locators.num_locators)
    states = jax.vmap(char.skeleton_states)(jnp.asarray(motion[:IO_TAKE_FRAMES]))
    pos = np.asarray(jax.vmap(char.locators.world_positions)(states)) + noise[:IO_TAKE_FRAMES]
    occ = occluded[:IO_TAKE_FRAMES]
    return (np.where(occ[..., None], np.nan, pos).astype(np.float32), occ,
            list(char.locators.names))


def io_files(out_dir):
    """Write the io reference files into out_dir and return what JAX's
    loaders give for each (the arrays of jax_reference_io.npz)."""
    from momentum_tpu import io as jio
    from momentum_tpu.io.gltf import load_character_glb_with_skel_states
    from momentum_tpu.io.markers import RawMarkerData
    from momentum_tpu.tracking import MarkerSequence

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from c3d_writer import save_c3d

    os.makedirs(out_dir, exist_ok=True)
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    char = io_character()
    pt, nj = char.parameter_transform, char.skeleton.num_joints
    motion, occ, identity, timestamps = io_draws(char.num_model_parameters,
                                                 char.locators.num_locators, nj)
    states = jax.vmap(char.skeleton_states)(jnp.asarray(motion))
    marker_pos = np.asarray(jax.vmap(char.locators.world_positions)(states))
    markers = MarkerSequence(positions=jnp.asarray(np.where(occ[..., None], 0.0, marker_pos)),
                             occluded=jnp.asarray(occ), names=tuple(char.locators.names))
    jio.save_character_glb(path("fullbody.glb"), char, motion=motion, fps=IO_FPS,
                           markers=markers, identity=identity, timestamps=timestamps)
    jio.GltfBuilder().add_character(char).add_skeleton_states(states).set_fps(IO_FPS).save(
        path("fullbody_skel_states.glb"))
    with open(path("fullbody.model"), "w") as f:
        f.write(jio.write_model_definition(pt, char.skeleton, char.limits))
    jio.save_locators(path("fullbody.locators"), char)
    jio.save_legacy_json(path("fullbody.json"), char)
    jio.save_mppca(path("fullstack.mppca"), fullstack_modules(char)[3].prior)
    jio.save_mmo(path("fullbody.mmo"), motion, np.zeros(nj, np.float32), list(pt.names),
                 list(char.skeleton.joint_names))
    take_pos, take_occ, take_names = io_take()
    jio.save_trc(path("take.trc"), RawMarkerData(take_pos, take_occ, take_names, 120.0))
    for fmt in ("real", "integer"):
        save_c3d(path(f"take_{fmt}.c3d"), take_pos, take_occ, take_names, rate=120.0,
                 point_format=fmt)

    out = {}
    got, got_motion, fps, got_markers = jio.load_character_glb(path("fullbody.glb"),
                                                               return_markers=True)
    out.update(io_tables(got, "glb"))
    lm_motion, lm_names, lm_identity, lm_joints = jio.load_motion(path("fullbody.glb"))
    out.update({"glb.motion": np.asarray(got_motion), "glb.fps": np.asarray(fps),
                "glb.marker_positions": np.asarray(got_markers.positions),
                "glb.marker_occluded": np.asarray(got_markers.occluded),
                "glb.marker_names": np.asarray(list(got_markers.names)),
                "glb.timestamps": np.asarray(jio.gltf.load_motion_timestamps(
                    path("fullbody.glb"))),
                "glb.load_motion": lm_motion, "glb.load_motion_names": np.asarray(lm_names),
                "glb.identity": lm_identity, "glb.identity_joint_names": np.asarray(lm_joints)})
    got, got_states, fps = load_character_glb_with_skel_states(path("fullbody_skel_states.glb"))
    out.update(io_tables(got, "skel"))
    out.update({"skel.states": np.asarray(got_states), "skel.fps": np.asarray(fps)})
    mpt, mlim = jio.load_model_definition(path("fullbody.model"), char.skeleton)
    keep = ("transform", "offsets", "parameter_names", "parameter_sets",
            "pose_constraints") + IO_LIMIT_KEYS
    out.update({k: v for k, v in io_tables(dataclasses.replace(
        char, parameter_transform=mpt, limits=mlim), "model").items()
        if k.split(".", 1)[1] in keep})
    loc = jio.load_locators(path("fullbody.locators"), char)
    out.update({f"locators.{k}": np.asarray(getattr(loc, k)) for k in (
        "parent", "offset", "weight", "locked", "limit_weight", "limit_origin",
        "attached_to_skin", "skin_offset")})
    out["locators.names"] = np.asarray(list(loc.names))
    out.update(io_tables(jio.load_legacy_json(path("fullbody.json")), "json"))
    mp = jio.load_mppca(path("fullstack.mppca"))
    out.update({f"mppca.{k}": np.asarray(getattr(mp, k)) for k in ("mu", "cinv", "l", "rpre")})
    out["mppca.names"] = np.asarray(list(mp.names))
    poses, scale, pnames, jnames = jio.load_mmo(path("fullbody.mmo"))
    out.update({"mmo.poses": poses, "mmo.scale": scale, "mmo.parameter_names":
                np.asarray(pnames), "mmo.joint_names": np.asarray(jnames)})
    for key, name in (("trc", "take.trc"), ("c3d_real", "take_real.c3d"),
                      ("c3d_integer", "take_integer.c3d")):
        raw = jio.load_markers(path(name))[0]
        out.update({f"{key}.positions": raw.positions, f"{key}.occluded": raw.occluded,
                    f"{key}.names": np.asarray(raw.names), f"{key}.fps": np.asarray(raw.fps)})
    np.savez_compressed(path("jax_reference_io.npz"), **out)
    sizes = {f: os.path.getsize(path(f)) for f in sorted(os.listdir(out_dir))}
    return dict(config="io", files=sizes, total_bytes=sum(sizes.values()),
                arrays=len(out))


# ---- io2: the file layer's second part (FBX, USD, URDF, BVH) ----

IO2_ARM_URDF = """<robot name="arm">
  <link name="base"/>
  <link name="upper"/>
  <link name="lower"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0.5 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-1.57" upper="1.57"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/><child link="lower"/>
    <origin xyz="0 1 0" rpy="0 0 0"/>
    <axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="0.1"/>
  </joint>
</robot>
"""


def io2_files(out_dir):
    """Write the io2 reference files into out_dir and return what JAX's
    loaders give for each (the arrays of jax_reference_io2.npz)."""
    from momentum_tpu import io as jio
    from momentum_tpu.io import usd as jusd
    from momentum_tpu.tracking.cmu import create_cmu_character

    os.makedirs(out_dir, exist_ok=True)
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    char = io_character()
    pt = char.parameter_transform
    motion = io_draws(char.num_model_parameters, char.locators.num_locators,
                      char.skeleton.num_joints)[0]
    jio.save_fbx(path("fullbody.fbx"), char, motion=motion, fps=IO_FPS)
    jio.save_usd(path("fullbody.usda"), char, motion=motion, fps=IO_FPS)
    jio.save_usd(path("fullbody.usdc"), char, motion=motion, fps=IO_FPS)
    jio.save_bvh(path("fullbody.bvh"), char, np.asarray(jax.vmap(pt.apply)(jnp.asarray(motion))),
                 fps=IO_FPS)
    cmu = create_cmu_character()
    jio.save_usda(path("cmu.usda"), cmu)
    with open(path("cmu.model"), "w") as f:
        f.write(jio.write_model_definition(cmu.parameter_transform, cmu.skeleton, cmu.limits))
    with open(path("arm.urdf"), "w") as f:
        f.write(IO2_ARM_URDF)

    out = {}
    got, got_motion, fps = jio.load_fbx_with_motion(path("fullbody.fbx"), fps=IO_FPS)
    out.update(io_tables(got, "fbx"))
    out.update({"fbx.motion": np.asarray(got_motion), "fbx.fps": np.asarray(fps)})
    for ext in ("usda", "usdc"):
        got, got_motion = jio.load_usd(path(f"fullbody.{ext}"))
        _, states, fps = jusd.load_character_with_skel_states(path(f"fullbody.{ext}"))
        out.update(io_tables(got, ext))
        out.update({f"{ext}.motion": np.asarray(got_motion), f"{ext}.states": np.asarray(states),
                    f"{ext}.fps": np.asarray(fps), f"{ext}.name": np.asarray(got.name)})
    got, got_motion, fps = jio.load_bvh(path("fullbody.bvh"))
    out.update(io_tables(got, "bvh"))
    out.update({"bvh.motion": np.asarray(got_motion), "bvh.fps": np.asarray(fps)})
    out.update(io_tables(jio.load_full_character(path("cmu.usda"), path("cmu.model")), "cmu"))
    out.update(io_tables(jio.load_urdf(path("arm.urdf")), "urdf"))
    np.savez_compressed(path("jax_reference_io2.npz"), **out)
    sizes = {f: os.path.getsize(path(f)) for f in sorted(os.listdir(out_dir))}
    return dict(config="io2", files=sizes, total_bytes=sum(sizes.values()), arrays=len(out))


CONFIGS = ("2", "2b", "4", "5", "5f", "6s", "catalog", "6k", "diffik", "variants", "4x",
           "4ad", "skinned", "glove", "7p", "sdf", "utility", "io", "io2")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--configs", nargs="+", default=["2,2b,4"],
                    help=f"comma- or space-separated, of {','.join(CONFIGS)}")
    ap.add_argument("--frames", type=int, default=1024, help="config 5's frame count")
    ap.add_argument("--tracking-frames", type=int, default=343,
                    help="config 6s's frame count")
    ap.add_argument("--out-6s", default=None,
                    help="write config 6s's figures, with the calibrated identity and "
                         "locator offsets, to this JSON file, and the per-frame motion "
                         "beside it as <name>_per_frame.npy (chip_smoke.py reads "
                         "tools/jax_reference_6s.json and tools/jax_reference_6s_per_frame.npy)")
    ap.add_argument("--catalog-batch", type=int, default=256,
                    help="config C's batch (the smoke holds the port's first 256 elements)")
    ap.add_argument("--out-catalog", default=None,
                    help="write config C's figures to this JSON file "
                         "(chip_smoke.py reads tools/jax_reference_catalog.json)")
    ap.add_argument("--out-6k", default=None,
                    help="write config 6k's figures to this JSON file "
                         "(chip_smoke.py reads tools/jax_reference_6k.json)")
    ap.add_argument("--diffik-batch", type=int, default=256,
                    help="config D's and the solver variants' batch (the smoke holds the "
                         "port's first 256 elements)")
    ap.add_argument("--out-diffik", default=None,
                    help="write config D's figures to this JSON file and its per-element "
                         "arrays beside it as <name>.npz (chip_smoke.py reads "
                         "tools/jax_reference_diffik.json and .npz)")
    ap.add_argument("--out-variants", default=None,
                    help="write the solver variants' figures to this JSON file "
                         "(chip_smoke.py reads tools/jax_reference_variants.json)")
    ap.add_argument("--out-4x", default=None,
                    help="write config 4x's figures to this JSON file "
                         "(chip_smoke.py reads tools/jax_reference_4x.json)")
    ap.add_argument("--skinned-batch", type=int, default=256,
                    help="config SL's batch (the smoke holds the port's first 256 elements)")
    ap.add_argument("--sdf-batch", type=int, default=256,
                    help="config SC's batch (the smoke holds the port's first 256 elements)")
    ap.add_argument("--utility-batch", type=int, default=256,
                    help="config U's batch (the smoke holds the port's first 256 elements)")
    ap.add_argument("--utility-seeds", type=int, nargs="*", default=[],
                    help="config U: U3's and U4's figures on these seeds' draws too "
                         "(tools/utility_spread.py holds the port's against them)")
    for name in ("4ad", "skinned", "glove", "7p", "sdf", "utility"):
        ap.add_argument(f"--out-{name}", default=None,
                        help=f"write config {name}'s figures to this JSON file (chip_smoke.py "
                             f"reads tools/jax_reference_{name}.json)")
    ap.add_argument("--out-io", default="tools/jax_reference_io",
                    help="write the io reference files and jax_reference_io.npz into this "
                         "directory (chip_smoke.py and tests/test_torch_port_io.py read "
                         "tools/jax_reference_io/)")
    ap.add_argument("--out-io2", default="tools/jax_reference_io2",
                    help="write the io2 reference files and jax_reference_io2.npz into this "
                         "directory (chip_smoke.py and tests/test_torch_port_io_usd.py read "
                         "tools/jax_reference_io2/)")
    args = ap.parse_args()
    args.configs = [c for arg in args.configs for c in arg.split(",") if c]
    if not set(args.configs) <= set(CONFIGS):
        ap.error(f"--configs takes {CONFIGS}, got {args.configs}")
    t0 = time.perf_counter()
    figures = []
    if "2" in args.configs:
        figures.append(config2_frame())
    if "2b" in args.configs:
        figures.append(config2b(args.batch))
    if "4" in args.configs:
        figures.extend(config4(args.batch))
    for name in ("5", "5f"):
        if name in args.configs:
            figures.append(config5(args.frames, name == "5f"))
    if "6s" in args.configs:
        figures.append(config6s(args.tracking_frames))
    if "catalog" in args.configs:
        figures.append(catalog(args.catalog_batch))
    if "6k" in args.configs:
        figures.append(config6k(args.tracking_frames))
    if "diffik" in args.configs:
        fig, arrays = diffik(args.diffik_batch)
        if args.out_diffik:
            np.savez_compressed(os.path.splitext(args.out_diffik)[0] + ".npz", **arrays)
        figures.append(fig)
    if "variants" in args.configs:
        figures.append(variants(args.diffik_batch))
    if "4x" in args.configs:
        figures.append(config4x(args.batch))
    if "4ad" in args.configs:
        figures.append(config4ad(args.batch))
    if "skinned" in args.configs:
        figures.append(skinned(args.skinned_batch))
    if "glove" in args.configs:
        figures.append(glove(args.tracking_frames))
    if "7p" in args.configs:
        figures.append(config7p())
    if "sdf" in args.configs:
        fig, arrays = config_sc(args.sdf_batch)
        fig["config5c"] = config5c(args.frames)
        if args.out_sdf:
            np.savez_compressed(os.path.splitext(args.out_sdf)[0] + ".npz", **arrays)
        figures.append(fig)
    if "utility" in args.configs:
        fig, arrays = utility(args.utility_batch, seeds=args.utility_seeds)
        if args.out_utility:
            np.savez_compressed(os.path.splitext(args.out_utility)[0] + ".npz", **arrays)
        figures.append(fig)
    if "io" in args.configs:
        figures.append(io_files(args.out_io))
    if "io2" in args.configs:
        figures.append(io2_files(args.out_io2))
    for fig in figures:
        if fig.get("config") == "6s":
            motion = fig.pop("per_frame_motion")
            if args.out_6s:
                with open(args.out_6s, "w") as f:
                    json.dump(dict(fig, device="jax cpu"), f, indent=1)
                np.save(os.path.splitext(args.out_6s)[0] + "_per_frame.npy", motion)
            fig = {k: v for k, v in fig.items() if k not in ("identity", "locator_offsets")}
        for name, out in (("catalog", args.out_catalog), ("6k", args.out_6k),
                          ("diffik", args.out_diffik), ("variants", args.out_variants),
                          ("4x", args.out_4x), ("4ad", args.out_4ad),
                          ("skinned", args.out_skinned), ("glove", args.out_glove),
                          ("7p", args.out_7p), ("sdf", args.out_sdf),
                          ("utility", args.out_utility)):
            if fig.get("config") == name and out:
                with open(out, "w") as f:
                    json.dump(dict(fig, device="jax cpu"), f, indent=1)
        if fig.get("config") == "sdf":
            fig = dict(fig, contacts={k: v for k, v in fig["contacts"].items()
                                      if k != "active"})
        print(json.dumps(dict(fig, device="jax cpu")), flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
