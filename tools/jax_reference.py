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

    python tools/jax_reference.py [--batch 256] [--configs 2,2b,4,5,5f,6s,catalog,6k]
        [--frames 1024] [--out-6s tools/jax_reference_6s.json]
        [--out-catalog tools/jax_reference_catalog.json] [--out-6k tools/jax_reference_6k.json]

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


CONFIGS = ("2", "2b", "4", "5", "5f", "6s", "catalog", "6k")


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
    for fig in figures:
        if fig.get("config") == "6s":
            motion = fig.pop("per_frame_motion")
            if args.out_6s:
                with open(args.out_6s, "w") as f:
                    json.dump(dict(fig, device="jax cpu"), f, indent=1)
                np.save(os.path.splitext(args.out_6s)[0] + "_per_frame.npy", motion)
            fig = {k: v for k, v in fig.items() if k not in ("identity", "locator_offsets")}
        for name, out in (("catalog", args.out_catalog), ("6k", args.out_6k)):
            if fig.get("config") == name and out:
                with open(out, "w") as f:
                    json.dump(dict(fig, device="jax cpu"), f, indent=1)
        print(json.dumps(dict(fig, device="jax cpu")), flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
