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

    python tools/jax_reference.py [--batch 256] [--configs 2,2b,4,5,5f,6s] [--frames 1024]
        [--out-6s tools/jax_reference_6s.json]

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


CONFIGS = ("2", "2b", "4", "5", "5f", "6s")


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
    for fig in figures:
        if fig.get("config") == "6s":
            motion = fig.pop("per_frame_motion")
            if args.out_6s:
                with open(args.out_6s, "w") as f:
                    json.dump(dict(fig, device="jax cpu"), f, indent=1)
                np.save(os.path.splitext(args.out_6s)[0] + "_per_frame.npy", motion)
            fig = {k: v for k, v in fig.items() if k not in ("identity", "locator_offsets")}
        print(json.dumps(dict(fig, device="jax cpu")), flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
