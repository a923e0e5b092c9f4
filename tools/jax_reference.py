"""The JAX package's CPU figures that chip_smoke.py holds the port against,
for benchmarks/bench_suite.py's configs 2 and 4, on the recipes of
momentum_tpu_torch/testing/workloads.py:

  * config 2: the single frame's final energy (LM 20, default options);
    2b on bench.py's full-stack problem (seed 0): Gauss-Newton 2 + 1 on the
    worst B/2 by marker energy, against each element's 40-iteration LM
    optimum on the normal equations: conv_at_1e5 and median_excess_vs_40it;
  * config 4: the single frame's final energy (LM 20 from zero); 4b (seed 1):
    GN 4 + 2 on the worst B/4, median_param_sq_err and the divergent count.

    python tools/jax_reference.py [--batch 256] [--configs 2 2b 4]

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--configs", nargs="+", choices=("2", "2b", "4"), default=("2", "2b", "4"))
    args = ap.parse_args()
    t0 = time.perf_counter()
    figures = []
    if "2" in args.configs:
        figures.append(config2_frame())
    if "2b" in args.configs:
        figures.append(config2b(args.batch))
    if "4" in args.configs:
        figures.extend(config4(args.batch))
    for fig in figures:
        print(json.dumps(dict(fig, device="jax cpu")), flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
