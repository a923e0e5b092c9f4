"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the CUDA
kernels, holds each against its plain PyTorch version at its path's shapes,
then drives the port's paths through those kernels and checks their output:

  * full-body batched marker IK at B = 2048 (LM 5 + 6 compacted on the worst
    128): kernels K1 (FK by binary lifting, held against its plain version
    at B = 2048 and at the clip's B = 32) and K2+K3 (damped Cholesky in
    32-wide panels), the latter held against its plain version and timed
    against cholesky_ex + cholesky_solve at the paths' batch sizes 2048, 128
    and 1024;
  * the shadowed render of a posed 32-frame clip at 640×480, 2×2
    supersampled (benchmarks/bench_suite.py config 7): K1, and K4b (binned
    plane rasterizer) for the camera and shadow-map passes of every frame,
    held against its plain version on passes with and without overflow
    tiles (frames 0, 5, 11), with each frame's overflow tiles and the
    device time of the clip's 64 launches;
  * the shadowed render of a mesh under the bin capacity (the clip's first
    120 faces): K4a (plane rasterizer, every face tested once per tile and
    scanned only where it may cover the tile), held against its plain
    version on that render's camera and shadow passes and on the clip's
    612-face camera pass unbinned;
  * K5's entry points (ops/chol_pallas.py), fed the full residual stack's
    normal equations at B = 2048 padded to n = 160: K5a and K5b (32-wide
    panels, n % 32 == 0), both reaching K2+K3's kernel;
  * bench.py's full residual stack (position + orientation + limits + pose
    prior) at B = 2048, Gauss-Newton 2 + 1 on the worst 1024: K1, K2+K3;
  * the repaired faults: the damped solve past the kernel's shared memory,
    with matrix right-hand sides and in float64 (ROADMAP F7), gradients
    through K1 (F8) and K4b's merge scratch grown after a launch on another
    stream (F9);
  * benchmarks/bench_suite.py config 2 on the full stack by Levenberg-
    Marquardt on the normal equations: the single frame (one system, K2+K3
    at B = 1), and 2b, the GN 2 + 1 solve at B = 2048 scored against each
    element's 40-iteration LM optimum (conv_at_1e5), at B = 256 too: K1,
    K2+K3;
  * config 4, the skinned-mesh fit of pose and 8 blend-shape coefficients
    to 306 vertices (P = 165): 4b at B = 256 (GN 4 + 2 on the worst 64) and
    the single frame by LM: K1, and K2+K3 at n = 165 (held against its
    plain version and timed at B = 256);
  * config 5 and 5f, the sequence solve of F = 1024 frames on the 16-joint
    test rig and on the full-body rig (GN 8 on the block-banded normal
    equations, SPIKE with 32 parts): K1 (the frame contexts, held at
    B = 1024) and K2+K3 (the SPIKE locals' batched Thomas steps, held at
    (32, 23) with 70 right-hand sides and (32, 156) with 470 on systems of
    the path), each config's final error against JAX CPU's; and the
    full-body sequence at F = 256 with an acceleration term, whose
    forward-mode Jacobians run through K1's jvp and vmap rules, held
    against the plain FK's;
  * config 6, marker tracking, on config 6s (a synthetic 343-frame × 41-
    marker clip on the CMU rig, 73 parameters): calibration, the locators-
    only round, per-frame tracking, the smoothed refine and hierarchical
    batched tracking, every pose solve by forward-mode Jacobians through
    K1 and steps through K2+K3: per stage frames/s, the marker errors
    against JAX CPU's and the launches; the AD Jacobian held against the
    analytic one at B = 343, K1 held at B = 1 and 343, K2+K3 at (1, 73) and
    (343, 73);
  * config C, batched IK at B = 2048 over every rigid module of the error
    catalog (position, both distorted cameras' projections, the projection
    matrix, aim, fixed axis, normal and distance in a union, joint-to-joint,
    state, the six limit record types, capsule and floor collision): LM 10
    on the normal equations, blockwise analytic Jacobians and forward mode
    through K1, K2+K3 at (2048, 157): each module's median energy,
    conv_at_1e5 and divergent count against JAX CPU's on the first 256
    elements; K2+K3 held at (2048, 157), the forward-mode rows through K1
    against the plain FK's;
  * config 6k, config 6s's clip with the 2D keypoints of four cameras:
    batched tracking from the calibrated identity and the refine, both with
    markers and keypoints, against JAX CPU's marker and reprojection errors;
    the forward-mode rows through K1 against the plain FK's at B = 343,
    K2+K3 held at (343, 73).

    python3 chip_smoke.py

Runs from the root of a checkout of the repo (it imports momentum_tpu_torch
from there). Needs one CUDA card and nvcc (the kernels build into
build/momentum_tpu_torch/ at first use). Imports nothing of JAX. Every failed
check raises, so the exit code is non-zero. A passing run prints, before its
last line, one JSON line
with each kernel's launches on its path, its error against the plain version,
its time, the plain version's, the library call's where one exists, and its
bound: the larger of its bytes (each input read once, each output written
once) at 3.35 TB/s and its f32 flops at 67 TFLOP/s, from this run's inputs
(for K4a, the flops of the faces its per-tile test keeps).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

BATCH = 2048
CLIP_FRAMES = 32  # the render clip's frames: K1's batch on that path
SEED = 0
FK_TOL = 2e-5  # abs, f32: kernel and plain version lift alike; PyTorch's kernels may fuse
# of the largest |component| of the plain states, where that is larger: the
# mm-scale CMU rig's translations reach ~2 000, whose float32 ulp is 1.2e-4
FK_REL_TOL = 1e-6
# of max|grad|: K1's backward is the plain VJP; index_select's backward sums atomically
FK_GRAD_TOL = 1e-5
PSD_RELRES_TOL = 1e-5  # max ‖(A+D)x − b‖/‖b‖; plain cholesky_ex gives ~2e-7 here
PSD_X_TOL = 1e-3  # max |x_kernel − x_plain| / max |x_plain|: κ reaches ~1e8 here
# where κ is larger (config 4b's blend-shape columns): the kernel's forward
# error against float64 within this factor of the plain float32 solve's
X_FWD_FACTOR = 10.0
CONV_MIN = 0.98  # JAX CPU runs of this workload give 0.99–1.0
RASTER_TOL = dict(depth=1e-5, bary=1e-5, attrs=1e-4)  # abs; face maps must be identical
# mean(imgs > 0) of config 7's 32-frame clip rendered by the JAX package on the
# CPU (its "auto" = windowed path; config 7's recipe, seed 0); PERF.md §6
CLIP_COVERAGE_JAX_CPU = 0.010333353678385417
CLIP_COVERAGE_RTOL = 0.02
# bench.py's full-stack recipe (GN 2 + 1 on the worst half) run by the JAX
# package on the CPU at B = 256, seed 0: marker conv@1e-5 and median marker
# energy (PERF.md §2)
FULLSTACK_CONV_JAX_CPU = 1.0
FULLSTACK_MEDIAN_JAX_CPU = 5.70412e-08
FULLSTACK_CONV_SLACK = 0.01
# benchmarks/bench_suite.py configs 2 and 4 run by the JAX package on the CPU
# (tools/jax_reference.py, the recipes of testing/workloads.py): config 2's
# single-frame LM energy; 2b's conv_at_1e5 (GN 2 + 1 within 1e-5 of each
# element's 40-iteration LM optimum) at B = 2048 and 256, seed 0; config 4's
# single-frame LM energy; 4b's median_param_sq_err at B = 256, seed 1
CONFIG2_FRAME_ENERGY_JAX_CPU = 0.002596117788925767
CONFIG2B_CONV_JAX_CPU = {2048: 0.029296875, 256: 0.078125}
CONFIG2B_CONV_SLACK = 0.01
CONFIG4_FRAME_ENERGY_JAX_CPU = 0.00023250572849065065
CONFIG4B_PARAM_SQ_ERR_JAX_CPU = 4.2157122237540534e-10
# the frame energies on the card against JAX on the CPU (the port on the CPU
# matches to 7e-7 and 1.1e-5: tests/test_torch_port_{lm_normal,vertex}.py)
FRAME_ENERGY_RTOL = 1e-2
# 4b's median_param_sq_err: the port on the CPU is within 1.015 of JAX at B = 16
CONFIG4B_FACTOR = 2.0
SMALL_MESH_FACES = 120  # ≤ bin_capacity 128: the render takes K4a
# the batch sizes the paths give K2+K3: IK 2048 and its compacted 128, the
# full stack's refinement on 1024 (testing/workloads.py)
PSD_BATCHES = (BATCH, 128, 1024)
# benchmarks/bench_suite.py config 5 (the 16-joint test rig) and 5f (the
# full-body rig) at F = 1024, GN 8, run by the JAX package on the CPU
# (python tools/jax_reference.py --configs 5,5f): the final error; both run
# their 8 iterations without converging
SEQUENCE_FRAMES = 1024
SEQUENCE_ERROR_JAX_CPU = {"5": 5.676108360290527, "5f": 414.1357116699219}
SEQUENCE_ITERATIONS_JAX_CPU = 8
SEQUENCE_RTOL = 1e-2  # the port on the CPU matches JAX to 1e-5 at F = 130
# the normal equations with an acceleration term through K1 against the same
# with FK on the plain version: max|Δ| / max|block| per block
SEQUENCE_NE_RTOL = 1e-4
ACCEL_FRAMES = 256
# benchmarks/bench_suite.py config 6's five stages on config 6s, the synthetic
# 343-frame clip of testing/workloads.py::build_tracking_clip, run by the JAX
# package on the CPU (python tools/jax_reference.py --configs 6s --out-6s
# tools/jax_reference_6s.json): per stage the median and p90 marker error (mm)
# over the visible markers of its motion (the calibration stages' over their 10
# sampled frames), the calibrated scale_global, and the calibration's outputs
# (identity, locator offsets). JAX's calibration reverts its scale solve (a NaN
# step, the NaN guard): scale_global stays at its start, 0.0 (ROADMAP F14)
TRACKING_JAX_CPU_FILE = "tools/jax_reference_6s.json"
TRACKING_JAX_CPU_MOTION_FILE = "tools/jax_reference_6s_per_frame.npy"
TRACKING_MEDIAN_RTOL, TRACKING_MEDIAN_ATOL_MM = 0.02, 0.02
TRACKING_P90_RTOL = 0.05
# the two calibration stages' motions are LM fits from the rest pose, cut at
# 25 iterations before they converge: their iterates split between float32
# implementations after a few accepted steps (frame 0: 2e-4 apart after one,
# 2.4 mm after ten, the port against JAX on the CPU), so their medians are
# held like the p90s (the port on the CPU lands 0.3% and 2.6% from JAX's). The
# later stages take JAX's inputs, so that each is held to JAX's on the same
# ones: per-frame and hierarchical tracking JAX's calibrated rig and identity,
# the refine JAX's per-frame motion. The refine's result moves with the input's
# components along the rig's near-null directions (collinear clavicle and
# shoulder x axes): JAX's own refine moves 3% in the median and 5.5% in the
# p90 under a 1e-6 perturbation of its input (PERF.md §6)
TRACKING_CALIBRATION_MEDIAN_RTOL = 0.05
TRACKING_SCALE_TOL = 2e-3  # against JAX CPU's
TRACKING_TRUE_SCALE = 0.1  # the clip's truth, printed beside the result
# the forward-mode Jacobian through K1 against the analytic one, of max|J|
AD_JAC_RTOL = 1e-4
# config C, batched IK over the whole rigid error catalog at B = 2048, held
# on its first 256 elements (the same draws at every batch size) against the
# JAX package on the CPU (python tools/jax_reference.py --configs catalog
# --out-catalog tools/jax_reference_catalog.json): every module's median
# final energy within 20% (an energy under 1e-8 of the median total is float32
# roundoff of a converged term: held to that), conv_at_1e5 within 0.01, no
# divergent element
CATALOG_JAX_CPU_FILE = "tools/jax_reference_catalog.json"
CATALOG_HELD = 256
CATALOG_MEDIAN_RTOL, CATALOG_MEDIAN_FLOOR = 0.2, 1e-8
CATALOG_CONV_SLACK = 0.01
# forward-mode rows through K1 against the same through fk_global_plain, of max|J|
AD_K1_RTOL = 1e-5
# config 6k, config 6s's clip with the four cameras' keypoints, against JAX CPU
# (python tools/jax_reference.py --configs 6k --out-6k tools/jax_reference_6k.json):
# config 6s's tolerances, the median reprojection error held like the medians
KEYPOINTS_JAX_CPU_FILE = "tools/jax_reference_6k.json"


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    try:
        from momentum_tpu_torch.testing.profile_workload import card_name_and_power_limit
    except ModuleNotFoundError as e:
        raise RuntimeError("chip_smoke.py runs from the root of a checkout of the repo: "
                           "momentum_tpu_torch is not importable here") from e

    kind = torch.cuda.get_device_name(0)
    smi = card_name_and_power_limit()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return kind, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from momentum_tpu_torch.ops import build

    names = ("fk", "psd", "raster")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.build, names))
    for name in names:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name in names:
        log = str(build.build(name)) + ".log"  # already built: returns the path
        with open(log) as f:
            print(f"  csrc/{name}.cu ptxas: " + " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln))


def _hold_fk(skel, local, label):
    """K1 against the plain version on local states (B, nJ, 8): max error,
    the kernel's time (CUDA events around launches queued behind a sleep
    kernel, and the profiler's device time), the plain version's, the bound."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.testing.profile_workload import (
        bound, event_ms, fmt_ms, kernel_device_ms)

    batch = local.shape[0]
    out = fk_ops.fk_global(skel, local)
    ref = fk_ops.fk_global_plain(skel, local)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = max(FK_TOL, FK_REL_TOL * float(ref.abs().max()))
    ms = event_ms(lambda: fk_ops.fk_global(skel, local), busy=True)
    dev_ms = kernel_device_ms(lambda: fk_ops.fk_global(skel, local), "fk_global_kernel")
    plain_ms = event_ms(lambda: fk_ops.fk_global_plain(skel, local))
    # local states read, global states written, the lifting table; one
    # skel_state compose per joint: quaternion product 28 flops, rotated
    # and scaled translation 36, scale 1
    b_fk = bound(2 * local.numel() * 4 + skel.prefix_table.numel() * 4,
                 batch * local.shape[1] * 65)
    print(f"K1 fk_global_kernel (B={batch}, nJ={local.shape[1]}, "
          f"{skel.prefix_table.shape[0]} levels, {label}): max|kernel - plain| = {err:.3e} "
          f"(tol {tol:.1e}); kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
          f"{plain_ms:.4f} ms, bound {b_fk['bound_ms']:.6f} ms ({b_fk['bound_by']}), "
          f"{b_fk['bound_ms'] / ms:.1%} of it")
    if not err <= tol:
        raise AssertionError(f"fk_global_kernel disagrees with the plain FK at "
                             f"B = {batch} ({label}): {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_fk, library_ms=None,
                device_ms=dev_ms)


def phase_fk(char, x0):
    """K1 against the plain version at the IK path's B = 2048 and the
    clip's B = 32 (one launch for all its frames)."""
    from momentum_tpu_torch.character import fk

    skel = char.skeleton
    local_all = fk.local_skel_states(skel, char.parameter_transform.apply(x0)).contiguous()
    numbers = {batch: _hold_fk(skel, local_all[:batch].contiguous(), label)
               for batch, label in ((BATCH, "IK path"), (CLIP_FRAMES, "the clip's frames"))}
    return numbers[BATCH], numbers


def phase_psd(char, ef0, targets, x0):
    """K2+K3 on the IK path's own normal equations at x0 (LM damping), at the
    batch sizes the paths give it: against the plain version by relative
    residual and by x, timed in turns against the library's
    cholesky_ex + cholesky_solve; then ROADMAP F1 with pivots that fail in
    the first panel, the third, and the ragged last one."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import (
        fmt_ms, in_turns, kernel_device_ms, library_solve, solve_bound)

    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    rows, j = fn.residual_and_jacobian(x0)
    jt = j.transpose(-1, -2)
    a_all = (jt @ j).contiguous()
    b_all = (jt @ rows[..., None])[..., 0].contiguous()
    d_all = (0.01 * torch.clamp(a_all.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    del rows, j, jt

    def relres(a, damp, b, sol):
        ad = (a + torch.diag_embed(damp)).double()
        r = (ad @ sol.double()[..., None])[..., 0] - b.double()
        return float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())

    numbers = {}
    for batch in PSD_BATCHES:
        a, damp, b = (t[:batch].contiguous() for t in (a_all, d_all, b_all))
        n = a.shape[1]
        x = psd.damped_chol_solve(a, damp, b)
        x_plain = psd.damped_chol_solve_plain(a, damp, b)
        res_k, res_p = relres(a, damp, b, x), relres(a, damp, b, x_plain)
        err = float((x - x_plain).abs().max())
        x_rel = err / float(x_plain.abs().max())
        t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, damp, b),
                      "library": library_solve(a, damp, b),
                      "plain": lambda: psd.damped_chol_solve_plain(a, damp, b)})
        dev_ms = kernel_device_ms(lambda: psd.damped_chol_solve(a, damp, b),
                                  "damped_chol_solve_kernel")
        lib_dev_ms = kernel_device_ms(library_solve(a, damp, b), "", per_call=None)
        b_psd = solve_bound(batch, n)
        print(f"K2+K3 damped_chol_solve_kernel (B={batch}, n={n}, IK normal equations): "
              f"max rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (tol "
              f"{PSD_RELRES_TOL:.0e}); max|x_kernel - x_plain| = {err:.3e} ({x_rel:.3e} of "
              f"max|x|, tol {PSD_X_TOL:.0e}); in turns: kernel {t['kernel']:.4f} ms, library "
              f"cholesky_ex + cholesky_solve {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
              f"device time kernel {fmt_ms(dev_ms)} ms, library {fmt_ms(lib_dev_ms)} ms; bound "
              f"{b_psd['bound_ms']:.4f} ms ({b_psd['bound_by']}), "
              f"{b_psd['bound_ms'] / t['kernel']:.1%} of it")
        if not (res_k <= PSD_RELRES_TOL and x_rel <= PSD_X_TOL):
            raise AssertionError(f"damped_chol_solve_kernel disagrees with the plain solve "
                                 f"at B = {batch}")
        numbers[batch] = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                              **b_psd, library_ms=t["library"], device_ms=dev_ms,
                              library_device_ms=lib_dev_ms)

    # ROADMAP F1: a system whose pivot fails comes back all-NaN from both
    # versions, in the first 32-wide panel, the third, the ragged last one
    # (row 150 of 157) or through a NaN; its neighbours are unaffected
    bad = a_all[:6].clone()
    bad[1, 5, 5] = bad[2, 70, 70] = bad[3, 150, 150] = -1e6
    bad[4, 100, 100] = float("nan")
    want_nan = [False, True, True, True, True, False]
    for name, solve in (("kernel", psd.damped_chol_solve),
                        ("plain", psd.damped_chol_solve_plain)):
        xb = solve(bad, d_all[:6].contiguous(), b_all[:6].contiguous())
        nan_rows = torch.isnan(xb).all(dim=-1).tolist()
        finite_rows = torch.isfinite(xb).all(dim=-1).tolist()
        if nan_rows != want_nan or finite_rows != [not w for w in want_nan]:
            raise AssertionError(f"F1: {name} solve of indefinite systems gave "
                                 f"nan rows {nan_rows}, finite rows {finite_rows}")
    print("K2+K3 F1: systems failing in panels 1, 3 and the ragged last one, and a NaN, "
          "are all-NaN in kernel and plain, their neighbours finite")
    return numbers[BATCH], numbers


def phase_main_path(char, ef0, targets, x0, smi):
    from momentum_tpu_torch.ops import fk as fk_ops, psd
    from momentum_tpu_torch.testing.workloads import make_solve_batch

    solve = make_solve_batch(char, ef0, BATCH)
    solve(targets, x0)  # warm-up: library loads, cuBLAS/cuSOLVER handles
    torch.cuda.synchronize()
    fk_ops.launches = 0
    psd.launches = 0
    t0 = time.perf_counter()
    res = solve(targets, x0)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches,
              "damped_chol_solve_kernel": psd.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        solve(targets, x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    e = res.error.cpu().numpy()
    conv = float(np.mean(e < 1e-5))
    med = float(np.nanmedian(e))
    div = float(np.mean(~np.isfinite(e)))
    wall = statistics.median(walls)
    print(f"main path (B={BATCH}, LM 5 + 6 compacted on 128, {res.iterations} iterations): "
          f"conv@1e-5 {conv:.4f}, median sum-r2 {med:.3e}, divergent {div:.4f}, "
          f"batch wall {wall * 1e3:.1f} ms (median of {len(walls)}), "
          f"{BATCH / wall:.0f} solves/s on {smi}; kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"the main path did not run through every kernel: {counts}")
    if res.params.shape != x0.shape or not bool(torch.isfinite(res.params).all()):
        raise AssertionError("main path: parameters of the wrong shape or not finite")
    if not (div == 0.0 and conv >= CONV_MIN):
        raise AssertionError(f"main path accuracy: divergent {div}, conv@1e-5 {conv}")
    return counts


def phase_small_reference():
    """The main path at B = 64 on the card (kernels) and on the CPU (plain
    versions) from the same seed: the same convergence statistics. The
    tolerances are the CPU parity tests' against the JAX package."""
    from momentum_tpu_torch.testing.workloads import (
        build_fullbody_ik_problem, make_solve_batch)

    stats = {}
    for device in ("cuda", "cpu"):
        char, ef0, targets, x0 = build_fullbody_ik_problem(64, seed=SEED, device=device)
        e = make_solve_batch(char, ef0, 64)(targets, x0).error.cpu().numpy()
        stats[device] = (float(np.mean(e < 1e-5)), float(np.median(e)), bool(np.isfinite(e).all()))
    (conv_g, med_g, fin_g), (conv_c, med_c, _) = stats["cuda"], stats["cpu"]
    print(f"small reference (B=64): card conv@1e-5 {conv_g:.4f} median {med_g:.3e}; "
          f"cpu plain conv@1e-5 {conv_c:.4f} median {med_c:.3e}")
    if not (fin_g and abs(conv_g - conv_c) <= 2 / 64 and abs(med_g / med_c - 1) <= 0.2):
        raise AssertionError("the card's B = 64 solve disagrees with the CPU's")


def phase_chol(char, efs, targets, q, x0):
    """K5a and K5b on the full stack's own normal equations at x0 (B = 2048,
    n = 157), padded to n = 160 with identity rows and columns and zero
    damping: the path's run (each entry point once, counted); K2+K3's kernel
    on the unpadded n = 157 systems against the plain solve; then each
    kernel against its plain version by relative residual, and against the
    plain solve of the unpadded system; times in turns with the library's
    cholesky_ex + cholesky_solve; ROADMAP F1 and F6. Both entry points reach
    K2+K3's kernel (32-wide panels, csrc/psd.cu), which counts the launches."""
    from momentum_tpu_torch.ops import chol, psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import in_turns, library_solve, solve_bound

    fn = SkeletonSolverFunction(char, (dataclasses.replace(efs[0], target=targets),
                                       dataclasses.replace(efs[1], target=q), *efs[2:]))
    jtj, jtr, _ = fn.normal_equations(x0)
    damp = torch.full_like(jtr, 1e-5)  # the full stack's GN regularization
    a, d, b = chol.pad_identity(jtj.contiguous(), damp, jtr.contiguous())
    xs, counts = {}, {}
    for name, entry in (("K5a", chol.chol_solve), ("K5b", chol.chol_solve_blocked)):
        torch.cuda.synchronize()
        psd.launches = 0
        xs[name] = entry(a, d, b)
        torch.cuda.synchronize()
        counts[name] = psd.launches
    if counts != {"K5a": 1, "K5b": 1}:
        raise AssertionError(f"K5's entry points did not launch damped_chol_solve_kernel: "
                             f"{counts}")

    def relres(sol, a=a, d=d, b=b):
        ad = (a + torch.diag_embed(d)).double()
        r = (ad @ sol.double()[..., None])[..., 0] - b.double()
        return float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())

    # the kernel's own padding (157 -> 160 rows in shared memory) on the
    # unpadded systems, held against the plain solve
    ju, ru = jtj.contiguous(), jtr.contiguous()
    x_unpadded = psd.damped_chol_solve_plain(ju, damp, ru)
    x_k23 = psd.damped_chol_solve(ju, damp, ru)
    res_u = relres(x_k23, ju, damp, ru)
    x_rel_u = float((x_k23 - x_unpadded).abs().max() / x_unpadded.abs().max())
    print(f"K2+K3 damped_chol_solve_kernel (B={ju.shape[0]}, n={ju.shape[1]} unpadded, "
          f"full-stack normal equations): max rel. residual {res_u:.3e} (tol "
          f"{PSD_RELRES_TOL:.0e}); max|x - x_plain| {x_rel_u:.3e} of max|x| (tol {PSD_X_TOL:.0e})")
    if not (res_u <= PSD_RELRES_TOL and x_rel_u <= PSD_X_TOL):
        raise AssertionError("damped_chol_solve_kernel disagrees with the plain solve on the "
                             "full stack's unpadded systems")
    numbers = {}
    for name, x, plain in (("K5a chol_solve -> damped_chol_solve_kernel", xs["K5a"],
                            chol.chol_solve_plain),
                           ("K5b chol_solve_blocked -> damped_chol_solve_kernel", xs["K5b"],
                            chol.chol_solve_blocked_plain)):
        x_plain = plain(a, d, b)
        res_k, res_p = relres(x), relres(x_plain)
        err = float((x - x_plain).abs().max())
        x_rel = err / float(x_plain.abs().max())
        to_unpadded = float((x[:, :157] - x_unpadded).abs().max() / x_unpadded.abs().max())
        pad_max = float(x[:, 157:].abs().max())
        kernel = chol.chol_solve if name.startswith("K5a") else chol.chol_solve_blocked
        t = in_turns({"kernel": lambda: kernel(a, d, b), "library": library_solve(a, d, b),
                      "plain": lambda: plain(a, d, b)})
        b_k5 = solve_bound(a.shape[0], a.shape[1])
        print(f"{name} (B={a.shape[0]}, n={a.shape[1]} padded from 157, full-stack normal "
              f"equations): max rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (tol "
              f"{PSD_RELRES_TOL:.0e}); max|x - x_plain| = {err:.3e} ({x_rel:.3e} of max|x|, tol "
              f"{PSD_X_TOL:.0e}); against the plain solve unpadded {to_unpadded:.3e} of max|x|; "
              f"padding rows max|x| {pad_max:.1e}; in turns: kernel {t['kernel']:.4f} ms, "
              f"library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; bound "
              f"{b_k5['bound_ms']:.4f} ms ({b_k5['bound_by']})")
        if not (res_k <= PSD_RELRES_TOL and x_rel <= PSD_X_TOL and to_unpadded <= PSD_X_TOL
                and pad_max == 0.0):
            raise AssertionError(f"{name} disagrees with the plain solve")
        numbers[name[:3]] = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], **b_k5,
                                 library_ms=t["library"])

    # ROADMAP F1: an indefinite system (its pivot fails in the third panel)
    # comes back all-NaN from every version, its neighbours finite
    bad = a[:4].clone()
    bad[2, 70, 70] = -1e3
    for name, solve in (("K5a", chol.chol_solve), ("K5b", chol.chol_solve_blocked),
                        ("plain", chol.chol_solve_blocked_plain)):
        xb = solve(bad, d[:4].contiguous(), b[:4].contiguous())
        nan_rows = torch.isnan(xb).all(dim=-1).tolist()
        finite_rows = torch.isfinite(xb).all(dim=-1).tolist()
        if nan_rows != [False, False, True, False] or finite_rows != [True, True, False, True]:
            raise AssertionError(f"F1: {name} solve of an indefinite system gave "
                                 f"nan rows {nan_rows}, finite rows {finite_rows}")
    # ROADMAP F6: the blocked entry point refuses n % 32 != 0
    try:
        chol.chol_solve_blocked(jtj.contiguous(), damp, jtr.contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("F6: chol_solve_blocked took n = 157")
    print("K5 F1: the indefinite system is all-NaN in K5a, K5b and plain, its neighbours "
          "finite; F6: chol_solve_blocked refuses n = 157")
    return counts, numbers


def phase_full_stack(char, efs, targets, q, x0, smi):
    """bench.py's full residual stack at B = 2048: GN 2 full-batch + 1 on the
    worst 1024 by marker energy, through K1 and K2+K3; 3 timed runs."""
    from momentum_tpu_torch.ops import fk as fk_ops, psd
    from momentum_tpu_torch.testing.workloads import make_fullstack_solve

    solve = make_fullstack_solve(char, efs, BATCH)
    solve(targets, q, x0)  # warm-up
    torch.cuda.synchronize()
    fk_ops.launches = psd.launches = 0
    t0 = time.perf_counter()
    params, energy, _ = solve(targets, q, x0)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches, "damped_chol_solve_kernel": psd.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        solve(targets, q, x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    e = energy.cpu().numpy()
    conv = float(np.mean(e < 1e-5))
    med = float(np.nanmedian(e))
    div = float(np.mean(~np.isfinite(e)))
    wall = statistics.median(walls)
    print(f"full stack (B={BATCH}, pos + ori + limits + pose prior, GN 2 + 1 on the worst "
          f"1024): marker conv@1e-5 {conv:.4f} (JAX CPU at B=256: {FULLSTACK_CONV_JAX_CPU:.4f}), "
          f"median marker energy {med:.4e} (JAX CPU {FULLSTACK_MEDIAN_JAX_CPU:.4e}), divergent "
          f"{div:.4f}, batch wall {wall * 1e3:.1f} ms (median of {len(walls)}), "
          f"{BATCH / wall:.0f} solves/s on {smi}; kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"the full stack did not run through every kernel: {counts}")
    if params.shape != x0.shape or not bool(torch.isfinite(params).all()):
        raise AssertionError("full stack: parameters of the wrong shape or not finite")
    if not (div == 0.0 and conv >= FULLSTACK_CONV_JAX_CPU - FULLSTACK_CONV_SLACK):
        raise AssertionError(f"full stack accuracy: divergent {div}, conv@1e-5 {conv}")
    return counts


def _counts():
    from momentum_tpu_torch.ops import fk as fk_ops, psd

    return {"fk_global_kernel": fk_ops.launches, "damped_chol_solve_kernel": psd.launches}


def _reset_counts():
    from momentum_tpu_torch.ops import fk as fk_ops, psd

    torch.cuda.synchronize()
    fk_ops.launches = psd.launches = 0


def phase_config2_lm(smi):
    """bench_suite.py config 2: the full stack's single frame by LM (x0 of
    shape (P,): K2+K3 on one system an iteration), then 2b at B = 2048: the
    GN 2 + 1 solve's energy against each element's 40-iteration LM optimum on
    the normal equations (conv_at_1e5, median_excess_vs_40it); both counted.
    2b again at B = 256 (not counted), the batch of the second JAX figure."""
    from momentum_tpu_torch.testing.workloads import (
        build_fullstack_frame, build_fullstack_problem, fullstack_lm_optimum,
        make_fullstack_solve, solve_fullstack_frame)

    char, efs, x0 = build_fullstack_frame(seed=SEED, device="cuda")
    solve_fullstack_frame(char, efs, x0)  # warm-up
    _reset_counts()
    t0 = time.perf_counter()
    res = solve_fullstack_frame(char, efs, x0)
    energy = float(res.error)
    frame_ms = (time.perf_counter() - t0) * 1e3
    frame_counts = counts = _counts()
    if res.params.shape != x0.shape or not bool(torch.isfinite(res.params).all()):
        raise AssertionError("config 2 frame: parameters of the wrong shape or not finite")
    print(f"config 2 frame (full stack, LM {res.iterations} iterations, one system of n = "
          f"{x0.shape[0]}): energy {energy:.6e} (JAX CPU {CONFIG2_FRAME_ENERGY_JAX_CPU:.6e}), "
          f"wall {frame_ms:.1f} ms on {smi}; kernel launches {frame_counts}")
    if not abs(energy / CONFIG2_FRAME_ENERGY_JAX_CPU - 1) <= FRAME_ENERGY_RTOL:
        raise AssertionError(f"config 2 frame: energy {energy} is not within "
                             f"{FRAME_ENERGY_RTOL} of the JAX CPU figure")
    numbers = dict(frame_energy=energy)
    for batch in (BATCH, 256):
        char, efs, targets, q, x0 = build_fullstack_problem(batch, seed=SEED, device="cuda")
        _reset_counts()
        _, marker, err = make_fullstack_solve(char, efs, batch)(targets, q, x0)
        t0 = time.perf_counter()
        ref = fullstack_lm_optimum(char, efs, targets, q, x0)
        excess = (err - ref.error).cpu().numpy()
        lm_ms = (time.perf_counter() - t0) * 1e3
        if batch == BATCH:
            counts = {k: n + frame_counts[k] for k, n in _counts().items()}
        conv, med = float(np.mean(excess < 1e-5)), float(np.median(excess))
        want = CONFIG2B_CONV_JAX_CPU[batch]
        print(f"config 2b (B={batch}, full stack GN 2 + 1 against the {ref.iterations}-iteration "
              f"LM optimum on the normal equations): conv_at_1e5 {conv:.6f} (JAX CPU {want:.6f}), "
              f"median_excess_vs_40it {med:.6e}, marker conv@1e-5 "
              f"{float((marker < 1e-5).float().mean()):.4f}; the LM optimum took {lm_ms:.1f} ms")
        if not (np.isfinite(excess).all() and abs(conv - want) <= CONFIG2B_CONV_SLACK):
            raise AssertionError(f"config 2b at B = {batch}: conv_at_1e5 {conv} is not within "
                                 f"{CONFIG2B_CONV_SLACK} of the JAX CPU figure {want}")
        numbers[f"conv_at_1e5_B{batch}"] = conv
        numbers[f"median_excess_vs_40it_B{batch}"] = med
    print(f"config 2 path (frame LM + 2b at B={BATCH}) kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 2 did not run through every kernel: {counts}")
    return counts, numbers


def phase_vertex_fit(smi):
    """bench_suite.py config 4: 4b at B = 256 (3 timed runs, the first
    counted) and the single frame by LM (counted with it); then K2+K3 at
    config 4b's n = 165 on its own normal equations at x0, held against the
    plain version and timed in turns with the library call."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import in_turns, library_solve, solve_bound
    from momentum_tpu_torch.testing.workloads import (
        VERTEX_FIT_BATCH, build_vertex_fit_problem, make_vertex_fit_solve,
        solve_vertex_fit_frame)

    prob = build_vertex_fit_problem(VERTEX_FIT_BATCH, device="cuda")
    batch = prob.x0.shape[0]
    solve = make_vertex_fit_solve(prob.char, prob.ef0, batch)
    solve(prob.targets, prob.x0)  # warm-up
    _reset_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solve(prob.targets, prob.x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            counts_4b = _counts()
    _reset_counts()
    frame = solve_vertex_fit_frame(prob.char, prob.ef0, prob.targets_frame,
                                   torch.zeros_like(prob.gt_frame))
    frame_energy = float(frame.error)
    counts_frame = _counts()
    counts = {k: counts_4b[k] + counts_frame[k] for k in counts_4b}
    sq = ((res.params - prob.gt) ** 2).sum(-1).cpu().numpy()
    divergent = int((~np.isfinite(sq)).sum())
    med = float(np.median(sq))
    wall = statistics.median(walls)
    print(f"config 4b (B={batch}, P={prob.char.num_model_parameters}, {prob.ef0.num_rows()} "
          f"vertex rows, GN 4 + 2 on the worst 64): {batch / wall:.0f} solves/s (median wall "
          f"{wall * 1e3:.1f} ms of {len(walls)}) on {smi}; median_param_sq_err {med:.6e} (JAX "
          f"CPU {CONFIG4B_PARAM_SQ_ERR_JAX_CPU:.6e}), divergent {divergent}; kernel launches "
          f"{counts_4b}")
    print(f"config 4 frame (LM {frame.iterations} iterations from zero, one system of n = "
          f"{prob.gt_frame.shape[0]}): energy {frame_energy:.6e} (JAX CPU "
          f"{CONFIG4_FRAME_ENERGY_JAX_CPU:.6e}); kernel launches {counts_frame}")
    if divergent or not 1 / CONFIG4B_FACTOR <= med / CONFIG4B_PARAM_SQ_ERR_JAX_CPU <= CONFIG4B_FACTOR:
        raise AssertionError(f"config 4b: median_param_sq_err {med} not within a factor "
                             f"{CONFIG4B_FACTOR} of the JAX CPU figure, or {divergent} divergent")
    if not abs(frame_energy / CONFIG4_FRAME_ENERGY_JAX_CPU - 1) <= FRAME_ENERGY_RTOL:
        raise AssertionError(f"config 4 frame: energy {frame_energy} is not within "
                             f"{FRAME_ENERGY_RTOL} of the JAX CPU figure")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 4 did not run through every kernel: {counts}")

    fn = SkeletonSolverFunction(prob.char, (dataclasses.replace(prob.ef0, target=prob.targets),))
    rows, j = fn.residual_and_jacobian(prob.x0)
    jt = j.transpose(-1, -2)
    a = (jt @ j).contiguous()
    b = (jt @ rows[..., None])[..., 0].contiguous()
    d = torch.full_like(b, 1e-5)  # 4b's GN regularization
    x = psd.damped_chol_solve(a, d, b)
    x_plain = psd.damped_chol_solve_plain(a, d, b)
    ad = (a + torch.diag_embed(d)).double()
    r = (ad @ x.double()[..., None])[..., 0] - b.double()
    relres = float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())
    err = float((x - x_plain).abs().max())
    # the blend-shape columns are ~1e-2 of the pose columns and the damping
    # 1e-5: x is held by its forward error against the float64 solve, next
    # to the plain float32 solve's own, not by PSD_X_TOL
    x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
    fwd = {name: float((sol.double() - x64).abs().max() / x64.abs().max())
           for name, sol in (("kernel", x), ("plain", x_plain))}
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "library": library_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    b_psd = solve_bound(*a.shape[:2])
    print(f"K2+K3 damped_chol_solve_kernel (B={a.shape[0]}, n={a.shape[1]}, config 4b's normal "
          f"equations at x0): max rel. residual {relres:.3e} (tol {PSD_RELRES_TOL:.0e}); "
          f"max|x - x_plain| {err / float(x_plain.abs().max()):.3e} of max|x|; forward error "
          f"against float64 kernel {fwd['kernel']:.3e} / plain {fwd['plain']:.3e} (kernel's "
          f"tol: {X_FWD_FACTOR:.0f}x the plain's, at least {PSD_X_TOL:.0e}); in turns: kernel "
          f"{t['kernel']:.4f} ms, library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
          f"bound {b_psd['bound_ms']:.4f} ms ({b_psd['bound_by']}), "
          f"{b_psd['bound_ms'] / t['kernel']:.1%} of it")
    if not (relres <= PSD_RELRES_TOL
            and fwd["kernel"] <= max(PSD_X_TOL, X_FWD_FACTOR * fwd["plain"])):
        raise AssertionError("damped_chol_solve_kernel disagrees with the plain solve on "
                             "config 4b's normal equations")
    numbers = dict(solves_per_s=batch / wall, median_param_sq_err=med, divergent=divergent,
                   frame_energy=frame_energy,
                   psd_256x165=dict(max_abs_err=err, forward_error=fwd, ms=t["kernel"],
                                    plain_ms=t["plain"], **b_psd, library_ms=t["library"]))
    return counts, numbers


def _hold_psd_matrix(a, d, b, label):
    """K2+K3 on (B, n, n) systems with (B, n, k) or (B, n) right-hand sides, held
    against the plain version by the rule for ill-conditioned systems:
    its relative residual and its forward error against the float64 solve
    each within X_FWD_FACTOR of the plain float32 solve's (at least
    PSD_RELRES_TOL and PSD_X_TOL). A SPIKE step's Schur complement, its
    spike columns ~1e-3 of the rest, leaves the plain solve itself a
    residual of ~2e-3 in some columns (config 5, measured on one H100). The kernel,
    the library's cholesky_ex + cholesky_solve and the plain version timed
    in turns; the bound."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.testing.profile_workload import (
        fmt_ms, in_turns, kernel_device_ms, library_solve, solve_bound)

    batch, n = b.shape[:2]
    k = b.shape[2] if b.ndim == 3 else 1
    x = psd.damped_chol_solve(a, d, b)
    x_plain = psd.damped_chol_solve_plain(a, d, b)
    res_k, res_p = _relres_cols(a, d, b, x), _relres_cols(a, d, b, x_plain)
    err = float((x - x_plain).abs().max())
    x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
    fwd = {name: float((sol.double() - x64).abs().max() / x64.abs().max())
           for name, sol in (("kernel", x), ("plain", x_plain))}
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "library": library_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    dev_ms = kernel_device_ms(lambda: psd.damped_chol_solve(a, d, b), "damped_chol_solve_kernel")
    b_psd = solve_bound(batch, n, k)
    print(f"K2+K3 damped_chol_solve_kernel (B={batch}, n={n}, k={k}, {label}): max rel. "
          f"residual kernel {res_k:.3e} / plain {res_p:.3e} (kernel's tol: {X_FWD_FACTOR:.0f}x "
          f"the plain's, at least {PSD_RELRES_TOL:.0e}); max|x - x_plain| "
          f"{err / float(x_plain.abs().max()):.3e} of max|x|; forward error "
          f"against float64 kernel {fwd['kernel']:.3e} / plain {fwd['plain']:.3e} (kernel's "
          f"tol: {X_FWD_FACTOR:.0f}x the plain's, at least {PSD_X_TOL:.0e}); in turns: kernel "
          f"{t['kernel']:.4f} ms, library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
          f"device time kernel {fmt_ms(dev_ms)} ms; bound {b_psd['bound_ms']:.4f} ms "
          f"({b_psd['bound_by']}), {b_psd['bound_ms'] / t['kernel']:.1%} of it")
    if not (res_k <= max(PSD_RELRES_TOL, X_FWD_FACTOR * res_p)
            and fwd["kernel"] <= max(PSD_X_TOL, X_FWD_FACTOR * fwd["plain"])):
        raise AssertionError(f"damped_chol_solve_kernel disagrees with the plain solve on "
                             f"{label}")
    return dict(max_abs_err=err, forward_error=fwd, ms=t["kernel"], plain_ms=t["plain"],
                **b_psd, library_ms=t["library"], device_ms=dev_ms, batch_n_k=[batch, n, k])


def _sequence_systems(fn, pf, u, k):
    """The (a, damp, b) of the last K2+K3 call with k right-hand sides in one
    GN iteration of solve_sequence: a SPIKE forward step's Schur complement
    as the sequence path assembles it."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.sequence import solve_sequence
    from momentum_tpu_torch.solver import SolverOptions

    seen = []
    real = psd.damped_chol_solve

    def record(a, damp, b):
        if b.ndim == 3 and b.shape[-1] == k:
            seen[:] = [(a.clone(), damp.clone(), b.clone())]
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        solve_sequence(fn, pf, u, SolverOptions(max_iterations=1))
    finally:
        psd.damped_chol_solve = real
    if not seen:
        raise AssertionError(f"the sequence solve gave K2+K3 no system with {k} right-hand sides")
    return seen[0]


def phase_sequence(smi):
    """bench_suite.py config 5 (16-joint test rig) and 5f (full-body rig) at
    F = 1024: GN 8 on the block-banded normal equations, SPIKE with 32 parts
    whose batched Thomas steps run K2+K3 on (32, p, p) systems; the frame
    contexts through K1. For each: frames/s (F over the median wall of 3
    warm solves, the first counted), the final error against JAX CPU's, the
    wall of one GN iteration, the device idle share of a profiled solve, the
    peak device memory; K1 held at B = 1024 on the rig; K2+K3 held at the
    SPIKE forward step's shape on a system of the path."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.solver import SolverOptions
    from momentum_tpu_torch.testing.profile_workload import device_busy
    from momentum_tpu_torch.testing.workloads import build_sequence_problem, make_sequence_solve

    counts, numbers = {}, {}
    for name, fullbody in (("5", False), ("5f", True)):
        prob = build_sequence_problem(SEQUENCE_FRAMES, fullbody=fullbody, device="cuda")
        fn, frames = prob.fn, SEQUENCE_FRAMES
        solve = make_sequence_solve(fn)
        solve(prob.pf0, prob.u0)  # warm-up
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = solve(prob.pf0, prob.u0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(walls) == 1:
                counts[name] = _counts()
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wall = statistics.median(walls)
        one = make_sequence_solve(fn, SolverOptions(max_iterations=1))
        it_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            one(prob.pf0, prob.u0)
            torch.cuda.synchronize()
            it_walls.append(time.perf_counter() - t0)
        prof_wall, busy_ms, _ = device_busy(lambda: solve(prob.pf0, prob.u0))
        idle = None if busy_ms is None else 1 - busy_ms / (prof_wall * 1e3)
        err, want = float(res.error), SEQUENCE_ERROR_JAX_CPU[name]
        p, nu = fn.num_per_frame, fn.num_universal
        print(f"config {name} (F={frames}, P={fn.character.num_model_parameters}, per-frame "
              f"{p}, universal {nu}, GN {res.iterations}): {frames / wall:.1f} frames/s "
              f"(median wall {wall * 1e3:.1f} ms of {len(walls)}) on {smi}; final error "
              f"{err:.6e} (JAX CPU {want:.6e}), iterations {res.iterations} (JAX CPU "
              f"{SEQUENCE_ITERATIONS_JAX_CPU}), converged {bool(res.converged)}; one GN "
              f"iteration {statistics.median(it_walls) * 1e3:.1f} ms; device busy "
              + (f"{busy_ms:.1f} of {prof_wall * 1e3:.1f} ms profiled, idle share {idle:.3f}; "
                 if busy_ms is not None else "not measured (the profile saw no device time); ")
              + f"peak memory {peak_gb:.3f} GiB; kernel launches {counts[name]}")
        if res.per_frame.shape != prob.pf0.shape or not bool(torch.isfinite(res.per_frame).all()):
            raise AssertionError(f"config {name}: parameters of the wrong shape or not finite")
        if not (abs(err / want - 1) <= SEQUENCE_RTOL
                and res.iterations == SEQUENCE_ITERATIONS_JAX_CPU):
            raise AssertionError(f"config {name}: final error {err} not within {SEQUENCE_RTOL} "
                                 f"of the JAX CPU figure {want}, or {res.iterations} iterations")
        if any(n == 0 for n in counts[name].values()):
            raise AssertionError(f"config {name} did not run through every kernel: "
                                 f"{counts[name]}")
        skel = fn.character.skeleton
        local = fk.local_skel_states(
            skel, fn.character.parameter_transform.apply(prob.gt)).contiguous()
        k = nu + 1 + 3 * p  # [b_prev | rhs | left spike | right spike] of a forward step
        numbers[name] = dict(
            frames_per_s=frames / wall, error=err, iterations=res.iterations,
            converged=bool(res.converged), gn_iteration_ms=statistics.median(it_walls) * 1e3,
            device_busy_ms=busy_ms, profiled_wall_ms=prof_wall * 1e3, idle_share=idle,
            peak_memory_gib=peak_gb,
            fk=_hold_fk(skel, local, f"config {name}'s frames"),
            psd=_hold_psd_matrix(*_sequence_systems(fn, prob.pf0, prob.u0, k),
                                 f"config {name}'s SPIKE forward step"))
        del prob, fn, solve, one, res
    return counts, numbers


def phase_sequence_accel():
    """K1 under forward mode on the card: the full-body sequence at F = 256
    with an acceleration term (window 3, so q = 2 and banded_to_tridiag
    runs) on the position targets and motion smoothness. Its normal
    equations at the truth, whose window Jacobians push 3·156 + 1 tangents
    through FK by K1's jvp and vmap rules, held against the same with FK on
    fk_global_plain; then one GN step of the whole solve."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.sequence import AccelerationSequenceErrorFunction, solve_sequence
    from momentum_tpu_torch.sequence.solver import _normal_equations
    from momentum_tpu_torch.solver import SolverOptions
    from momentum_tpu_torch.testing.workloads import build_sequence_problem

    prob = build_sequence_problem(ACCEL_FRAMES, fullbody=True, device="cuda")
    nj = prob.fn.character.skeleton.num_joints
    fn = dataclasses.replace(prob.fn, sequence_errors=prob.fn.sequence_errors + (
        AccelerationSequenceErrorFunction.create(nj, weight=0.5, device="cuda"),))
    pf, u = fn.split(prob.gt)
    systems, launches, peak_gb = {}, {}, {}
    for name in ("kernel", "plain"):
        if name == "plain":
            real, fk_ops.fk_global = fk_ops.fk_global, fk_ops.fk_global_plain
        try:
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            systems[name] = _normal_equations(fn, pf, u)
            torch.cuda.synchronize()
            launches[name] = _counts()["fk_global_kernel"]
            peak_gb[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            if name == "plain":
                fk_ops.fk_global = real
    (dk, ok, uck, ubk, rfk, ruk, q), (dp, op, ucp, ubp, rfp, rup, _) = (
        systems["kernel"], systems["plain"])
    pairs = {"diag": (dk, dp), "u_coupling": (uck, ucp), "u_block": (ubk, ubp),
             "rhs_f": (rfk, rfp), "rhs_u": (ruk, rup),
             **{f"offs[{d}]": (a, b) for d, (a, b) in enumerate(zip(ok, op), 1)}}
    rel = {k: float((a - b).abs().max() / b.abs().max()) for k, (a, b) in pairs.items()}
    res = solve_sequence(fn, *fn.split(torch.zeros_like(prob.gt)), SolverOptions(max_iterations=1))
    print(f"sequence with acceleration (5f rig, F={ACCEL_FRAMES}, windows 2 and 3, q={q}): "
          f"normal equations through K1 ({launches['kernel']} launches) against FK on "
          f"fk_global_plain ({launches['plain']}): max|Δ| / max|block| "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {SEQUENCE_NE_RTOL:.0e}); peak memory {peak_gb['kernel']:.3f} GiB through "
          f"K1, {peak_gb['plain']:.3f} plain; "
          f"one GN step from zero: error {float(res.error):.6e}")
    if q != 2 or launches["kernel"] == 0 or launches["plain"] != 0:
        raise AssertionError(f"acceleration sequence: q = {q}, K1 launches {launches}")
    if not all(v <= SEQUENCE_NE_RTOL for v in rel.values()):
        raise AssertionError(f"acceleration sequence: the normal equations through K1 "
                             f"disagree with the plain FK's: {rel}")
    if not bool(torch.isfinite(res.per_frame).all()):
        raise AssertionError("acceleration sequence: the GN step is not finite")
    return dict(max_rel_err=rel, fk_launches=launches["kernel"], peak_memory_gib=peak_gb)


def _hold_ad_jacobian(char, markers, x):
    """The forward-mode Jacobian of config 6s's marker rows at x (B, 73)
    (solver/gauss_newton.py::ad_jacobian: FK's primal through K1, its
    tangents by K1's jvp and vmap rules) against the analytic one, to
    AD_JAC_RTOL of max|J|; K1's launches in one call; both timed."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian
    from momentum_tpu_torch.testing.profile_workload import event_ms
    from momentum_tpu_torch.tracking import TrackingConfig
    from momentum_tpu_torch.tracking.tracker import _marker_error_template

    ef0, per_frame = _marker_error_template(char, markers, TrackingConfig())
    fn = SkeletonSolverFunction(char, (per_frame(ef0, markers.positions, markers.occluded),))
    _reset_counts()
    rows_ad, jt_ad = ad_jacobian(fn.residual, x)
    torch.cuda.synchronize()
    k1 = fk_ops.launches
    rows, jac = fn.residual_and_jacobian(x)
    err = float((jt_ad.transpose(-1, -2) - jac).abs().max() / jac.abs().max())
    row_err = float((rows_ad - rows).abs().max() / rows.abs().max())
    ms_ad = event_ms(lambda: ad_jacobian(fn.residual, x), reps=3, samples=3)
    ms_an = event_ms(lambda: fn.residual_and_jacobian(x), reps=3, samples=3)
    print(f"AD Jacobian (config 6s's marker rows, B={x.shape[0]}, R={rows.shape[-1]}, "
          f"P={x.shape[-1]}): forward mode through K1 ({k1} K1 launches a call) against the "
          f"analytic Jacobian: max|ΔJ| {err:.3e} of max|J| (tol {AD_JAC_RTOL:.0e}), rows "
          f"{row_err:.3e}; wall {ms_ad:.2f} ms a call, the analytic {ms_an:.2f} ms")
    if not (err <= AD_JAC_RTOL and row_err <= AD_JAC_RTOL and k1 >= 1):
        raise AssertionError(f"the AD Jacobian through K1 disagrees with the analytic one "
                             f"({err}, rows {row_err}) or launched K1 {k1} times")
    return dict(max_rel_err=err, k1_launches_per_call=k1, ms=ms_ad, analytic_ms=ms_an,
                batch=x.shape[0])


def _tracking_systems(char, markers, identity, motion):
    """The (a, damp, b) of the last K2+K3 call of an LM solve of config 6s
    at the two shapes its path gives K2+K3: one frame ((1, 73), per-frame
    tracking from `identity`) and every frame ((343, 73), the batched
    refine from `motion`)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.tracking import MarkerSequence, track_poses_batched

    seen = {}
    real = psd.damped_chol_solve

    def record(a, damp, b):
        seen[a.shape[0]] = (a.clone(), damp.clone(), b.clone())
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        one = MarkerSequence(markers.positions[:1], markers.occluded[:1], markers.names)
        w.track_clip_per_frame(char, one, identity)
        cfg = dataclasses.replace(w._tracking_configs()[1], max_iter=2)
        track_poses_batched(char, markers, cfg, initial=motion)
    finally:
        psd.damped_chol_solve = real
    return seen[1], seen[markers.num_frames]


def phase_tracking(smi):
    """benchmarks/bench_suite.py config 6 (:441-560) on config 6s, the
    synthetic 343-frame × 41-marker clip on the CMU rig (73 parameters, mm):
    calibration (10 frames, 2 rounds of LM 25 and the scale's sequence
    solve), the locators-only round, then, from JAX CPU's calibrated rig and
    identity, per-frame tracking (LM 15, each frame warm-started), the
    smoothed refine of JAX CPU's per-frame motion (GN 10 with line search,
    float64 normal equations) and hierarchical batched tracking (keyframes
    every 8, then LM 10 + 5 on the worst 64). Every pose solve takes its
    Jacobian by
    forward mode (ad_jacobian), FK through K1, damped solves through K2+K3.
    Per stage: frames/s (the clip's 343 frames over the stage's wall), the
    median and p90 marker error against JAX CPU's, the K1 and K2+K3
    launches; the calibrated scale_global against JAX CPU's. Then the AD
    Jacobian held against the analytic one at B = 343, K1 held at B = 1
    and 343, K2+K3 held and timed at (1, 73) and (343, 73) on systems of
    the path. The idle share comes from profile_workload --workload
    tracking: after a profile of 16 frames of per-frame tracking here, the
    next profiles saw no kernel at all (on one H100)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.character import fk

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, TRACKING_JAX_CPU_FILE)) as f:
        jax_cpu = json.load(f)
    jax_motion = torch.as_tensor(np.load(os.path.join(here, TRACKING_JAX_CPU_MOTION_FILE)),
                                 device="cuda")
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    markers, frames = clip.markers, clip.markers.num_frames
    sampled = w.calibration_frames(frames)
    counts, numbers = {}, {}

    def stage(name, run, char_of, rows=slice(None)):
        _reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = _counts()
        char, motion = char_of(out)
        d = w.clip_marker_errors_mm(char, markers, motion, rows)
        med, p90 = float(np.median(d)), float(np.percentile(d, 90))
        want = jax_cpu[name]
        med_rtol = (TRACKING_CALIBRATION_MEDIAN_RTOL if name in ("calibrate", "locators")
                    else TRACKING_MEDIAN_RTOL)
        n_solves = counts[name]["damped_chol_solve_kernel"]
        print(f"config 6s {name}: {frames / wall:.2f} frames/s (wall {wall:.2f} s) on {smi}; "
              f"marker error median {med:.4f} mm (JAX CPU {want['median_mm']:.4f}), p90 "
              f"{p90:.4f} mm (JAX CPU {want['p90_mm']:.4f}); kernel launches {counts[name]}"
              + (f"; {wall / n_solves * 1e3:.2f} ms per K2+K3 launch" if n_solves else ""))
        if not (bool(torch.isfinite(motion).all())
                and abs(med - want["median_mm"]) <= max(med_rtol * want["median_mm"],
                                                        TRACKING_MEDIAN_ATOL_MM)
                and abs(p90 - want["p90_mm"]) <= TRACKING_P90_RTOL * want["p90_mm"]):
            raise AssertionError(f"config 6s {name}: marker error median {med} / p90 {p90} "
                                 f"not within tolerance of JAX CPU's {want}")
        numbers[name] = dict(frames_per_s=frames / wall, wall_s=wall, median_mm=med,
                             p90_mm=p90, launches=counts[name])
        return out

    identity, _ = stage("calibrate", lambda: w.calibrate_clip(clip),
                        lambda o: (clip.char, o[1]), sampled)
    scale, want_scale = float(identity[6]), jax_cpu["scale_global"]
    print(f"config 6s calibrated scale_global {scale:.6f} (JAX CPU {want_scale:.6f}, tol "
          f"{TRACKING_SCALE_TOL:.0e}; the clip's truth {TRACKING_TRUE_SCALE}, |Δ| "
          f"{abs(scale - TRACKING_TRUE_SCALE):.6f})")
    if not abs(scale - want_scale) <= TRACKING_SCALE_TOL:
        raise AssertionError(f"config 6s: scale_global {scale} not within {TRACKING_SCALE_TOL} "
                             f"of JAX CPU's {want_scale}")
    char2, _ = stage("locators", lambda: w.calibrate_clip_locators(clip, identity),
                     lambda o: o, sampled)
    # the tracking stages start from JAX's calibrated rig and identity
    jax_offsets = torch.as_tensor(jax_cpu["locator_offsets"], device="cuda")
    jax_identity = torch.as_tensor(jax_cpu["identity"], device="cuda")
    shift = float((char2.locators.offset - jax_offsets).abs().max())
    print(f"config 6s calibration against JAX CPU's: locator offsets max|Δ| {shift:.3f} mm, "
          f"identity max|Δ| {float((identity - jax_identity).abs().max()):.3e}")
    rig = dataclasses.replace(clip.char, locators=dataclasses.replace(clip.char.locators,
                                                                      offset=jax_offsets))
    stage("per_frame", lambda: w.track_clip_per_frame(rig, markers, jax_identity),
          lambda o: (rig, o.motion))
    stage("refine", lambda: w.refine_clip(rig, markers, jax_motion), lambda o: (rig, o.motion))
    hier = stage("hierarchical", lambda: w.track_clip_hierarchical(rig, markers, jax_identity),
                 lambda o: (rig, o.motion))
    char2, identity = rig, jax_identity
    total = {k: sum(c[k] for c in counts.values()) for k in counts["per_frame"]}
    if any(n == 0 for n in total.values()):
        raise AssertionError(f"config 6s did not run through every kernel: {counts}")

    numbers.update(scale_global=scale,
                   ad_jacobian=_hold_ad_jacobian(char2, markers, hier.motion))
    skel = char2.skeleton
    local = fk.local_skel_states(skel, char2.parameter_transform.apply(hier.motion)).contiguous()
    fk_numbers = {b: _hold_fk(skel, local[:b].contiguous(), f"config 6s, B = {b}")
                  for b in (1, frames)}
    one, every = _tracking_systems(char2, markers, identity, hier.motion)
    psd_numbers = {"1x73": _hold_psd_matrix(*one, "config 6s per-frame LM step"),
                   f"{frames}x73": _hold_psd_matrix(*every, "config 6s batched LM step")}
    return counts, numbers, fk_numbers, psd_numbers


def _hold_ad_rows(solver_fn, x, label):
    """The forward-mode Jacobian of solver_fn's rows at x (B, P) with FK's
    primal on K1 against the same with FK on fk_global_plain, to AD_K1_RTOL
    of max|J|; K1's launches in the first."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

    out, launches = {}, {}
    for name in ("kernel", "plain"):
        if name == "plain":
            real, fk_ops.fk_global = fk_ops.fk_global, fk_ops.fk_global_plain
        try:
            _reset_counts()
            out[name] = ad_jacobian(solver_fn.residual, x)
            torch.cuda.synchronize()
            launches[name] = _counts()["fk_global_kernel"]
        finally:
            if name == "plain":
                fk_ops.fk_global = real
    (rk, jk), (rp, jp) = out["kernel"], out["plain"]
    err = float((jk - jp).abs().max() / jp.abs().max())
    row_err = float((rk - rp).abs().max() / rp.abs().max())
    print(f"forward-mode rows of {label} (B={x.shape[0]}, R={rk.shape[-1]}, P={x.shape[-1]}) "
          f"through K1 ({launches['kernel']} launches) against fk_global_plain "
          f"({launches['plain']}): max|ΔJ| {err:.3e} of max|J|, rows {row_err:.3e} (tol "
          f"{AD_K1_RTOL:.0e})")
    if not (err <= AD_K1_RTOL and row_err <= AD_K1_RTOL and launches["kernel"] >= 1
            and launches["plain"] == 0):
        raise AssertionError(f"{label}: forward-mode rows through K1 disagree with the plain "
                             f"FK's ({err}, rows {row_err}) or launches {launches}")
    return dict(max_rel_err=err, rows_rel_err=row_err, k1_launches=launches["kernel"],
                batch=x.shape[0])


def _last_system(run, batch):
    """The (a, damp, b) of the last K2+K3 call of `run()` on `batch` systems."""
    from momentum_tpu_torch.ops import psd

    seen = []
    real = psd.damped_chol_solve

    def record(a, damp, b):
        if a.shape[0] == batch:
            seen[:] = [(a.clone(), damp.clone(), b.clone())]
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        run()
    finally:
        psd.damped_chol_solve = real
    if not seen:
        raise AssertionError(f"the path gave K2+K3 no system at B = {batch}")
    return seen[0]


def phase_catalog(smi):
    """Config C: batched IK at B = 2048 over every rigid module of the
    catalog on the full-body rig (workloads.build_catalog_ik_problem): LM 10
    through solve_ik on the normal equations, the blockwise analytic
    Jacobians and forward mode for CameraProjection, PlaneCollision and the
    Union; K1 every context, K2+K3 at (2048, 157). Figures on the first 256
    elements against JAX CPU's and on all 2048: each module's median final
    energy, conv_at_1e5 (against the solve continued 20 iterations), the
    divergent count; solves/s (the median of 3 warm solves) and the peak
    memory (the idle share comes from profile_workload --workload catalog).
    Then K2+K3 held at (2048, 157) on the path's normal equations and the
    forward-mode rows held through K1 against the plain FK."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CATALOG_JAX_CPU_FILE)) as f:
        want = json.load(f)
    problem = w.build_catalog_ik_problem(w.CATALOG_BATCH, seed=SEED, device="cuda")
    batch = problem.x0.shape[0]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = w.solve_catalog(problem)
    torch.cuda.synchronize()
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    walls = []
    for _ in range(3):  # warm
        t0 = time.perf_counter()
        w.solve_catalog(problem)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    more = w.solve_catalog(problem, x0=res.params, iterations=w.CATALOG_MORE)
    held = w.catalog_figures(problem, res.params, more.params, slice(0, CATALOG_HELD))
    full = w.catalog_figures(problem, res.params, more.params)
    print(f"config C (catalog IK, B={batch}, P={problem.x0.shape[-1]}, "
          f"{len(problem.modules)} modules, LM {w.CATALOG_ITERATIONS}): {batch / wall:.1f} "
          f"solves/s (median wall {wall:.3f} s of 3 warm runs) on {smi}; peak memory "
          f"{peak_gb:.3f} GiB; kernel launches {counts}")
    floor = CATALOG_MEDIAN_FLOOR * want["median_energy"]["total"]
    bad = []
    for label, jax_med in want["median_energy"].items():
        med = held["median_energy"][label]
        ok = abs(med - jax_med) <= CATALOG_MEDIAN_RTOL * jax_med + floor
        bad += [] if ok else [label]
        print(f"  config C {label}: median final energy {med:.6e} on the first "
              f"{CATALOG_HELD} (JAX CPU {jax_med:.6e}){'' if ok else ' OUT OF TOLERANCE'}; "
              f"all {batch}: {full['median_energy'][label]:.6e}")
    print(f"  config C conv_at_1e5 {held['conv_at_1e5']:.4f} on the first {CATALOG_HELD} "
          f"(JAX CPU {want['conv_at_1e5']:.4f}), {full['conv_at_1e5']:.4f} on all {batch}; "
          f"divergent {held['divergent']} / {full['divergent']} (JAX CPU {want['divergent']})")
    if bad or abs(held["conv_at_1e5"] - want["conv_at_1e5"]) > CATALOG_CONV_SLACK \
            or full["divergent"] or any(n == 0 for n in counts.values()):
        raise AssertionError(f"config C: medians {bad} out of tolerance, conv_at_1e5 "
                             f"{held['conv_at_1e5']} (JAX CPU {want['conv_at_1e5']}), divergent "
                             f"{full['divergent']}, or launches {counts}")
    efs = tuple(ef for _, ef in problem.modules)
    fn = SkeletonSolverFunction(problem.char, efs)
    ad_fn = SkeletonSolverFunction(problem.char, tuple(ef for ef in efs
                                                       if not ef.has_analytic_jacobian))
    numbers = dict(solves_per_s=batch / wall, wall_s=wall, peak_memory_gib=peak_gb,
                   first_256=held, all=full, launches=counts,
                   ad_rows=_hold_ad_rows(ad_fn, problem.x0, "config C's forward-mode modules"))
    a, b = fn.normal_equations(problem.x0)[:2]
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    psd_numbers = _hold_psd_matrix(a.contiguous(), damp, b.contiguous(),
                                   "config C's normal equations at the warm starts")
    return counts, numbers, psd_numbers


def phase_keypoints(smi):
    """Config 6k: config 6s's 343-frame clip and the keypoints of four
    cameras about 4 m from the walk (pinhole, two OpenCV, fisheye; 1280 × 720;
    the truth locators' projections + N(0, 1 px), 5% unobserved), from JAX
    CPU's config 6s calibration: track_poses_batched of every frame with
    markers and keypoints (LM 15, projection weight 1.5) from the calibrated
    identity, and refine_motion of JAX CPU's per-frame motion with them.
    Per stage frames/s, the median and p90 marker error (mm) and the median
    reprojection error (px) against JAX CPU's, the launches (the idle share
    comes from profile_workload --workload keypoints). Then the forward-mode rows of the keypoint solve
    held through K1 against the plain FK at B = 343, and K2+K3 held at
    (343, 73) on a system of the batched stage."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.tracking import tracker

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, KEYPOINTS_JAX_CPU_FILE)) as f:
        want = json.load(f)
    with open(os.path.join(here, TRACKING_JAX_CPU_FILE)) as f:
        jax_6s = json.load(f)
    jax_motion = torch.as_tensor(np.load(os.path.join(here, TRACKING_JAX_CPU_MOTION_FILE)),
                                 device="cuda")
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    keypoints = w.build_keypoint_clip(clip, seed=SEED)
    markers, frames = clip.markers, clip.markers.num_frames
    rig = dataclasses.replace(clip.char, locators=dataclasses.replace(
        clip.char.locators, offset=torch.as_tensor(jax_6s["locator_offsets"], device="cuda")))
    identity = torch.as_tensor(jax_6s["identity"], device="cuda")
    counts, numbers = {}, {}

    def stage(name, run):
        _reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = _counts()
        d = w.clip_marker_errors_mm(rig, markers, out.motion)
        px = w.clip_reprojection_errors_px(rig, keypoints, out.motion)
        got = dict(median_mm=float(np.median(d)), p90_mm=float(np.percentile(d, 90)),
                   median_px=float(np.median(px)))
        ref = want[name]
        print(f"config 6k {name}: {frames / wall:.2f} frames/s (wall {wall:.2f} s) on {smi}; "
              f"marker error median {got['median_mm']:.4f} mm (JAX CPU {ref['median_mm']:.4f}), "
              f"p90 {got['p90_mm']:.4f} mm (JAX CPU {ref['p90_mm']:.4f}); reprojection error "
              f"median {got['median_px']:.4f} px (JAX CPU {ref['median_px']:.4f}); kernel "
              f"launches {counts[name]}")
        if not (bool(torch.isfinite(out.motion).all())
                and abs(got["median_mm"] - ref["median_mm"])
                <= max(TRACKING_MEDIAN_RTOL * ref["median_mm"], TRACKING_MEDIAN_ATOL_MM)
                and abs(got["p90_mm"] - ref["p90_mm"]) <= TRACKING_P90_RTOL * ref["p90_mm"]
                and abs(got["median_px"] - ref["median_px"])
                <= TRACKING_MEDIAN_RTOL * ref["median_px"]):
            raise AssertionError(f"config 6k {name}: {got} not within tolerance of JAX CPU's "
                                 f"{ref}")
        numbers[name] = dict(frames_per_s=frames / wall, wall_s=wall, launches=counts[name],
                             **got)
        return out

    batched = stage("batched", lambda: w.track_clip_keypoints(rig, markers, keypoints, identity))
    stage("refine", lambda: w.refine_clip_keypoints(rig, markers, keypoints, jax_motion))
    total = {k: sum(c[k] for c in counts.values()) for k in counts["batched"]}
    if any(n == 0 for n in total.values()):
        raise AssertionError(f"config 6k did not run through every kernel: {counts}")
    cfg = w._keypoint_configs()[0]
    solve = tracker._frame_solve(rig, markers, cfg, None, keypoints)
    ef = solve.per_frame(solve.ef0, markers.positions, markers.occluded)
    kp_efs = tuple(pf(e0, t, c) for (e0, pf), (t, c) in zip(solve.kp, solve.kp_data))
    numbers["ad_rows"] = _hold_ad_rows(
        SkeletonSolverFunction(rig, (ef,) + solve.others + kp_efs), batched.motion,
        "config 6k's marker, limit and keypoint modules")
    one_step = dataclasses.replace(cfg, max_iter=2)
    system = _last_system(lambda: tracker.track_poses_batched(
        rig, markers, one_step, initial=identity, camera_keypoints=keypoints), frames)
    psd_numbers = _hold_psd_matrix(*system, "config 6k batched LM step")
    return counts, numbers, psd_numbers


def _frame_vertices(char, motion, frame=0):
    """The skinned vertices of frame `frame` of the clip."""
    from momentum_tpu_torch.testing.workloads import clip_vertices

    return clip_vertices(char, motion[frame])


def _raster_bound(planes, tab, n_attr, fids, ovf, w, h, th, covered):
    """bound() of one rasterizer pass, its face-tile pairs scanned and its
    live faces, and (K4a) the unculled scan's time at the f32 peak, which
    the per-tile test makes no floor. Bytes: the tables and bins read,
    depth, face, bary and attributes written. Flops: each tile scans the
    live faces it keeps (those in its bin, or every live face when it
    overflows; K4a the faces its per-tile test keeps, `tile_face_may_cover`,
    after that test's 4 planes × 9 flops for every live face; the padding
    rows and killed planes, a0 = b0 = 0, need no test) against its th·128
    pixels. A face's 4 planes cost 4 products a·x per column and 4 products
    b·y per row of the tile, then 2 adds per plane and pixel; each covered
    pixel then evaluates its 3 barycentrics and attributes at 4 flops each."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.profile_workload import bound

    gi, gj = raster._grid(w, h, th)
    live = (planes[:, 0] != 0) | (planes[:, 1] != 0)
    n_live = int(live.sum())
    per_pair = 128 * 4 + th * 4 + th * 128 * 8
    tests = 0
    extra = {}
    if fids is None:
        scanned = int((raster.tile_face_may_cover(planes, w, h, th) & live).sum())
        tests = gi * gj * n_live * 4 * 9
        extra["unculled_scan_ms"] = bound(0, gi * gj * n_live * per_pair)["bound_ms"]
    else:
        in_bin = (fids != raster.NOFACE) & live[fids.long().clamp(max=planes.shape[0] - 1)]
        scanned = int(torch.where(ovf.bool(), n_live, in_bin.sum(1)).sum())
    b = bound(sum(t.numel() * t.element_size() for t in (planes, tab, fids, ovf)
                  if t is not None) + h * w * 4 * (2 + 3 + n_attr),
              tests + scanned * per_pair + covered * 4 * (3 + n_attr))
    return b, scanned, n_live, extra


def phase_raster(char, cam, motion):
    """K4a and K4b against the plain version on the card. K4b at config 7's
    shapes: the camera pass (1280×960, 6 attributes, binned) of frame 0 (one
    overflow tile) and frame 5 (none), the shadow-map pass (256×256, binned)
    of frame 0 (none) and frame 11 (one), and frame 0's camera pass with
    bin_capacity 8 (77 tiles take the overflow scan). K4a on its path, the
    small-mesh render (the first 120 faces, frame 0: camera and shadow
    passes, unbinned at th = 4), and on frame 0's 612-face camera pass with
    cull=False."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.testing.profile_workload import (
        event_ms, kernel_device_ms)

    meshes = {"clip": char.mesh.faces, "small": char.mesh.faces[:SMALL_MESH_FACES].contiguous()}
    inputs = {(mesh, frame): render.shadowed_passes(cam, _frame_vertices(char, motion, frame),
                                                    meshes[mesh], 1280, 960)
              for mesh, frame in (("clip", 0), ("clip", 5), ("clip", 11), ("small", 0))}
    binned, full = "raster_planes_binned_kernel", "raster_planes_kernel"
    cases = [("camera pass, frame 0", binned, "clip", 0, "camera", {}),
             ("camera pass, frame 5", binned, "clip", 5, "camera", {}),
             ("shadow pass, frame 0", binned, "clip", 0, "shadow", {}),
             ("shadow pass, frame 11", binned, "clip", 11, "shadow", {}),
             ("small mesh camera pass", full, "small", 0, "camera", {}),
             ("small mesh shadow pass", full, "small", 0, "shadow", {}),
             ("camera pass, frame 0, cull=False", full, "clip", 0, "camera", dict(cull=False)),
             ("camera pass, frame 0, bin_capacity=8", binned, "clip", 0, "camera",
              dict(bin_capacity=8))]
    numbers = {}
    for label, kernel, mesh, frame, pass_, extra in cases:
        faces = meshes[mesh]
        sv, w, h, kw = inputs[mesh, frame][pass_]
        kw = dict(kw, **extra)
        before = raster.launches[kernel]
        out = raster.rasterize_planes(sv, faces, w, h, **kw)
        ref = raster.rasterize_planes_plain(sv, faces, w, h, **kw)
        torch.cuda.synchronize()
        if raster.launches[kernel] != before + 1:
            raise AssertionError(f"{label}: {kernel} was not launched")
        if not torch.equal(out["face"], ref["face"]):
            n = int((out["face"] != ref["face"]).sum())
            raise AssertionError(f"{label}: {kernel}'s face map differs from the plain "
                                 f"version's at {n} pixels")
        hit = ref["face"] >= 0
        errs = {"depth": float((out["depth"][hit] - ref["depth"][hit]).abs().max())
                if bool(hit.any()) else 0.0}
        for key in ("bary", "attrs"):
            if key in ref:
                errs[key] = float((out[key] - ref[key]).abs().max())
        if not bool(torch.isinf(out["depth"][~hit]).all()):
            raise AssertionError(f"{label}: an empty pixel's depth is not inf")
        bad = {k: e for k, e in errs.items() if not e <= RASTER_TOL[k]}
        if bad:
            raise AssertionError(f"{label}: {kernel} disagrees with the plain version: {bad}")

        # the kernel alone against the plain version's scan, on the same tables
        args = raster._kernel_args(sv, faces, w, h, **kw)
        ovf, th = args[4], args[7]
        cull = ovf is not None
        n_ovf = int(ovf.sum()) if cull else 0
        covered = int(hit.sum())
        b_raster, scanned, n_live, unculled = _raster_bound(*args, covered)
        busy_ms = event_ms(lambda: raster._raster_kernel(*args, True), busy=True)
        # the profiler's kernel time, else the launches queued behind a sleep
        ms = kernel_device_ms(lambda: raster._raster_kernel(*args, True), kernel) or busy_ms
        plain_ms = event_ms(lambda: raster._raster_plain(*args, 128, True))
        call_ms = event_ms(lambda: raster.rasterize_planes(sv, faces, w, h, **kw))
        err = max(errs.values())
        print(f"{kernel} [{label}] ({w}x{h}, F={faces.shape[0]}, th={th}, "
              f"{n_ovf} of {ovf.numel() if cull else 0} tiles overflow): face maps identical, "
              f"max|kernel - plain| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; kernel {ms:.4f} ms on the device ({busy_ms:.4f} ms in CUDA events "
              f"behind a sleep), plain {plain_ms:.4f} ms, whole rasterize_planes "
              f"{call_ms:.4f} ms; bound {b_raster['bound_ms']:.4f} ms "
              f"({b_raster['bound_by']}, {scanned} face-tile pairs scanned of {n_live} live "
              f"faces, {covered} covered pixels)"
              + (f"; the unculled scan alone {unculled['unculled_scan_ms']:.4f} ms at the f32 "
                 "peak (no floor: the per-tile test drops faces)" if unculled else ""))
        numbers[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_raster,
                              library_ms=None, events_ms=busy_ms, overflow_tiles=n_ovf,
                              faces=faces.shape[0], pairs_scanned=scanned, **unculled)
    return numbers


def phase_clip_passes(char, cam, motion):
    """Every K4b pass of the clip (32 camera and 32 shadow passes): the
    overflow tiles of each, and the sum of their bounds."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.workloads import render_clip_passes

    counts = {"camera": [], "shadow": []}
    bound_ms = 0.0
    for frame in render_clip_passes(char, cam, motion):
        for name, args in frame.items():
            counts[name].append(int(args[4].sum()))
            covered = int((raster._raster_kernel(*args, False)["face"] >= 0).sum())
            bound_ms += _raster_bound(*args, covered)[0]["bound_ms"]
    print(f"K4b overflow tiles per frame of the clip: camera {counts['camera']} (of 1200 "
          f"tiles), shadow {counts['shadow']} (of 64); the 64 passes' bounds sum to "
          f"{bound_ms:.4f} ms")
    return dict(overflow_tiles=counts, bound_ms=bound_ms)


def phase_render_clip(char, cam, motion, smi):
    """The render path: 32 frames, FK in one batch (K1), skinning, two
    raster passes per frame (K4b) and a 2×2 box filter; 3 timed runs, then
    the device time of K4b's 64 launches and K1's one per clip (profiler)."""
    from momentum_tpu_torch.ops import fk as fk_ops, raster
    from momentum_tpu_torch.testing.profile_workload import fmt_ms, kernel_device_ms
    from momentum_tpu_torch.testing.workloads import make_render_clip

    render_clip = make_render_clip(char, cam)
    render_clip(motion)  # warm-up
    torch.cuda.synchronize()
    fk_ops.launches = 0
    raster.launches.update(dict.fromkeys(raster.launches, 0))
    t0 = time.perf_counter()
    imgs = render_clip(motion)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches, **raster.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        render_clip(motion)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    device_ms = {name: kernel_device_ms(lambda: render_clip(motion), name, reps=2,
                                        per_call=per_call)
                 for name, per_call in (("raster_planes_binned_kernel", 2 * motion.shape[0]),
                                        ("fk_global_kernel", 1))}
    frames = motion.shape[0]
    wall = statistics.median(walls)
    cov = float((imgs > 0).float().mean())
    covered = (imgs > 0).any(dim=-1)
    mean_color = imgs[covered].mean(dim=0).tolist()
    print(f"render clip ({frames} frames, 640x480 @ 2x2 SS, shadow map 256): "
          f"{frames / wall:.2f} frames/s (median wall {wall * 1e3:.1f} ms of {len(walls)}) "
          f"on {smi}; mean coverage {cov:.6f} (JAX CPU {CLIP_COVERAGE_JAX_CPU:.6f}), "
          f"mean colour of covered pixels {[round(c, 6) for c in mean_color]}; "
          f"kernel launches {counts}; device ms per clip (profiler): K4b "
          f"{fmt_ms(device_ms['raster_planes_binned_kernel'])} over its 64 launches, K1 "
          f"{fmt_ms(device_ms['fk_global_kernel'])}")
    if imgs.shape != (frames, 480, 640, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"render clip: images {tuple(imgs.shape)} of the wrong shape "
                             "or not finite")
    if not abs(cov / CLIP_COVERAGE_JAX_CPU - 1) <= CLIP_COVERAGE_RTOL:
        raise AssertionError(f"render clip: mean coverage {cov} is not within "
                             f"{CLIP_COVERAGE_RTOL:.0%} of the JAX CPU figure")
    if counts["raster_planes_binned_kernel"] != 2 * frames or counts["fk_global_kernel"] < 1:
        raise AssertionError(f"render clip: expected {2 * frames} K4b launches and ≥ 1 K1 "
                             f"launch, got {counts}")
    return counts, imgs, device_ms


def phase_small_mesh(char, cam, motion):
    """A mesh under the bin capacity renders through K4a, both passes."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    verts = _frame_vertices(char, motion)
    faces = char.mesh.faces[:SMALL_MESH_FACES].contiguous()
    render.render_mesh_shadowed(cam, verts, faces, 1280, 960)  # warm-up
    torch.cuda.synchronize()
    raster.launches.update(dict.fromkeys(raster.launches, 0))
    out = render.render_mesh_shadowed(cam, verts, faces, 1280, 960)
    torch.cuda.synchronize()
    counts = dict(raster.launches)
    ref = render.render_mesh_shadowed(cam.to("cpu"), verts.cpu(), faces.cpu(), 1280, 960)
    same = out["face"].cpu() == ref["face"]
    flipped = int((out["mask"].cpu() != ref["mask"]).sum())
    cov = int(ref["mask"].sum())
    err = float((out["color"].cpu() - ref["color"])[same].abs().max())
    print(f"small mesh ({SMALL_MESH_FACES} faces, 1280x960, shadowed): {cov} covered "
          f"pixels, {flipped} differ from the CPU's plain render, colour |Δ| ≤ {err:.2e} "
          f"where the faces agree; kernel launches {counts}")
    if counts != {"raster_planes_kernel": 2, "raster_planes_binned_kernel": 0}:
        raise AssertionError(f"small mesh: expected 2 K4a launches, got {counts}")
    if not (cov > 0 and flipped <= max(3, cov // 1000) and err <= 1e-3):
        raise AssertionError("small mesh: the card's render disagrees with the CPU's")
    return counts


def phase_render_reference(card_clip, imgs_card):
    """Frames 0-1 of the clip rendered again on the CPU (plain versions),
    built anew there from the same seed: the same masks up to max(3, 0.1%)
    of the covered pixels; where both pick the same face, the same shadow
    factor on ≥ 99% of them and the same colour where that agrees too."""
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.testing.workloads import build_render_clip, make_render_clip

    cpu_clip = build_render_clip(32, seed=SEED, device="cpu")
    renders = {}
    for device, (char, motion, cam) in (("cuda", card_clip), ("cpu", cpu_clip)):
        renders[device] = [
            render.render_mesh_shadowed(cam, _frame_vertices(char, motion, i),
                                        char.mesh.faces, 1280, 960) for i in (0, 1)]
    for i in (0, 1):
        g, c = renders["cuda"][i], renders["cpu"][i]
        mg, mc = g["mask"].cpu(), c["mask"]
        same = (g["face"].cpu() == c["face"]) & mc
        flipped = int((mg != mc).sum())
        cov = int(mc.sum())
        # FK, skinning and camera differ in their last bits between the
        # devices; a world position on a shadow-map texel edge or at the depth
        # bias may then flip lit ↔ shadowed, which changes the colour by ~0.1
        lit_same = g["shadow"].cpu() == c["shadow"]
        lit_agree = float(lit_same[same].float().mean())
        err = float((g["color"].cpu() - c["color"])[same & lit_same].abs().max())
        print(f"render reference frame {i}: {cov} covered pixels on the CPU, {flipped} "
              f"differ on the card; where the faces agree, the shadow factor agrees on "
              f"{lit_agree:.5f} of them and the colour |Δ| ≤ {err:.2e} where it does too")
        if not (cov > 0 and flipped <= max(3, cov // 1000) and lit_agree >= 0.99
                and err <= 1e-3):
            raise AssertionError(f"frame {i}: the card's render disagrees with the CPU's")
    char, motion, cam = cpu_clip
    aa = make_render_clip(char, cam)(motion[:2])
    print(f"render reference: box-filtered frames 0-1, card vs CPU max|Δ| "
          f"{float((imgs_card[:2].cpu() - aa).abs().max()):.3e}, mean coverage card "
          f"{float((imgs_card[:2] > 0).float().mean()):.6f} / CPU "
          f"{float((aa > 0).float().mean()):.6f}")


def _relres_cols(a, damp, b, x):
    """max over systems and right-hand-side columns of ‖(A+D)x − b‖/‖b‖, and
    ‖(A+D)x‖ for a column b = 0 (the SPIKE spikes' columns are zero in
    most rows)."""
    cols_b = b[..., None] if b.ndim == a.ndim - 1 else b
    cols_x = x[..., None] if x.ndim == a.ndim - 1 else x
    ad = (a + torch.diag_embed(damp)).double()
    nr = torch.linalg.norm(ad @ cols_x.double() - cols_b.double(), dim=-2)
    nb = torch.linalg.norm(cols_b.double(), dim=-2)
    return float(torch.where(nb > 0, nr / torch.where(nb > 0, nb, 1.0), nr).max())


def phase_f7():
    """ROADMAP F7: float32 systems past the kernel's shared memory (n = 225
    and 300) and (B, n, 3) right-hand sides go through math/linalg.py to
    damped_chol_solve_kernel, one launch each, as JAX gives them its TPU
    kernel, and are held against the plain solve; float64 takes the plain
    solve on the card with no launch. The kernel's workspace form (n = 300)
    is timed in turns with the plain solve."""
    from momentum_tpu_torch.math import linalg
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.testing.profile_workload import in_turns

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def spd(n, dtype=torch.float32):
        j = torch.randn(64, n + 20, n, generator=g, dtype=torch.float64)
        a = j.transpose(-1, -2) @ j
        damp = 0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5
        b = torch.randn(64, n, generator=g, dtype=torch.float64)
        return tuple(t.to(dtype).cuda() for t in (a, damp, b))

    def rhs3(system):
        a, d, b = system
        return a, d, torch.stack([b, 2 * b + 1, -b], dim=-1).contiguous()

    cases = {"n = 225": (spd(225), 1), "n = 300": (spd(300), 1),
             "(B, n, 3) right-hand side": (rhs3(spd(157)), 1),
             "n = 300, (B, n, 3) right-hand side": (rhs3(spd(300)), 1),
             "float64": (spd(157, torch.float64), 0)}
    report = []
    for label, ((a, d, b), want) in cases.items():
        psd.launches = 0
        x = linalg.damped_psd_solve(a, d, b)
        launched = psd.launches
        x_plain = psd.damped_chol_solve_plain(a, d, b)
        torch.cuda.synchronize()
        res = _relres_cols(a, d, b, x)
        x_rel = float((x - x_plain).abs().max() / x_plain.abs().max())
        report.append(f"{label}: {launched} launch(es), max rel. residual {res:.2e}, "
                      f"max|x - x_plain| {x_rel:.2e} of max|x|")
        if (launched != want or x.shape != b.shape or not res <= PSD_RELRES_TOL
                or not x_rel <= PSD_X_TOL):
            raise AssertionError("F7: " + report[-1])
    a, d, b = cases["n = 300"][0]
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    print("F7: " + "; ".join(report) + f" (tol {PSD_RELRES_TOL:.0e}, {PSD_X_TOL:.0e}); "
          f"n = 300, B = 64 in turns: kernel (workspace form) {t['kernel']:.4f} ms, "
          f"plain {t['plain']:.4f} ms")


def phase_f8(char, x0):
    """ROADMAP F8: gradients of a seeded loss through K1 (its backward is the
    VJP of the plain lifted FK) against those through the plain FK, at
    B = 256 of the IK problem. The loss is quadratic in the FK output, so
    its cotangent, and the gradient, carry K1's forward."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.ops import fk as fk_ops

    skel = char.skeleton
    g = torch.Generator(device="cpu").manual_seed(SEED)
    weight = torch.randn(256, skel.num_joints, 8, generator=g).cuda()
    grads, launched = {}, {}
    for name, fk_fn in (("kernel", fk_ops.fk_global), ("plain", fk_ops.fk_global_plain)):
        x = x0[:256].clone().requires_grad_()
        fk_ops.launches = 0
        out = fk_fn(skel, fk.local_skel_states(skel, char.parameter_transform.apply(x)))
        (0.5 * (out * weight).square().sum()).backward()
        grads[name], launched[name] = x.grad, fk_ops.launches
    rel = float((grads["kernel"] - grads["plain"]).abs().max() / grads["plain"].abs().max())
    print(f"F8: gradients through K1 against the plain FK (B=256): max|Δ| {rel:.2e} of "
          f"max|grad| (tol {FK_GRAD_TOL:.0e}); K1 launches {launched}")
    if launched != {"kernel": 1, "plain": 0} or not rel <= FK_GRAD_TOL:
        raise AssertionError(f"F8: gradients through K1 disagree: {rel}, launches {launched}")


def phase_f9(char, cam, motion):
    """ROADMAP F9: K4b's merge scratch grown by a pass on a side stream while
    that stream's earlier launch with the smaller scratch still waits behind
    a sleep; the default stream meanwhile allocates and zeroes memory of the
    small keys' size. Both streams' face maps must be the plain version's."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    faces = char.mesh.faces
    passes = render.shadowed_passes(cam, _frame_vertices(char, motion), faces, 1280, 960)
    (sv, w, h, kw), (svl, wl, hl, kwl) = passes["shadow"], passes["camera"]
    refs = [raster.rasterize_planes_plain(sv, faces, w, h, bin_capacity=8, **kw)["face"],
            raster.rasterize_planes_plain(svl, faces, wl, hl, bin_capacity=8, **kwl)["face"]]
    torch.cuda.synchronize()
    raster._scratch.clear()
    raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)  # small pair, default stream
    small = raster._scratch[sv.device][0]
    n_keys, old_ptr = small.numel(), small.data_ptr()
    del small
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s: the host queues all below first
        a = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
        b = raster.rasterize_planes(svl, faces, wl, hl, bin_capacity=8, **kwl)  # grows it
    reused = []
    for _ in range(64):
        reused.append(torch.zeros(n_keys, dtype=torch.int64, device=sv.device))
        if reused[-1].data_ptr() == old_ptr:
            break
    c = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    same = [torch.equal(a["face"], refs[0]), torch.equal(b["face"], refs[1]),
            torch.equal(c["face"], refs[0])]
    print(f"F9: merge scratch grown on a side stream ({n_keys} -> "
          f"{raster._scratch[sv.device][0].numel()} keys); face maps equal to the plain "
          f"version's: side small {same[0]}, side large {same[1]}, default small {same[2]}")
    if not all(same):
        raise AssertionError(f"F9: a face map differs from the plain version's: {same}")


def main():
    t_start = time.perf_counter()

    def lap(label):
        print(f"[{time.perf_counter() - t_start:.1f} s: {label} done]", flush=True)

    kind, smi = phase_device()
    phase_build()
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem

    char, ef0, targets, x0 = build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    fk_numbers, fk_by_batch = phase_fk(char, x0)
    psd_numbers, psd_by_batch = phase_psd(char, ef0, targets, x0)
    counts = phase_main_path(char, ef0, targets, x0, smi)
    phase_small_reference()
    phase_f7()
    phase_f8(char, x0)
    lap("f8")
    del char, ef0, targets, x0

    from momentum_tpu_torch.testing.workloads import build_fullstack_problem

    fs = build_fullstack_problem(BATCH, seed=SEED, device="cuda")
    chol_counts, chol_numbers = phase_chol(*fs)
    fs_counts = phase_full_stack(*fs, smi)
    lap("full_stack")
    del fs
    config2_counts, config2_numbers = phase_config2_lm(smi)
    lap("config2_lm")
    vertex_counts, vertex_numbers = phase_vertex_fit(smi)
    lap("vertex_fit")
    seq_counts, seq_numbers = phase_sequence(smi)
    lap("sequence")
    seq_numbers["acceleration"] = phase_sequence_accel()
    lap("sequence_accel")
    track_counts, track_numbers, track_fk, track_psd = phase_tracking(smi)
    lap("tracking")
    catalog_counts, catalog_numbers, catalog_psd = phase_catalog(smi)
    lap("catalog")
    kp_counts, kp_numbers, kp_psd = phase_keypoints(smi)
    lap("keypoints")

    from momentum_tpu_torch.testing.workloads import build_render_clip

    rchar, motion, cam = build_render_clip(32, seed=SEED, device="cuda")
    raster_numbers = phase_raster(rchar, cam, motion)
    clip_passes = phase_clip_passes(rchar, cam, motion)
    clip_counts, imgs, clip_device_ms = phase_render_clip(rchar, cam, motion, smi)
    small_counts = phase_small_mesh(rchar, cam, motion)
    phase_render_reference((rchar, motion, cam), imgs)
    phase_f9(rchar, cam, motion)
    lap("f9")
    k4a = ("small mesh camera pass", "small mesh shadow pass", "camera pass, frame 0, cull=False")
    kernels = [
        dict(name="fk_global_kernel", route="cuda", source="momentum_tpu_torch/csrc/fk.cu",
             replaces="momentum_tpu/ops/fk_pallas.py:62",
             launches=counts["fk_global_kernel"], **fk_numbers,
             full_stack_launches=fs_counts["fk_global_kernel"],
             config2_lm_launches=config2_counts["fk_global_kernel"],
             vertex_fit_launches=vertex_counts["fk_global_kernel"],
             clip_launches=clip_counts["fk_global_kernel"],
             clip_device_ms=clip_device_ms["fk_global_kernel"],
             sequence_launches={c: n["fk_global_kernel"] for c, n in seq_counts.items()},
             by_batch={str(b): nums for b, nums in fk_by_batch.items()},
             sequence_B1024={c: seq_numbers[c].pop("fk") for c in seq_counts},
             tracking_launches={st: n["fk_global_kernel"] for st, n in track_counts.items()},
             **{f"tracking_B{b}": nums for b, nums in track_fk.items()},
             catalog_launches=catalog_counts["fk_global_kernel"],
             catalog_ad_rows=catalog_numbers.pop("ad_rows"),
             keypoint_launches={st: n["fk_global_kernel"] for st, n in kp_counts.items()},
             keypoint_ad_rows=kp_numbers.pop("ad_rows")),
        dict(name="damped_chol_solve_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/psd_pallas.py:53",
             also_replaces=["momentum_tpu/ops/psd_pallas.py:120"],
             launches=counts["damped_chol_solve_kernel"], **psd_numbers,
             full_stack_launches=fs_counts["damped_chol_solve_kernel"],
             config2_lm_launches=config2_counts["damped_chol_solve_kernel"],
             vertex_fit_launches=vertex_counts["damped_chol_solve_kernel"],
             by_batch={str(b): {k: v for k, v in nums.items() if k != "max_abs_err"}
                       for b, nums in psd_by_batch.items()},
             vertex_fit_256x165=vertex_numbers.pop("psd_256x165"),
             sequence_launches={c: n["damped_chol_solve_kernel"] for c, n in seq_counts.items()},
             **{"sequence_{}x{}_k{}".format(*nums["batch_n_k"]): nums
                for nums in (seq_numbers[c].pop("psd") for c in seq_counts)},
             tracking_launches={st: n["damped_chol_solve_kernel"]
                                for st, n in track_counts.items()},
             **{f"tracking_{shape}": nums for shape, nums in track_psd.items()},
             catalog_launches=catalog_counts["damped_chol_solve_kernel"],
             catalog_2048x157=catalog_psd,
             keypoint_launches={st: n["damped_chol_solve_kernel"] for st, n in kp_counts.items()},
             keypoints_343x73=kp_psd),
        dict(name="damped_chol_solve_kernel (K5a entry point chol_solve)", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/chol_pallas.py:55",
             launches=chol_counts["K5a"],
             path="chol_solve on the full stack's normal equations (n = 160)",
             **chol_numbers["K5a"]),
        dict(name="raster_planes_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:196",
             launches=small_counts["raster_planes_kernel"],
             path="shadowed render of a mesh under the bin capacity",
             **raster_numbers[k4a[0]],
             passes={label: raster_numbers[label] for label in k4a[1:]}),
        dict(name="raster_planes_binned_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:220",
             launches=clip_counts["raster_planes_binned_kernel"],
             path="shadowed render of the 32-frame clip",
             **raster_numbers["camera pass, frame 0"],
             passes={label: nums for label, nums in raster_numbers.items()
                     if label not in k4a},
             clip=dict(device_ms=clip_device_ms["raster_planes_binned_kernel"],
                       **clip_passes)),
        dict(name="damped_chol_solve_kernel (K5b entry point chol_solve_blocked)",
             route="cuda", source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/chol_pallas.py:93",
             launches=chol_counts["K5b"],
             path="chol_solve_blocked on the full stack's normal equations (n = 160)",
             **chol_numbers["K5b"]),
    ]
    print(json.dumps({"config2": config2_numbers, "config4": vertex_numbers,
                      "config5": seq_numbers, "config6s": track_numbers,
                      "configC": catalog_numbers, "config6k": kp_numbers}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
