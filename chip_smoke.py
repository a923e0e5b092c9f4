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
    stream (F9).

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
import statistics
import time

import numpy as np
import torch

BATCH = 2048
CLIP_FRAMES = 32  # the render clip's frames: K1's batch on that path
SEED = 0
FK_TOL = 2e-5  # abs, f32: kernel and plain version lift alike; PyTorch's kernels may fuse
# of max|grad|: K1's backward is the plain VJP; index_select's backward sums atomically
FK_GRAD_TOL = 1e-5
PSD_RELRES_TOL = 1e-5  # max ‖(A+D)x − b‖/‖b‖; plain cholesky_ex gives ~2e-7 here
PSD_X_TOL = 1e-3  # max |x_kernel − x_plain| / max |x_plain|: κ reaches ~1e8 here
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
SMALL_MESH_FACES = 120  # ≤ bin_capacity 128: the render takes K4a
# the batch sizes the paths give K2+K3: IK 2048 and its compacted 128, the
# full stack's refinement on 1024 (testing/workloads.py)
PSD_BATCHES = (BATCH, 128, 1024)


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


def phase_fk(char, x0):
    """K1 against the plain version at the IK path's B = 2048 and the
    clip's B = 32 (one launch for all its frames): max error, the kernel's
    time (CUDA events around launches queued behind a sleep kernel, and the
    profiler's device time), the plain version's, the bound."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.testing.profile_workload import (
        bound, event_ms, kernel_device_ms)

    skel = char.skeleton
    local_all = fk.local_skel_states(skel, char.parameter_transform.apply(x0)).contiguous()
    numbers = {}
    for batch in (BATCH, CLIP_FRAMES):
        local = local_all[:batch].contiguous()
        out = fk_ops.fk_global(skel, local)
        ref = fk_ops.fk_global_plain(skel, local)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ms = event_ms(lambda: fk_ops.fk_global(skel, local), busy=True)
        dev_ms = kernel_device_ms(lambda: fk_ops.fk_global(skel, local), "fk_global_kernel")
        plain_ms = event_ms(lambda: fk_ops.fk_global_plain(skel, local))
        # local states read, global states written, the lifting table; one
        # skel_state compose per joint: quaternion product 28 flops, rotated
        # and scaled translation 36, scale 1
        b_fk = bound(2 * local.numel() * 4 + skel.prefix_table.numel() * 4,
                     batch * local.shape[1] * 65)
        print(f"K1 fk_global_kernel (B={batch}, nJ={local.shape[1]}, "
              f"{skel.prefix_table.shape[0]} levels): max|kernel - plain| = {err:.3e} (tol "
              f"{FK_TOL:.0e}); kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, bound {b_fk['bound_ms']:.6f} ms ({b_fk['bound_by']}), "
              f"{b_fk['bound_ms'] / ms:.1%} of it")
        if not err <= FK_TOL:
            raise AssertionError(f"fk_global_kernel disagrees with the plain FK at "
                                 f"B = {batch}: {err}")
        numbers[batch] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_fk,
                              library_ms=None, device_ms=dev_ms)
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
        in_turns, kernel_device_ms, library_solve, solve_bound)

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
              f"device time kernel {dev_ms:.4f} ms, library {lib_dev_ms:.4f} ms; bound "
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
    params, energy = solve(targets, q, x0)
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
        ms = kernel_device_ms(lambda: raster._raster_kernel(*args, True), kernel)
        busy_ms = event_ms(lambda: raster._raster_kernel(*args, True), busy=True)
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
    from momentum_tpu_torch.testing.profile_workload import kernel_device_ms
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
          f"{device_ms['raster_planes_binned_kernel']:.4f} over its 64 launches, K1 "
          f"{device_ms['fk_global_kernel']:.4f}")
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
    """max over systems and right-hand-side columns of ‖(A+D)x − b‖/‖b‖."""
    cols_b = b[..., None] if b.ndim == a.ndim - 1 else b
    cols_x = x[..., None] if x.ndim == a.ndim - 1 else x
    ad = (a + torch.diag_embed(damp)).double()
    r = ad @ cols_x.double() - cols_b.double()
    return float((torch.linalg.norm(r, dim=-2) / torch.linalg.norm(cols_b.double(), dim=-2)).max())


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
    del char, ef0, targets, x0

    from momentum_tpu_torch.testing.workloads import build_fullstack_problem

    fs = build_fullstack_problem(BATCH, seed=SEED, device="cuda")
    chol_counts, chol_numbers = phase_chol(*fs)
    fs_counts = phase_full_stack(*fs, smi)
    del fs

    from momentum_tpu_torch.testing.workloads import build_render_clip

    rchar, motion, cam = build_render_clip(32, seed=SEED, device="cuda")
    raster_numbers = phase_raster(rchar, cam, motion)
    clip_passes = phase_clip_passes(rchar, cam, motion)
    clip_counts, imgs, clip_device_ms = phase_render_clip(rchar, cam, motion, smi)
    small_counts = phase_small_mesh(rchar, cam, motion)
    phase_render_reference((rchar, motion, cam), imgs)
    phase_f9(rchar, cam, motion)
    k4a = ("small mesh camera pass", "small mesh shadow pass", "camera pass, frame 0, cull=False")
    kernels = [
        dict(name="fk_global_kernel", route="cuda", source="momentum_tpu_torch/csrc/fk.cu",
             replaces="momentum_tpu/ops/fk_pallas.py:62",
             launches=counts["fk_global_kernel"], **fk_numbers,
             full_stack_launches=fs_counts["fk_global_kernel"],
             clip_launches=clip_counts["fk_global_kernel"],
             clip_device_ms=clip_device_ms["fk_global_kernel"],
             by_batch={str(b): nums for b, nums in fk_by_batch.items()}),
        dict(name="damped_chol_solve_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/psd_pallas.py:53",
             also_replaces=["momentum_tpu/ops/psd_pallas.py:120"],
             launches=counts["damped_chol_solve_kernel"], **psd_numbers,
             full_stack_launches=fs_counts["damped_chol_solve_kernel"],
             by_batch={str(b): {k: v for k, v in nums.items() if k != "max_abs_err"}
                       for b, nums in psd_by_batch.items()}),
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
