"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the CUDA
kernels, holds each against its plain PyTorch version at the main path's
shapes, then drives the main path — full-body batched marker IK at B = 2048
(LM 5 + 6 compacted on the worst 128) — through those kernels and checks its
accuracy.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (the kernels build into build/momentum_tpu_torch/
at first use). Imports nothing of JAX. Every failed check raises, so the exit
code is non-zero; the last line of a passing run is
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
SEED = 0
FK_TOL = 2e-5  # abs, f32: the kernel composes serially, the plain version by lifting
PSD_RELRES_TOL = 1e-5  # max ‖(A+D)x − b‖/‖b‖; plain cholesky_ex gives ~2e-7 here
PSD_X_TOL = 1e-3  # max |x_kernel − x_plain| / max |x_plain|: κ reaches ~1e8 here
CONV_MIN = 0.98  # JAX CPU runs of this workload give 0.99–1.0


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    from momentum_tpu_torch.testing.profile_workload import card_name_and_power_limit

    kind = torch.cuda.get_device_name(0)
    smi = card_name_and_power_limit()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return kind, smi


def phase_build():
    from momentum_tpu_torch.ops import build

    t0 = time.perf_counter()
    for name in ("fk", "psd"):
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name in ("fk", "psd"):
        log = str(build.build(name)) + ".log"  # already built: returns the path
        with open(log) as f:
            print(f"  csrc/{name}.cu ptxas: " + " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln))


def phase_fk(char, x0):
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.testing.profile_workload import event_ms

    local = fk.local_skel_states(char.skeleton,
                                 char.parameter_transform.apply(x0)).contiguous()
    out = fk_ops.fk_global(char.skeleton, local)
    ref = fk_ops.fk_global_plain(char.skeleton, local)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ms = event_ms(lambda: fk_ops.fk_global(char.skeleton, local))
    plain_ms = event_ms(lambda: fk_ops.fk_global_plain(char.skeleton, local))
    print(f"K1 fk_global_kernel (B={local.shape[0]}, nJ={local.shape[1]}): "
          f"max|kernel - plain lifted| = {err:.3e} (tol {FK_TOL:.0e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not err <= FK_TOL:
        raise AssertionError(f"fk_global_kernel disagrees with the plain FK: {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_psd(char, ef0, targets, x0):
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import event_ms

    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    rows, j = fn.residual_and_jacobian(x0)
    jt = j.transpose(-1, -2)
    a = (jt @ j).contiguous()
    b = (jt @ rows[..., None])[..., 0].contiguous()
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    x = psd.damped_chol_solve(a, damp, b)
    x_plain = psd.damped_chol_solve_plain(a, damp, b)

    def relres(sol):
        ad = (a + torch.diag_embed(damp)).double()
        r = (ad @ sol.double()[..., None])[..., 0] - b.double()
        return float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())

    res_k, res_p = relres(x), relres(x_plain)
    err = float((x - x_plain).abs().max())
    x_rel = err / float(x_plain.abs().max())
    ms = event_ms(lambda: psd.damped_chol_solve(a, damp, b))
    plain_ms = event_ms(lambda: psd.damped_chol_solve_plain(a, damp, b))
    print(f"K2+K3 damped_chol_solve_kernel (B={a.shape[0]}, n={a.shape[1]}): "
          f"max rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (tol {PSD_RELRES_TOL:.0e}); "
          f"max|x_kernel - x_plain| = {err:.3e} ({x_rel:.3e} of max|x|, tol {PSD_X_TOL:.0e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not (res_k <= PSD_RELRES_TOL and x_rel <= PSD_X_TOL):
        raise AssertionError("damped_chol_solve_kernel disagrees with the plain solve")

    # ROADMAP F1: an indefinite system comes back all-NaN from both versions,
    # and its neighbours in the batch are unaffected
    bad = a[:4].clone()
    bad[2, 5, 5] = -1e3
    for name, solve in (("kernel", psd.damped_chol_solve),
                        ("plain", psd.damped_chol_solve_plain)):
        xb = solve(bad, damp[:4].contiguous(), b[:4].contiguous())
        nan_rows = torch.isnan(xb).all(dim=-1).tolist()
        finite_rows = torch.isfinite(xb).all(dim=-1).tolist()
        if nan_rows != [False, False, True, False] or finite_rows != [True, True, False, True]:
            raise AssertionError(f"F1: {name} solve of an indefinite system gave "
                                 f"nan rows {nan_rows}, finite rows {finite_rows}")
    print("K2+K3 F1: the indefinite system is all-NaN in kernel and plain, "
          "its neighbours finite")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def main():
    kind, smi = phase_device()
    phase_build()
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem

    char, ef0, targets, x0 = build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    fk_numbers = phase_fk(char, x0)
    psd_numbers = phase_psd(char, ef0, targets, x0)
    counts = phase_main_path(char, ef0, targets, x0, smi)
    phase_small_reference()
    kernels = [
        dict(name="fk_global_kernel", route="cuda", source="momentum_tpu_torch/csrc/fk.cu",
             replaces="momentum_tpu/ops/fk_pallas.py:62",
             launches=counts["fk_global_kernel"], **fk_numbers),
        dict(name="damped_chol_solve_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/psd_pallas.py:53",
             also_replaces="momentum_tpu/ops/psd_pallas.py:120",
             launches=counts["damped_chol_solve_kernel"], **psd_numbers),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
