"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the CUDA
kernels, holds each against its plain PyTorch version at its path's shapes,
then drives the port's paths through those kernels and checks their output:

  * full-body batched marker IK at B = 2048 (LM 5 + 6 compacted on the worst
    128): kernels K1 (FK) and K2+K3 (damped Cholesky);
  * the shadowed render of a posed 32-frame clip at 640×480, 2×2
    supersampled (benchmarks/bench_suite.py config 7): K1, and K4b (binned
    plane rasterizer) for the camera and shadow-map passes of every frame;
  * the shadowed render of a mesh under the bin capacity (the clip's first
    120 faces): K4a (plane rasterizer, all faces per tile).

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
RASTER_TOL = dict(depth=1e-5, bary=1e-5, attrs=1e-4)  # abs; face maps must be identical
# mean(imgs > 0) of config 7's 32-frame clip rendered by the JAX package on the
# CPU (its "auto" = windowed path; config 7's recipe, seed 0); PERF.md §6
CLIP_COVERAGE_JAX_CPU = 0.010333353678385417
CLIP_COVERAGE_RTOL = 0.02
SMALL_MESH_FACES = 120  # ≤ bin_capacity 128: the render takes K4a


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


def _raster_inputs(char, cam, motion, frame=0):
    """Frame `frame` of the clip: its skinned vertices and the inputs of its
    camera pass (screen vertices, world positions + face colours as
    attributes) and shadow-map pass (light-space vertices), as
    render_mesh_shadowed builds them."""
    from momentum_tpu_torch.character.skinning import skin_points
    from momentum_tpu_torch.rasterizer import render

    light = (0.3, -0.7, 0.6)
    verts = skin_points(char.skin_weights, char.skeleton_states(motion[frame]),
                        char.inverse_bind_pose, char.mesh.vertices)
    screen = render.screen_vertices(cam, verts)
    colors = render.flat_face_colors(verts, char.mesh.faces, light)
    light_uvz = render.light_projection(verts, light, 256)(verts)
    return verts, screen, colors, light_uvz


def phase_raster(char, cam, motion):
    """K4a and K4b against the plain version on the card, at config 7's
    frame-0 shapes: the camera pass (1280×960, 6 attributes, binned), the
    shadow-map pass (256×256, binned), the camera pass unbinned (K4a) and
    with bin_capacity 8 (most tiles take the overflow full scan)."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.profile_workload import event_ms, kernel_device_ms

    verts, screen, colors, light_uvz = _raster_inputs(char, cam, motion)
    faces = char.mesh.faces
    cases = [
        ("camera pass", "raster_planes_binned_kernel", screen, 1280, 960,
         dict(vertex_attrs=verts, face_attrs=colors)),
        ("shadow pass", "raster_planes_binned_kernel", light_uvz, 256, 256, {}),
        ("camera pass, cull=False", "raster_planes_kernel", screen, 1280, 960,
         dict(vertex_attrs=verts, face_attrs=colors, cull=False)),
        ("camera pass, bin_capacity=8", "raster_planes_binned_kernel", screen, 1280, 960,
         dict(vertex_attrs=verts, face_attrs=colors, bin_capacity=8)),
    ]
    numbers = {}
    for label, kernel, sv, w, h, kw in cases:
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
        cull = kw.get("cull", faces.shape[0] > kw.get("bin_capacity", 128))
        th = 8 if cull else 4
        planes, tab, n_attr = raster._tables(sv, faces, kw.get("vertex_attrs"),
                                             kw.get("face_attrs"), None, 128)
        fids = ovf = None
        n_ovf = 0
        if cull:
            fids, ovf = raster.bin_faces(sv, faces, planes.shape[0], w, h, th,
                                         kw.get("bin_capacity", 128))
            n_ovf = int(ovf.sum())
        args = (planes, tab, n_attr, fids, ovf, w, h, th)
        ms = kernel_device_ms(lambda: raster._raster_kernel(*args, True), "raster_kernel")
        launch_ms = event_ms(lambda: raster._raster_kernel(*args, True))
        plain_ms = event_ms(lambda: raster._raster_plain(*args, 128, True))
        call_ms = event_ms(lambda: raster.rasterize_planes(sv, faces, w, h, **kw))
        err = max(errs.values())
        print(f"{kernel} [{label}] ({w}x{h}, F={faces.shape[0]}, th={th}, "
              f"{n_ovf} of {ovf.numel() if cull else 0} tiles overflow): face maps identical, "
              f"max|kernel - plain| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; kernel {ms:.4f} ms on the device ({launch_ms:.4f} ms per wrapper call, "
              f"CUDA events), plain {plain_ms:.4f} ms, whole rasterize_planes "
              f"{call_ms:.4f} ms")
        if label in ("camera pass", "camera pass, cull=False"):
            numbers[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   wrapper_call_ms=launch_ms)
    return numbers


def phase_render_clip(char, cam, motion, smi):
    """The render path: 32 frames, FK in one batch (K1), skinning, two
    raster passes per frame (K4b) and a 2×2 box filter; 3 timed runs."""
    from momentum_tpu_torch.ops import fk as fk_ops, raster
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
    frames = motion.shape[0]
    wall = statistics.median(walls)
    cov = float((imgs > 0).float().mean())
    covered = (imgs > 0).any(dim=-1)
    mean_color = imgs[covered].mean(dim=0).tolist()
    print(f"render clip ({frames} frames, 640x480 @ 2x2 SS, shadow map 256): "
          f"{frames / wall:.2f} frames/s (median wall {wall * 1e3:.1f} ms of {len(walls)}) "
          f"on {smi}; mean coverage {cov:.6f} (JAX CPU {CLIP_COVERAGE_JAX_CPU:.6f}), "
          f"mean colour of covered pixels {[round(c, 6) for c in mean_color]}; "
          f"kernel launches {counts}")
    if imgs.shape != (frames, 480, 640, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"render clip: images {tuple(imgs.shape)} of the wrong shape "
                             "or not finite")
    if not abs(cov / CLIP_COVERAGE_JAX_CPU - 1) <= CLIP_COVERAGE_RTOL:
        raise AssertionError(f"render clip: mean coverage {cov} is not within "
                             f"{CLIP_COVERAGE_RTOL:.0%} of the JAX CPU figure")
    if counts["raster_planes_binned_kernel"] != 2 * frames or counts["fk_global_kernel"] < 1:
        raise AssertionError(f"render clip: expected {2 * frames} K4b launches and ≥ 1 K1 "
                             f"launch, got {counts}")
    return counts, imgs


def phase_small_mesh(char, cam, motion):
    """A mesh under the bin capacity renders through K4a, both passes."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    verts = _raster_inputs(char, cam, motion)[0]
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
            render.render_mesh_shadowed(cam, _raster_inputs(char, cam, motion, i)[0],
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


def main():
    kind, smi = phase_device()
    phase_build()
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem

    char, ef0, targets, x0 = build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    fk_numbers = phase_fk(char, x0)
    psd_numbers = phase_psd(char, ef0, targets, x0)
    counts = phase_main_path(char, ef0, targets, x0, smi)
    phase_small_reference()
    del char, ef0, targets, x0

    from momentum_tpu_torch.testing.workloads import build_render_clip

    rchar, motion, cam = build_render_clip(32, seed=SEED, device="cuda")
    raster_numbers = phase_raster(rchar, cam, motion)
    clip_counts, imgs = phase_render_clip(rchar, cam, motion, smi)
    small_counts = phase_small_mesh(rchar, cam, motion)
    phase_render_reference((rchar, motion, cam), imgs)
    kernels = [
        dict(name="fk_global_kernel", route="cuda", source="momentum_tpu_torch/csrc/fk.cu",
             replaces="momentum_tpu/ops/fk_pallas.py:62",
             launches=counts["fk_global_kernel"], **fk_numbers),
        dict(name="damped_chol_solve_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/psd_pallas.py:53",
             also_replaces="momentum_tpu/ops/psd_pallas.py:120",
             launches=counts["damped_chol_solve_kernel"], **psd_numbers),
        dict(name="raster_planes_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:196",
             launches=small_counts["raster_planes_kernel"],
             path="shadowed render of a mesh under the bin capacity",
             **raster_numbers["raster_planes_kernel"]),
        dict(name="raster_planes_binned_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:220",
             launches=clip_counts["raster_planes_binned_kernel"],
             path="shadowed render of the 32-frame clip",
             **raster_numbers["raster_planes_binned_kernel"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
