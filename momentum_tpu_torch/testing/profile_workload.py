"""Where the time of the port's workloads goes on one CUDA card.

    python -m momentum_tpu_torch.testing.profile_workload [--workload ik|render|both]
                                                          [--batch 2048] [--out DIR]

Prints, for the IK workload (build_fullbody_ik_problem + make_solve_batch,
LM 5 + 6 compacted):
  * each layer of one full-batch LM iteration timed alone with CUDA events
    (FK context, residual + model Jacobian, JᵀJ/Jᵀr, damped solve, trial
    residual), at the batch and at the refinement capacity;
and for the render clip (build_render_clip + make_render_clip, 32 frames at
640×480 @ 2×2 SS with a 256 × 256 shadow map):
  * FK and skinning of the clip, and each layer of frame 0's render (project
    and face colours, planes and tables, binning and K4b of the camera and
    shadow passes, shading and box filter) timed alone with CUDA events;
and for each:
  * the wall time of the whole run, and the device-busy share from
    torch.profiler (sum of kernel time over wall time; one stream, so
    kernels do not overlap);
  * the profiler's kernel table, and its chrome trace in --out if given.
Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import time

import torch


def card_name_and_power_limit() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` names it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 10, samples: int = 5) -> float:
    """Median over `samples` of the mean CUDA-event time of `reps` calls,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_device_ms(fn, match: str, reps: int = 10) -> float:
    """Device time per call of the kernels whose name contains `match`, from
    torch.profiler over `reps` calls of fn after two warm-up calls: the
    kernel's own time, without the host's launch overhead that CUDA events
    around back-to-back calls include when the kernel is short."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key)
    if us == 0:
        raise RuntimeError(f"the profiler saw no device time for a kernel named {match!r}")
    return us / 1e3 / reps


def layer_times(char, ef0, targets, x0, lam: float = 0.01) -> dict:
    """ms per call of each layer of one LM iteration at x0's batch."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    rows, j = fn.residual_and_jacobian(x0)
    jt = j.transpose(-1, -2)
    jtj = jt @ j
    jtr = (jt @ rows[..., None])[..., 0]
    damp = lam * torch.clamp(jtj.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5
    return {
        "fk context (PT + K1)": event_ms(lambda: fn.context(x0)),
        "residual + model Jacobian": event_ms(lambda: fn.residual_and_jacobian(x0)),
        "JtJ + Jtr": event_ms(lambda: (jt @ j, jt @ rows[..., None])),
        "damped solve (K2+K3)": event_ms(lambda: damped_psd_solve(jtj, damp, jtr)),
        "trial residual": event_ms(lambda: fn.residual(x0)),
    }


def render_layer_times(char, cam, motion) -> dict:
    """ms per call of each layer of the render clip: FK and skinning of all
    frames, then each layer of frame 0's shadowed render."""
    from momentum_tpu_torch.character.skinning import skin_points
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    light, faces = (0.3, -0.7, 0.6), char.mesh.faces

    def skin(states):
        return skin_points(char.skin_weights, states, char.inverse_bind_pose,
                           char.mesh.vertices)

    states = char.skeleton_states(motion)
    verts = skin(states)[0]
    screen = render.screen_vertices(cam, verts)
    colors = render.flat_face_colors(verts, faces, light)
    to_light = render.light_projection(verts, light, 256)
    light_uvz = to_light(verts)
    cam_tabs = raster._tables(screen, faces, verts, colors, None, 128)
    cam_bins = raster.bin_faces(screen, faces, cam_tabs[0].shape[0], 1280, 960, 8, 128)
    shadow_tabs = raster._tables(light_uvz, faces, None, None, None, 128)
    fp = cam_tabs[0].shape[0]  # faces padded to 128: 640 rows, both passes
    shadow_bins = raster.bin_faces(light_uvz, faces, fp, 256, 256, 8, 128)
    cam_out = raster._raster_kernel(*cam_tabs, *cam_bins, 1280, 960, 8, True)
    sdepth = raster._raster_kernel(*shadow_tabs, *shadow_bins, 256, 256, 8, True)["depth"]

    def shade():
        mask = cam_out["face"] >= 0
        lit = torch.where(mask, render.shadow_factor(sdepth, to_light(cam_out["attrs"][..., :3])),
                          0.0)
        color = torch.where(mask[..., None],
                            cam_out["attrs"][..., 3:6] * (0.15 + 0.85 * lit[..., None]), 0.0)
        return color.reshape(480, 2, 640, 2, 3).mean(dim=(1, 3))

    def frame():
        out = render.render_mesh_shadowed(cam, verts, faces, 1280, 960)
        return out["color"].reshape(480, 2, 640, 2, 3).mean(dim=(1, 3))

    n = motion.shape[0]
    return {
        f"FK of {n} frames (K1)": event_ms(lambda: char.skeleton_states(motion)),
        f"skinning of {n} frames": event_ms(lambda: skin(states)),
        "camera pass: project + normals + face colours": event_ms(
            lambda: (render.screen_vertices(cam, verts),
                     render.flat_face_colors(verts, faces, light))),
        "camera pass: planes + attribute tables": event_ms(
            lambda: raster._tables(screen, faces, verts, colors, None, 128)),
        "camera pass: binning": event_ms(
            lambda: raster.bin_faces(screen, faces, fp, 1280, 960, 8, 128)),
        "camera pass: K4b": event_ms(
            lambda: raster._raster_kernel(*cam_tabs, *cam_bins, 1280, 960, 8, True)),
        "shadow pass: light projection + planes": event_ms(
            lambda: raster._tables(render.light_projection(verts, light, 256)(verts), faces,
                                   None, None, None, 128)),
        "shadow pass: binning": event_ms(
            lambda: raster.bin_faces(light_uvz, faces, fp, 256, 256, 8, 128)),
        "shadow pass: K4b": event_ms(
            lambda: raster._raster_kernel(*shadow_tabs, *shadow_bins, 256, 256, 8, True)),
        "shading + shadow lookup + 2x2 box filter": event_ms(shade),
        "whole frame (render_mesh_shadowed + box filter)": event_ms(frame),
    }


def _wall_and_profile(run, card: str, label: str, out_dir, units: float, unit: str):
    """Median wall of 3 warm runs, then one run under torch.profiler: the
    device-busy share and the kernel table (and trace, into out_dir)."""
    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"{label}: wall {wall * 1e3:.2f} ms (median of 3), {units / wall:.2f} {unit} [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side rows only (kernels, memcpy); the aten rows repeat their time
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiled {label}: wall {prof_wall * 1e3:.2f} ms (profiler on), device busy "
          f"{device_ms:.2f} ms; idle share {1 - device_ms / (prof_wall * 1e3):.3f} of the "
          f"profiled wall, {1 - device_ms / (wall * 1e3):.3f} of the unprofiled wall [{card}]")
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = label.split()[0]
        with open(os.path.join(out_dir, f"kernel_table_{tag}.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{tag}.json"))


def main():
    from momentum_tpu_torch.testing.workloads import (
        DEFAULT_REFINE, build_fullbody_ik_problem, build_render_clip, make_render_clip,
        make_solve_batch)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("ik", "render", "both"), default="both")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="directory for the kernel tables and traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_workload needs a CUDA device")
    card = card_name_and_power_limit()
    print(f"card: {card}")

    if args.workload in ("ik", "both"):
        char, ef0, targets, x0 = build_fullbody_ik_problem(args.batch, seed=args.seed,
                                                           device="cuda")
        cap = DEFAULT_REFINE[2]
        for b in (args.batch, cap):
            for name, ms in layer_times(char, ef0, targets[:b], x0[:b]).items():
                print(f"layer B={b}: {name}: {ms:.4f} ms [{card}]")
        solve = make_solve_batch(char, ef0, args.batch)
        _wall_and_profile(lambda: solve(targets, x0), card, f"solve B={args.batch}",
                          args.out, args.batch, "solves/s")

    if args.workload in ("render", "both"):
        char, motion, cam = build_render_clip(32, seed=args.seed, device="cuda")
        for name, ms in render_layer_times(char, cam, motion).items():
            print(f"render layer: {name}: {ms:.4f} ms [{card}]")
        render_clip = make_render_clip(char, cam)
        _wall_and_profile(lambda: render_clip(motion), card, "render clip of 32 frames",
                          args.out, motion.shape[0], "frames/s")

if __name__ == "__main__":
    main()
