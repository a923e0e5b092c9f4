"""Where the time of the port's workloads goes on one CUDA card.

    python -m momentum_tpu_torch.testing.profile_workload
        [--workload ik|render|fullstack|vertex|sequence|tracking|catalog|keypoints|both]
        [--batch 2048]
        [--frames 1024] [--fullbody] [--out DIR]

Prints, for the IK workload (build_fullbody_ik_problem + make_solve_batch,
LM 5 + 6 compacted):
  * each layer of one full-batch LM iteration timed alone with CUDA events
    (FK context, residual + model Jacobian, JᵀJ/Jᵀr, damped solve, trial
    residual), at the batch and at the refinement capacity;
for the full residual stack (build_fullstack_problem + make_fullstack_solve,
GN 2 + 1 on the worst 1024):
  * each layer of one full-batch GN iteration timed alone with CUDA events
    (FK context, the Jacobian context, each module's accumulate_normal, the
    damped solve), and the whole iteration;
for the vertex fit (bench_suite.py config 4b: build_vertex_fit_problem +
make_vertex_fit_solve at B = 256, GN 4 + 2 on the worst 64):
  * each layer of one full-batch GN iteration timed alone with CUDA events
    (the mesh context: FK, blend shapes, skinning and normals; the vertex
    rows and Jacobian from that context: joint axes, skinning walk and the
    parameter-transform chain; JᵀJ/Jᵀr; the damped solve), and the whole
    iteration;
for the sequence solve (bench_suite.py config 5, or 5f with --fullbody:
build_sequence_problem + make_sequence_solve, GN 8 over F frames):
  * each layer of one GN iteration timed alone with CUDA events (the frame
    contexts through K1; the per-frame rows and analytic Jacobian; their
    JᵀJ and arrowhead products; each sequence module's window Jacobians by
    forward mode; the whole normal equations; equilibration; the SPIKE
    local systems, their batched Thomas scans through K2+K3 and the
    interface LU; the Schur complement and universal solve), the whole
    iteration, and the K1 and K2+K3 launches of one iteration;
for marker tracking (bench_suite.py config 6 on config 6s's clip,
build_tracking_clip: the CMU rig, 343 frames × 41 markers):
  * each layer of one LM iteration timed alone with CUDA events, at one
    frame (per-frame tracking) and at every frame (the hierarchical
    batched refine): the AD Jacobian (forward mode through K1), JᵀJ/Jᵀr,
    the damped solve (K2+K3), the trial energy, the whole iteration, and
    the host's part (the iteration less its layers);
  * the wall and device-busy share of per-frame tracking of 32 frames and
    of the batched refine at every frame;
for config C (build_catalog_ik_problem + solve_catalog, LM 10 at B = 2048
over every rigid module of the catalog):
  * each layer of one LM iteration timed alone with CUDA events (the
    context, the analytic Jacobians, the forward-mode Jacobian, the
    position module's direct normal equations, JᵀJ/Jᵀr of the dense rows,
    the damped solve, the trial energy), the whole iteration and the host's
    part, and the wall and device-busy share of the solve;
for config 6k (config 6s's clip with four cameras' keypoints,
build_keypoint_clip + track_clip_keypoints at every frame):
  * each layer of one LM iteration of the batched solve, as for tracking,
    and the wall and device-busy share of the batched solve;
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
import sys
import time

import torch


# an H100 SXM's published peaks, against which the on-card times are held
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for work that moves `nbytes`
    (each input read once, each output written once) and does `flops` f32
    operations: the longer of the two at the card's peak rates."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_flops = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_flops),
                bound_by="bytes" if by_bytes >= by_flops else "operations")


def solve_bound(batch: int, n: int, k: int = 1) -> dict:
    """bound() of B damped (n, n) solves with k right-hand sides: a, damp
    and b read, x written; n³/3 flops to factor and 2n² per right-hand side
    to substitute, per system."""
    return bound(4 * batch * (n * n + n + 2 * n * k), batch * (n ** 3 / 3 + 2 * n * n * k))


def library_solve(a, damp, b):
    """The library's damped solve as a timed function: cholesky_ex +
    cholesky_solve on a + diag(damp) formed beforehand, for b (B, n) or
    (B, n, k). A yardstick: the port never calls it."""
    ad = a + torch.diag_embed(damp)
    if b.ndim == a.ndim:
        return lambda: torch.cholesky_solve(b, torch.linalg.cholesky_ex(ad)[0])
    return lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(ad)[0])[..., 0]


def card_name_and_power_limit() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` names it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


_PROFILE_ATTEMPTS = 3  # profiles kernel_device_ms takes before it gives up
# ~0.1 ms at an H100's clock: longer than one kernel wrapper call on the host
_SLEEP_CYCLES_PER_CALL = 200_000


def event_ms(fn, reps: int = 10, samples: int = 5, busy: bool = False) -> float:
    """Median over `samples` of the mean CUDA-event time of `reps` calls,
    after two warm-up calls. With `busy`, the calls are queued behind a
    sleep kernel, so that the card never waits for the host between them:
    the device time per call of work that takes less time on the card than
    its launch on the host (fn must not synchronize)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(_SLEEP_CYCLES_PER_CALL * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def in_turns(fns: dict, rounds: int = 3, busy: bool = False) -> dict:
    """Median over `rounds` of each function's event_ms, the functions timed
    in turns (a, b, a, b, …) so that all see the same card state."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(event_ms(fn, busy=busy))
    return {name: statistics.median(t) for name, t in times.items()}


def kernel_device_ms(fn, match: str, reps: int = 10,
                     per_call: int | None = 1) -> float | None:
    """Device time per call of the kernels whose name contains `match`, from
    torch.profiler over `reps` calls of fn after two warm-up calls: the
    kernel's own time, without the host's launch overhead that CUDA events
    around back-to-back calls include when the kernel is short. fn launches
    `per_call` such kernels (None: an unknown number, and the total is
    divided by reps). The time per call is the mean over the launches the
    profile holds times per_call: on an H100 a profile of ten launches has
    held nine, and once none (then it is taken again, up to
    _PROFILE_ATTEMPTS in all). None, not measured, when no profile saw
    device time for such a kernel: on one H100 the profiler stopped seeing
    any kernel part-way through a process, and stayed so; callers then keep
    their CUDA-event times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(_PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = [e for e in events if match in e.key]
        us = sum(e.self_device_time_total for e in seen)
        if us > 0:
            calls = reps if per_call is None else sum(e.count for e in seen) / per_call
            return us / 1e3 / calls
    print(f"{_PROFILE_ATTEMPTS} profiles saw no device time for a kernel named {match!r} "
          f"(the last saw {[(e.key, e.count) for e in events]}): its device time is not "
          f"measured", file=sys.stderr, flush=True)
    return None


def fmt_ms(ms: float | None) -> str:
    """A time in ms as the smoke and the profiles print it, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


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


def fullstack_layer_times(char, efs, targets, q, x0) -> dict:
    """ms per call of each layer of one full-batch GN iteration of the full
    residual stack at x0's batch."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik
    from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context

    mods = (dataclasses.replace(efs[0], target=targets), dataclasses.replace(efs[1], target=q),
            *efs[2:])
    fn = SkeletonSolverFunction(char, mods)
    ctx = fn.context(x0)
    jc = make_jacobian_context(char, ctx)
    pt_mat = char.parameter_transform.transform
    jtj, jtr, _ = fn.normal_equations(x0)
    opts = SolverOptions(max_iterations=1, regularization=1e-5, energy_from_residual=True)

    def accumulate(ef):
        acc = (torch.zeros_like(jtj), torch.zeros_like(jtr), torch.zeros_like(jtr[..., 0]))
        return lambda: ef.accumulate_normal(char, ctx, jc, pt_mat, acc)

    times = {"fk context (PT + K1)": event_ms(lambda: fn.context(x0)),
             "jacobian context (joint axes)": event_ms(lambda: make_jacobian_context(char, ctx))}
    for ef in mods:
        times[f"{type(ef).__name__}.accumulate_normal"] = event_ms(accumulate(ef))
    times["normal_equations (all of the above)"] = event_ms(lambda: fn.normal_equations(x0))
    damp = torch.full_like(jtr, 1e-5)
    times["damped solve (K2+K3)"] = event_ms(lambda: damped_psd_solve(jtj, damp, jtr))
    times["whole GN iteration (solve_ik, 1 iteration)"] = event_ms(
        lambda: solve_ik(fn, x0, options=opts), reps=3)
    return times


def vertex_layer_times(prob) -> dict:
    """ms per call of each layer of one full-batch GN iteration of config 4b
    (a testing.workloads.VertexFitProblem) at its batch."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    fn = SkeletonSolverFunction(prob.char,
                                (dataclasses.replace(prob.ef0, target=prob.targets),))
    x0 = prob.x0
    ctx = fn.context(x0)
    rows, j = fn.residual_and_jacobian(x0)
    jt = j.transpose(-1, -2)
    jtj, jtr = jt @ j, (jt @ rows[..., None])[..., 0]
    damp = torch.full_like(jtr, 1e-5)
    opts = SolverOptions(max_iterations=1, regularization=1e-5, energy_from_residual=True)
    return {
        "mesh context (PT + K1 + blend shapes + skinning + normals)": event_ms(
            lambda: fn.context(x0)),
        "vertex rows + Jacobian (joint axes + skinning walk + PT chain)": event_ms(
            lambda: fn._rows_and_jacobian(ctx, fn.error_functions), reps=3),
        "JtJ + Jtr": event_ms(lambda: (jt @ j, jt @ rows[..., None])),
        "damped solve (K2+K3)": event_ms(lambda: damped_psd_solve(jtj, damp, jtr)),
        "whole GN iteration (solve_ik, 1 iteration)": event_ms(
            lambda: solve_ik(fn, x0, options=opts), reps=3),
    }


def sequence_layer_times(prob) -> dict:
    """ms per call of each layer of one GN iteration of config 5 (a
    testing.workloads.SequenceProblem) at its start, and the kernel launches
    of one iteration."""
    from momentum_tpu_torch.math.linalg import psd_solve
    from momentum_tpu_torch.ops import fk as fk_ops, psd
    from momentum_tpu_torch.sequence import block_tridiag as bt, solver as seq
    from momentum_tpu_torch.solver import SolverOptions

    fn, pf, u = prob.fn, prob.pf0, prob.u0
    opts = SolverOptions(max_iterations=1)
    frame_jac = seq.make_frame_jacobian(fn)
    rows, j_pf, j_u = frame_jac(pf, u)
    j_pf_t = j_pf.transpose(-1, -2)
    system = seq._normal_equations(fn, pf, u)
    (diag, offs, uc, ub, rf, ru, q), _, _ = seq._equilibrate(system, opts)
    if q != 1:
        raise ValueError("profiles the tridiagonal case (sequence windows of 2)")
    nu, f = uc.shape[-1], diag.shape[0]
    rhs = torch.cat([uc, rf[..., None]], dim=-1)
    kp = min(bt.SPIKE_PARTS, max(2, f // bt.SPIKE_CHUNK))
    dd, uu, big = bt._spike_local_systems(diag, offs[0], rhs, kp)
    sol = bt._block_tridiag_solve_thomas_batched(dd, uu, big)
    t_sol = bt.block_tridiag_solve(diag, offs[0], rhs)

    def schur():
        t_inv_u, t_inv_b = t_sol[..., :nu], t_sol[..., nu]
        x_u = psd_solve(ub - torch.einsum("fpu,fpv->uv", uc, t_inv_u),
                        ru - torch.einsum("fpu,fp->u", uc, t_inv_b))
        return t_inv_b - torch.einsum("fpu,u->fp", t_inv_u, x_u)

    times = {
        "frame contexts (PT + K1)": event_ms(lambda: fn.frame_contexts(fn.join(pf, u))),
        "per-frame rows + analytic Jacobian": event_ms(lambda: frame_jac(pf, u)),
        "per-frame JtJ + arrowhead products": event_ms(lambda: (
            j_pf_t @ j_pf, j_pf_t @ j_u, j_u.flatten(0, 1).T @ j_u.flatten(0, 1),
            j_pf_t @ rows[..., None], j_u.flatten(0, 1).T @ rows.flatten())),
    }
    for sef in fn.sequence_errors:
        times[f"{type(sef).__name__} window Jacobians (forward mode)"] = event_ms(
            lambda sef=sef: seq.window_jacobian(fn, sef, pf, u), reps=3)
    times.update({
        "normal equations (all of the above + band products)": event_ms(
            lambda: seq._normal_equations(fn, pf, u), reps=3),
        "equilibration": event_ms(lambda: seq._equilibrate(system, opts)),
        f"SPIKE local systems ({kp} chunks)": event_ms(
            lambda: bt._spike_local_systems(diag, offs[0], rhs, kp)),
        f"SPIKE locals: batched Thomas, {dd.shape[1]} steps (K2+K3)": event_ms(
            lambda: bt._block_tridiag_solve_thomas_batched(dd, uu, big), reps=3),
        f"SPIKE interface LU ({kp} blocks of {2 * diag.shape[-1]}) + chunk rows": event_ms(
            lambda: bt._spike_interface_solve(sol, rhs.shape[-1]), reps=3),
        "whole GN iteration (solve_sequence, 1 iteration)": event_ms(
            lambda: seq.solve_sequence(fn, pf, u, opts), reps=3),
    })
    if nu:
        times["Schur complement + universal solve"] = event_ms(schur)
    torch.cuda.synchronize()
    fk_ops.launches = psd.launches = 0
    seq.solve_sequence(fn, pf, u, opts)
    times["launches of one iteration"] = {"fk_global_kernel": fk_ops.launches,
                                          "damped_chol_solve_kernel": psd.launches}
    return times


def tracking_layer_times(clip, batch: int, lam: float = 0.01) -> dict:
    """ms per call of each layer of one LM iteration of config 6s's pose
    solve (a testing.workloads.TrackingClip) on its first `batch` frames,
    from the true motion plus N(0, 0.02) noise (seed 1): the layers, the
    whole iteration (solve_levenberg_marquardt, 1 iteration), and the host's
    part, the iteration less the layers."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian, solve_levenberg_marquardt
    from momentum_tpu_torch.errors import LimitErrorFunction
    from momentum_tpu_torch.tracking import TrackingConfig
    from momentum_tpu_torch.tracking.tracker import _marker_error_template

    char, markers = clip.char, clip.markers
    ef0, per_frame = _marker_error_template(char, markers, TrackingConfig())
    g = torch.Generator().manual_seed(1)
    x = clip.truth[:batch] + 0.02 * torch.randn(clip.truth[:batch].shape, generator=g).to(
        clip.truth.device)
    pos, occ = markers.positions[:batch], markers.occluded[:batch]
    if batch == 1:
        x, pos, occ = x[0], pos[0], occ[0]
    fn = SkeletonSolverFunction(char, (per_frame(ef0, pos, occ),
                                       LimitErrorFunction.create(device=x.device)))
    rows, jt = ad_jacobian(fn.residual, x)
    jtj, jtr = jt @ jt.transpose(-1, -2), (jt @ rows[..., None])[..., 0]
    damp = lam * torch.clamp(jtj.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-3
    one = SolverOptions(max_iterations=1, regularization=1e-3)
    times = {
        "AD Jacobian (forward mode, FK through K1)": event_ms(
            lambda: ad_jacobian(fn.residual, x), reps=3),
        "JtJ + Jtr": event_ms(lambda: (jt @ jt.transpose(-1, -2), jt @ rows[..., None])),
        "damped solve (K2+K3)": event_ms(lambda: damped_psd_solve(jtj, damp, jtr)),
        "trial energy (FK through K1 + rows)": event_ms(lambda: fn.error(x)),
    }
    whole = event_ms(lambda: solve_levenberg_marquardt(fn.residual, fn.error, x, None, one),
                     reps=3)
    times["host and the rest (the iteration less the layers)"] = whole - sum(times.values())
    times["whole LM iteration (solve_levenberg_marquardt, 1 iteration)"] = whole
    return times


def render_layer_times(char, cam, motion) -> dict:
    """ms per call of each layer of the render clip: FK and skinning of all
    frames, then each layer of frame 0's shadowed render."""
    from momentum_tpu_torch.character.skinning import skin_points
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    light, faces = render.LIGHT_DIR, char.mesh.faces

    def skin(states):
        return skin_points(char.skin_weights, states, char.inverse_bind_pose,
                           char.mesh.vertices)

    states = char.skeleton_states(motion)
    verts = skin(states)[0]
    passes = render.shadowed_passes(cam, verts, faces, 1280, 960)
    screen, colors = passes["camera"][0], passes["camera"][3]["face_attrs"]
    to_light, light_uvz = passes["to_light"], passes["shadow"][0]
    cam_args = raster._kernel_args(screen, faces, 1280, 960, **passes["camera"][3])
    shadow_args = raster._kernel_args(light_uvz, faces, 256, 256)
    fp = cam_args[0].shape[0]  # faces padded to 128: 640 rows, both passes
    cam_out = raster._raster_kernel(*cam_args, True)
    sdepth = raster._raster_kernel(*shadow_args, True)["depth"]

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
        "camera pass: K4b": event_ms(lambda: raster._raster_kernel(*cam_args, True)),
        "shadow pass: light projection + planes": event_ms(
            lambda: raster._tables(render.light_projection(verts, light, 256)(verts), faces,
                                   None, None, None, 128)),
        "shadow pass: binning": event_ms(
            lambda: raster.bin_faces(light_uvz, faces, fp, 256, 256, 8, 128)),
        "shadow pass: K4b": event_ms(lambda: raster._raster_kernel(*shadow_args, True)),
        "shading + shadow lookup + 2x2 box filter": event_ms(shade),
        "whole frame (render_mesh_shadowed + box filter)": event_ms(frame),
    }


def catalog_layer_times(problem, lam: float = 0.01) -> dict:
    """ms per call of each layer of one LM iteration of config C (a
    testing.workloads.CatalogProblem) at its warm starts: the context (FK
    through K1), the analytic Jacobians of the dense modules (blockwise,
    chained through the parameter transform), the forward-mode Jacobian of
    the modules without one (FK through K1), the position module's direct
    normal equations, JᵀJ + Jᵀr of the dense rows, the damped solve (K2+K3),
    the trial energy; the whole iteration (solve_ik, 1 iteration), and the
    host's part, the iteration less the layers."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik

    char, x = problem.char, problem.x0
    efs = tuple(ef for _, ef in problem.modules)
    fn = SkeletonSolverFunction(char, efs)
    direct = [ef for ef in efs if ef.supports_normal_contrib(char)]
    dense = [ef for ef in efs if ef not in direct]
    analytic = [ef for ef in dense if ef.has_analytic_jacobian]
    ad = [ef for ef in dense if not ef.has_analytic_jacobian]
    ctx = fn.context(x)
    rows, jac = fn._rows_and_jacobian(ctx, dense)
    jt = jac.transpose(-1, -2)
    jtj, jtr = jt @ jac, (jt @ rows[..., None])[..., 0]
    damp = lam * torch.clamp(jtj.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5
    p = x.shape[-1]

    def direct_normal():
        from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context

        jc = make_jacobian_context(char, ctx)
        acc = (x.new_zeros(x.shape[:-1] + (p, p)), x.new_zeros(x.shape), x.new_zeros(x.shape[:-1]))
        for ef in direct:
            acc = ef.accumulate_normal(char, ctx, jc, char.parameter_transform.transform, acc)
        return acc

    times = {
        "context (FK through K1)": event_ms(lambda: fn.context(x), reps=3),
        "analytic Jacobians (blockwise, through the parameter transform)": event_ms(
            lambda: fn._rows_and_jacobian(ctx, analytic), reps=3),
        "AD Jacobian (forward mode, FK through K1)": event_ms(
            lambda: fn._rows_and_jacobian(ctx, ad), reps=3),
        "direct normal equations (position)": event_ms(direct_normal, reps=3),
        "JtJ + Jtr of the dense rows": event_ms(lambda: (jt @ jac, jt @ rows[..., None]),
                                                reps=3),
        "damped solve (K2+K3)": event_ms(lambda: damped_psd_solve(jtj, damp, jtr)),
        "trial energy (FK through K1 + every module)": event_ms(lambda: fn.error(x), reps=3),
    }
    one = SolverOptions(max_iterations=1, regularization=1e-5)
    whole = event_ms(lambda: solve_ik(fn, x, options=one, method="levenberg_marquardt"),
                     reps=3)
    times["host and the rest (the iteration less the layers)"] = whole - sum(times.values())
    times["whole LM iteration (solve_ik, 1 iteration)"] = whole
    return times


def keypoint_layer_times(clip, keypoints, lam: float = 0.01) -> dict:
    """ms per call of each layer of one LM iteration of config 6k's batched
    pose solve (markers, limits and the four cameras' keypoint modules, all
    343 frames) at the true motion plus N(0, 0.02) (seed 1): the AD
    Jacobian, JᵀJ + Jᵀr, the damped solve (K2+K3), the trial energy; the
    whole iteration (track_poses_batched, 1 iteration), and the host's part."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian
    from momentum_tpu_torch.testing.workloads import _keypoint_configs
    from momentum_tpu_torch.tracking import track_poses_batched
    from momentum_tpu_torch.tracking.tracker import _frame_solve

    char, markers = clip.char, clip.markers
    cfg = _keypoint_configs()[0]
    solve = _frame_solve(char, markers, cfg, None, keypoints)
    kp_efs = tuple(pf(e0, t, c) for (e0, pf), (t, c) in zip(solve.kp, solve.kp_data))
    fn = SkeletonSolverFunction(char, (solve.per_frame(solve.ef0, markers.positions,
                                                       markers.occluded),)
                                + solve.others + kp_efs)
    g = torch.Generator().manual_seed(1)
    x = clip.truth + 0.02 * torch.randn(clip.truth.shape, generator=g).to(clip.truth.device)
    rows, jt = ad_jacobian(fn.residual, x)
    jtj, jtr = jt @ jt.transpose(-1, -2), (jt @ rows[..., None])[..., 0]
    damp = lam * torch.clamp(jtj.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-3
    times = {
        "AD Jacobian (forward mode, FK through K1)": event_ms(
            lambda: ad_jacobian(fn.residual, x), reps=3),
        "JtJ + Jtr": event_ms(lambda: (jt @ jt.transpose(-1, -2), jt @ rows[..., None])),
        "damped solve (K2+K3)": event_ms(lambda: damped_psd_solve(jtj, damp, jtr)),
        "trial energy (FK through K1 + rows)": event_ms(lambda: fn.error(x)),
    }
    one = dataclasses.replace(cfg, max_iter=1)
    whole = event_ms(lambda: track_poses_batched(char, markers, one, initial=x,
                                                 camera_keypoints=keypoints), reps=3)
    times["host and the rest (the iteration less the layers)"] = whole - sum(times.values())
    times["whole LM iteration (track_poses_batched, 1 iteration)"] = whole
    return times


def device_busy(run):
    """(wall s, device-busy ms, profiler) of one run under torch.profiler:
    the sum of the device-side rows (kernels, memcpy; the aten rows repeat
    their time), one stream, so nothing overlaps. The busy time is None,
    not measured, when the profile saw no device time (kernel_device_ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return prof_wall, device_ms or None, prof


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

    prof_wall, device_ms, prof = device_busy(run)
    events = prof.key_averages()
    if device_ms is None:
        print(f"profiled {label}: wall {prof_wall * 1e3:.2f} ms (profiler on); the profile "
              f"saw no device time, so the idle share is not measured [{card}]")
    else:
        print(f"profiled {label}: wall {prof_wall * 1e3:.2f} ms (profiler on), device busy "
              f"{device_ms:.2f} ms; idle share {1 - device_ms / (prof_wall * 1e3):.3f} of "
              f"the profiled wall, {1 - device_ms / (wall * 1e3):.3f} of the unprofiled "
              f"wall [{card}]")
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
    ap.add_argument("--workload",
                    choices=("ik", "render", "fullstack", "vertex", "sequence", "tracking",
                             "catalog", "keypoints", "both"),
                    default="both", help="both = ik and render")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=1024, help="the sequence's frame count")
    ap.add_argument("--fullbody", action="store_true",
                    help="the sequence on the full-body rig (config 5f)")
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

    if args.workload == "fullstack":
        from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik
        from momentum_tpu_torch.testing.workloads import (
            build_fullstack_problem, make_fullstack_solve)

        char, efs, targets, q, x0 = build_fullstack_problem(args.batch, seed=args.seed,
                                                            device="cuda")
        for name, ms in fullstack_layer_times(char, efs, targets, q, x0).items():
            print(f"full-stack layer B={args.batch}: {name}: {ms:.4f} ms [{card}]")
        fn = SkeletonSolverFunction(char, (dataclasses.replace(efs[0], target=targets),
                                           dataclasses.replace(efs[1], target=q), *efs[2:]))
        one = SolverOptions(max_iterations=1, regularization=1e-5, energy_from_residual=True)
        _wall_and_profile(lambda: solve_ik(fn, x0, options=one), card,
                          f"fullstack-iteration B={args.batch}", args.out, 1, "iterations/s")
        solve = make_fullstack_solve(char, efs, args.batch)
        _wall_and_profile(lambda: solve(targets, q, x0), card,
                          f"fullstack-solve B={args.batch}", args.out, args.batch, "solves/s")

    if args.workload == "vertex":
        from momentum_tpu_torch.testing.workloads import (
            build_vertex_fit_problem, make_vertex_fit_solve)

        prob = build_vertex_fit_problem(device="cuda")
        batch = prob.x0.shape[0]
        for name, ms in vertex_layer_times(prob).items():
            print(f"vertex-fit layer B={batch}: {name}: {ms:.4f} ms [{card}]")
        solve = make_vertex_fit_solve(prob.char, prob.ef0, batch)
        _wall_and_profile(lambda: solve(prob.targets, prob.x0), card,
                          f"vertex-fit B={batch}", args.out, batch, "solves/s")

    if args.workload == "sequence":
        from momentum_tpu_torch.testing.workloads import (
            build_sequence_problem, make_sequence_solve)

        prob = build_sequence_problem(args.frames, fullbody=args.fullbody, seed=args.seed,
                                      device="cuda")
        tag = f"config {'5f' if args.fullbody else '5'} F={args.frames}"
        for name, ms in sequence_layer_times(prob).items():
            print(f"sequence layer {tag}: {name}: "
                  + (f"{ms:.4f} ms" if isinstance(ms, float) else str(ms)) + f" [{card}]")
        solve = make_sequence_solve(prob.fn)
        _wall_and_profile(lambda: solve(prob.pf0, prob.u0), card,
                          f"sequence-{'5f' if args.fullbody else '5'} F={args.frames}",
                          args.out, args.frames, "frames/s")

    if args.workload == "tracking":
        from momentum_tpu_torch.testing.workloads import (
            build_tracking_clip, track_clip_per_frame)
        from momentum_tpu_torch.tracking import MarkerSequence, TrackingConfig, track_poses_batched

        clip = build_tracking_clip(seed=args.seed, device="cuda")
        frames = clip.markers.num_frames
        for batch in (1, frames):
            for name, ms in tracking_layer_times(clip, batch).items():
                print(f"tracking layer B={batch}: {name}: {ms:.4f} ms [{card}]")
        first = MarkerSequence(clip.markers.positions[:32], clip.markers.occluded[:32],
                               clip.markers.names)
        _wall_and_profile(lambda: track_clip_per_frame(clip.char, first, clip.truth[0]), card,
                          "per-frame-tracking of 32 frames", args.out, 32, "frames/s")
        refine = TrackingConfig(max_iter=10, regularization=1e-3, method="levenberg_marquardt")
        _wall_and_profile(lambda: track_poses_batched(clip.char, clip.markers, refine,
                                                      initial=clip.truth), card,
                          f"batched-refine of {frames} frames (LM 10)", args.out, frames,
                          "frames/s")

    if args.workload == "catalog":
        from momentum_tpu_torch.testing.workloads import build_catalog_ik_problem, solve_catalog

        problem = build_catalog_ik_problem(args.batch, seed=args.seed, device="cuda")
        for name, ms in catalog_layer_times(problem).items():
            print(f"catalog layer B={args.batch}: {name}: {ms:.4f} ms [{card}]")
        _wall_and_profile(lambda: solve_catalog(problem), card,
                          f"catalog-solve B={args.batch} (LM 10)", args.out, args.batch,
                          "solves/s")

    if args.workload == "keypoints":
        from momentum_tpu_torch.testing.workloads import (
            build_keypoint_clip, build_tracking_clip, track_clip_keypoints)

        clip = build_tracking_clip(seed=args.seed, device="cuda")
        keypoints = build_keypoint_clip(clip, seed=args.seed)
        frames = clip.markers.num_frames
        for name, ms in keypoint_layer_times(clip, keypoints).items():
            print(f"keypoint layer B={frames}: {name}: {ms:.4f} ms [{card}]")
        # from the clip's seed pose (the rest, the root at frame 0's markers)
        _wall_and_profile(lambda: track_clip_keypoints(clip.char, clip.markers, keypoints,
                                                       clip.seed_params), card,
                          f"keypoint-batched of {frames} frames (LM 15)", args.out, frames,
                          "frames/s")

    if args.workload in ("render", "both"):
        char, motion, cam = build_render_clip(32, seed=args.seed, device="cuda")
        for name, ms in render_layer_times(char, cam, motion).items():
            print(f"render layer: {name}: {ms:.4f} ms [{card}]")
        render_clip = make_render_clip(char, cam)
        _wall_and_profile(lambda: render_clip(motion), card, "render clip of 32 frames",
                          args.out, motion.shape[0], "frames/s")

if __name__ == "__main__":
    main()
