"""K4a, K4b, K2+K3 and K5b against their previous forms on one CUDA card, in
turns, at the shapes of the port's paths.

    python tools/kernel_ab.py --previous DIR [--previous-psd DIR2] [--parts ...]

DIR holds the previous sources `raster.cu`, `psd.cu` and `chol.cu`: the
`momentum_tpu_torch/csrc` of commit b61b2af, unpacked with

    mkdir -p build/parent
    git archive b61b2af momentum_tpu_torch | tar -x -C build/parent

so DIR = build/parent/momentum_tpu_torch/csrc. Their C interfaces:

    raster_planes_launch and raster_planes_binned_launch, as csrc/raster.cu's
        today: K4a scanned every face row at every pixel of every tile;
    chol_blocked_solve_launch(a, damp, b, x, batch, n, stream): K5b's own
        kernel, which its entry point ops/chol.py::chol_solve_blocked now
        replaces by K2+K3's damped_chol_solve_kernel;
    damped_chol_solve_launch(a, damp, b, x, batch, n, stream): K2+K3 before
        it took k right-hand sides and n past 224.

DIR2 holds `psd.cu` of commit 26e885b, the K2+K3 whose factor ran warp 0's
diagonal step while the other warps waited, unpacked with

    mkdir -p build/parent_psd
    git archive 26e885b momentum_tpu_torch/csrc | tar -x -C build/parent_psd

so DIR2 = build/parent_psd/momentum_tpu_torch/csrc. Its interface is
today's damped_chol_solve_launch(a, damp, b, x, batch, n, k, stream).

What is timed:
  * K4a on the small-mesh render's passes (the clip's first 120 faces, frame
    0: camera 1280×960 and shadow 256×256, th = 4) and on frame 0's 612-face
    camera pass with cull=False, beside two probes built from today's
    csrc/raster.cu (PROBES): its stages brought into shared memory by
    cp.async, double-buffered, in place of the register prefetch; and its
    walk of the kept rows compiled out (wrong images: time only);
  * K4b on frame 0's camera pass (one overflow tile), frame 5's (none),
    frame 11's shadow pass (one), and all 64 passes of the clip summed: the
    two forms share the staging of face rows;
  * K5b's previous kernel against its entry point now, with K5a's entry
    point and K2+K3's previous kernel beside them, on the full stack's
    normal equations at B = 2048 padded to n = 160;
  * (parts "psd", with DIR2) K2+K3 at the shapes of the paths, on random SPD
    systems of those shapes (the kernels' time does not depend on the
    values): vector right-hand sides (FUSED_SHAPES) and the SPIKE steps'
    matrix ones (PSD_SHAPES); 26e885b's form, today's, the probes of
    PSD_PROBES built from today's csrc/psd.cu (each undoes one design step
    of the factor), the library's cholesky_ex + cholesky_solve and the plain
    version; for matrix right-hand sides also the factor kernel alone by the
    profiler, each form's in turns, beside the library's cholesky_ex and the
    factor's bound; whether x is bit-identical to 26e885b's, and the forward
    error of each against the float64 solve.
Every time is the device time per launch: CUDA events around 10 launches
queued behind a sleep kernel (profile_workload.event_ms, busy), the median of
ROUNDS rounds with the forms in turns. The current forms are called through
their wrappers, the previous ones through ctypes with their outputs allocated
once. Each build prints ptxas's register counts; every line names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from momentum_tpu_torch.ops import build, raster  # noqa: E402
from momentum_tpu_torch.testing.profile_workload import (  # noqa: E402
    card_name_and_power_limit, factor_bound, fmt_ms, in_turns, kernel_device_ms, library_solve,
    solve_bound)

ROUNDS = 3
SMALL_MESH_FACES = 120  # the small-mesh render of chip_smoke.py

# K4a probes: (old, new) edits of csrc/raster.cu, each old found once
_CP_ASYNC_HELPERS = r"""
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Scans `total` face rows"""
_CP_ASYNC_STAGE = r"""  Row row;
  // K4a: thread s brings row s of the next stage into its own ring slots
  __shared__ float4 ring[2][kStage * 3];
  auto issue = [&](int base, int slot) {
    const int s = base + threadIdx.x;
    if (s < total) {
      const float4* src = reinterpret_cast<const float4*>(planes) + (long long)(first + s) * 3;
      for (int q = 0; q < 3; ++q) cp_async16(&ring[slot][threadIdx.x * 3 + q], src + q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (REJECT) issue(0, 0);
  else row = load_row(planes, fp, ids, first, threadIdx.x, total);
  for (int base = 0, it = 0; base < total; base += kStage, ++it) {
    if (REJECT) {
      issue(base + kStage, (it + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
      row.id = first + base + threadIdx.x;
      row.live = base + threadIdx.x < total;
      if (row.live) {
        row.p0 = ring[it & 1][threadIdx.x * 3];
        row.p1 = ring[it & 1][threadIdx.x * 3 + 1];
        row.p2 = ring[it & 1][threadIdx.x * 3 + 2];
      }
    }"""
PROBES = {
    "cp.async stages": [
        ("\n// Scans `total` face rows", _CP_ASYNC_HELPERS),
        ("  Row row = load_row(planes, fp, ids, first, threadIdx.x, total);\n"
         "  for (int base = 0; base < total; base += kStage) {", _CP_ASYNC_STAGE),
        ("    if (REJECT) row = load_row(planes, fp, ids, first, base + kStage + threadIdx.x, "
         "total);\n", ""),
    ],
    "walk compiled out": [("for (int s = 0; s < m; ++s) {", "for (int s = 0; s < m * 0; ++s) {")],
}


def _build_all(sources: dict) -> dict:
    """nvcc each {name: source path} into build/ab/ with the package's flags,
    all at once; the loaded libraries by name. Prints ptxas's registers and
    spills of each."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / ("lib" + "".join(c for c in name if c.isalnum()) + ".so")
            for name in sources}
    procs = {name: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(libs[name]),
                                     str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
             for name, src in sources.items()}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{out}")
        print(f"built {name}: " + " | ".join(ln.split(":")[-1].strip() for ln in out.splitlines()
                                             if "registers" in ln or "spill" in ln))
    return {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}


def _build_previous(src: pathlib.Path, tag: str) -> ctypes.CDLL:
    return _build_all({tag: src})[tag]


def _probe_source(tag: str, edits, source: str = "raster.cu") -> pathlib.Path:
    """csrc/<source> with `edits` applied, written to build/ab/<tag>.cu."""
    src = (build.CSRC / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"probe {tag}: {old!r} is not found once in csrc/{source}")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}.cu"
    path.write_text(src)
    return path


def _build_probe(tag: str, edits, source: str = "raster.cu") -> ctypes.CDLL:
    return _build_previous(_probe_source(tag, edits, source), tag)


def _outputs(planes, n_attr, w, h):
    dev = planes.device
    return [torch.empty((h, w), dtype=torch.float32, device=dev),
            torch.empty((h, w), dtype=torch.int32, device=dev),
            torch.empty((h, w, 3), dtype=torch.float32, device=dev),
            torch.empty((h, w, n_attr), dtype=torch.float32, device=dev) if n_attr else None]


def _raster_raw(lib, planes, tab, n_attr, fids, ovf, w, h, th):
    """The previous K4a (fids None) or K4b through ctypes, outputs allocated
    once, K4b with the wrapper's merge scratch."""
    p, i = ctypes.c_void_p, ctypes.c_int
    outs = _outputs(planes, n_attr, w, h)
    common = (tab.data_ptr() if tab is not None else None, n_attr, 1,
              *(o.data_ptr() if o is not None else None for o in outs), w, h, th)
    if fids is None:
        fn = lib.raster_planes_launch
        fn.argtypes = [p, i, p, i, i, p, p, p, p, i, i, i, p]
        args = (planes.data_ptr(), planes.shape[0], *common)
    else:
        fn = lib.raster_planes_binned_launch
        fn.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p, i, i, i, p, p, p]
        keys, arrivals = raster._merge_scratch(planes.device, fids.shape[0], th * 128)
        args = (planes.data_ptr(), planes.shape[0], fids.data_ptr(), fids.shape[1],
                ovf.data_ptr(), *common, keys.data_ptr(), arrivals.data_ptr())

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"previous raster kernel: CUDA error {rc}")
        return outs

    return run


def _current(args):
    return lambda: raster._raster_kernel(*args, True)


def raster_ab(previous: pathlib.Path, card: str):
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.testing.workloads import (
        build_render_clip, clip_vertices, render_clip_passes)

    char, motion, cam = build_render_clip(32, seed=0, device="cuda")
    lib = _build_previous(previous / "raster.cu", "raster_previous")
    probes = {name: _build_probe("raster_probe_" + name.split()[0].replace(".", "_"), edits)
              for name, edits in PROBES.items()}
    faces = char.mesh.faces
    small_faces = faces[:SMALL_MESH_FACES].contiguous()
    verts0 = clip_vertices(char, motion[0])
    small = render.shadowed_passes(cam, verts0, small_faces, 1280, 960)
    clip0 = render.shadowed_passes(cam, verts0, faces, 1280, 960)
    k4a = [("small mesh camera pass", small_faces, small["camera"], {}),
           ("small mesh shadow pass", small_faces, small["shadow"], {}),
           ("612-face camera pass, cull=False", faces, clip0["camera"], dict(cull=False))]
    for label, f, (sv, w, h, kw), extra in k4a:
        args = raster._kernel_args(sv, f, w, h, **kw, **extra)
        forms = {"previous": _raster_raw(lib, *args), "current": _current(args)}
        same = torch.equal(forms["previous"]()[1], forms["current"]()["face"])
        forms.update({f"probe {name}": _raster_raw(plib, *args) for name, plib in probes.items()})
        same_async = torch.equal(forms["probe cp.async stages"]()[1], forms["current"]()["face"])
        t = in_turns(forms, ROUNDS, busy=True)
        print(f"K4a {label} ({w}x{h}, F={f.shape[0]}, th={args[7]}): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; face maps identical: {same} (cp.async probe: {same_async}) [{card}]")

    passes = render_clip_passes(char, cam, motion)
    cases = [("frame 0 camera", passes[0]["camera"]), ("frame 5 camera", passes[5]["camera"]),
             ("frame 11 shadow", passes[11]["shadow"])]
    for label, args in cases:
        forms = {"previous": _raster_raw(lib, *args), "current": _current(args)}
        same = torch.equal(forms["previous"]()[1], forms["current"]()["face"])
        t = in_turns(forms, ROUNDS, busy=True)
        print(f"K4b {label} ({int(args[4].sum())} overflow tiles): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; face maps identical: {same} [{card}]")
    totals = {"previous": 0.0, "current": 0.0}
    all_same = True
    for frame in passes:
        for name in ("camera", "shadow"):
            args = frame[name]
            forms = {"previous": _raster_raw(lib, *args), "current": _current(args)}
            all_same &= torch.equal(forms["previous"]()[1], forms["current"]()["face"])
            for form, ms in in_turns(forms, 1, busy=True).items():
                totals[form] += ms
    change = totals["current"] / totals["previous"] - 1
    print(f"K4b all 64 passes of the clip, summed: previous {totals['previous']:.4f} ms, "
          f"current {totals['current']:.4f} ms ({change:+.1%}); face maps identical: "
          f"{all_same} [{card}]")


def chol_ab(previous: pathlib.Path, card: str):
    import dataclasses

    from momentum_tpu_torch.ops import chol
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.workloads import build_fullstack_problem

    char, efs, targets, q, x0 = build_fullstack_problem(2048, seed=0, device="cuda")
    fn = SkeletonSolverFunction(char, (dataclasses.replace(efs[0], target=targets),
                                       dataclasses.replace(efs[1], target=q), *efs[2:]))
    jtj, jtr, _ = fn.normal_equations(x0)
    a, d, b = chol.pad_identity(jtj.contiguous(), torch.full_like(jtr, 1e-5), jtr.contiguous())
    lib = _build_previous(previous / "chol.cu", "chol_previous")
    psd_lib = _build_previous(previous / "psd.cu", "psd_previous")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chol_blocked_solve_launch.argtypes = [p, p, p, p, i, i, p]
    psd_lib.damped_chol_solve_launch.argtypes = [p, p, p, p, i, i, p]
    x_prev = torch.empty_like(b)
    x_psd = torch.empty_like(b)

    def previous_k23():
        rc = psd_lib.damped_chol_solve_launch(a.data_ptr(), d.data_ptr(), b.data_ptr(),
                                              x_psd.data_ptr(), a.shape[0], a.shape[1],
                                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"previous damped_chol_solve_kernel: CUDA error {rc}")
        return x_psd

    def previous_k5b():
        rc = lib.chol_blocked_solve_launch(a.data_ptr(), d.data_ptr(), b.data_ptr(),
                                           x_prev.data_ptr(), a.shape[0], a.shape[1],
                                           torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"previous chol_blocked_solve_kernel: CUDA error {rc}")
        return x_prev

    forms = {"K5b previous (csrc/chol.cu)": previous_k5b,
             "K5b now (chol_solve_blocked -> csrc/psd.cu)":
                 lambda: chol.chol_solve_blocked(a, d, b),
             "K5a (chol_solve -> csrc/psd.cu)": lambda: chol.chol_solve(a, d, b),
             "K2+K3 previous (csrc/psd.cu of DIR)": previous_k23}
    diff = float((previous_k5b() - chol.chol_solve_blocked(a, d, b)).abs().max()
                 / x_prev.abs().max())
    same_k23 = torch.equal(previous_k23(), chol.chol_solve(a, d, b))
    t = in_turns(forms, ROUNDS, busy=True)
    print(f"K5 (B={a.shape[0]}, n={a.shape[1]}, full-stack normal equations): " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in t.items())
        + f"; max|x_previous - x_now| {diff:.2e} of max|x|; K2+K3 previous and now "
        f"bit-identical: {same_k23} [{card}]")


# (B, n) of K2+K3's vector right-hand sides on the paths: config 6s's
# per-frame step, the IK path's second round, config 6s's batched step,
# config 4b's, config U4's, the full stack's B = 1024 and the B = 2048 paths
FUSED_SHAPES = ((1, 73), (128, 157), (343, 73), (256, 165), (2048, 115), (1024, 157),
                (2048, 157))
# (B, n, k) of its matrix right-hand sides: config 5f's SPIKE forward step
# and its other steps, a rank's widest step in config 5fs, config G's step,
# config 5's forward step
PSD_SHAPES = ((32, 156, 470), (32, 156, 314), (16, 156, 782), (10, 169, 508), (32, 23, 70))
# The factor's design steps, each undone by an edit of today's csrc/psd.cu:
# the rank-1 updates fed by shuffles instead of row kk's 16-byte broadcasts;
# the inverse started after the whole factor instead of 4 columns behind it;
# no lookahead (the next diagonal block's (a) after all of (c)); the load
# finished before (a) of panel 0; the register budgets: the fused form at two
# blocks an SM (128 registers a thread) instead of three (80), the
# factor-only form at three instead of two.
_NEXT_A = ("      if (warp == 0) {\n"
           "        bar_sync(2, 64);\n"
           "        diag_factor(A.at(t0, t0), A.rs(), lane, &ok);  // (a) of the next panel, under (c)\n"
           "      } else {\n"
           "        bar_arrive(2, 64);\n"
           "        diag_inverse(A.at(t0, t0), A.rs(), lane);\n"
           "      }\n")
_A0 = ("  if (warp == 0) diag_factor(A.at(0, 0), A.rs(), lane, &ok);  // (a) of panel 0\n"
       "  else if (warp == 1) diag_inverse(A.at(0, 0), A.rs(), lane);\n"
       "  else {\n")
PSD_PROBES = {
    "factor by shuffles": [(
        "    __syncwarp();  // column kk of L in row kk\n"
        "#pragma unroll\n"
        "    for (int g = (kk + 1) / 4 * 4; g < kPanel; g += 4) {\n"
        "      const float4 l = ld4(D + kk * rs + g);\n"
        "      const float lv[4] = {l.x, l.y, l.z, l.w};\n"
        "#pragma unroll\n"
        "      for (int e = 0; e < 4; ++e)\n"
        "        if (g + e > kk && lane >= g + e) rv[g + e] -= lik * lv[e];\n"
        "    }\n",
        "#pragma unroll\n"
        "    for (int jj = kk + 1; jj < kPanel; ++jj) {\n"
        "      const float ljk = __shfl_sync(kAll, lik, jj);\n"
        "      if (lane >= jj) rv[jj] -= lik * ljk;\n"
        "    }\n")],
    "inverse after the factor": [("constexpr int kInverseLag = 4;",
                                  "constexpr int kInverseLag = 32;")],
    "no lookahead": [
        (_NEXT_A, "      if (warp == 0) bar_sync(2, 64);\n      else bar_arrive(2, 64);\n"),
        ("    __syncthreads();  // (c) done\n",
         "    __syncthreads();\n"
         "    if (warp == 0) diag_factor(A.at(t0, t0), A.rs(), lane, &ok);\n"
         "    else if (warp == 1) diag_inverse(A.at(t0, t0), A.rs(), lane);\n"
         "    __syncthreads();  // (c) done\n")],
    "load, then (a) of panel 0": [
        (_A0, "  if (warp >= 2) {\n"),
        ("  }\n  __syncthreads();\n\n  // The panels.",
         "  }\n  __syncthreads();\n"
         "  if (warp == 0) diag_factor(A.at(0, 0), A.rs(), lane, &ok);\n"
         "  else if (warp == 1) diag_inverse(A.at(0, 0), A.rs(), lane);\n"
         "  __syncthreads();\n\n  // The panels.")],
    "fused at 2 blocks an SM": [("constexpr int kFusedBlocksPerSm = 3;",
                                 "constexpr int kFusedBlocksPerSm = 2;")],
    "factor-only at 3 blocks an SM": [("constexpr int kFactorOnlyBlocksPerSm = 2;",
                                       "constexpr int kFactorOnlyBlocksPerSm = 3;")],
}
FACTOR = "damped_chol_solve_kernel"  # the factor's kernel, in both forms


def _spd_systems(batch, n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    j = torch.randn(batch, n + 20, n, generator=g)
    a = j.transpose(-1, -2) @ j
    d = 0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5
    b = torch.randn(batch, n, k, generator=g) if k > 1 else torch.randn(batch, n, generator=g)
    return a.cuda(), d.cuda(), b.cuda()


def _psd_raw(lib, a, d, b, tag):
    """damped_chol_solve_launch of a library built from another psd.cu,
    through ctypes, its output allocated once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.damped_chol_solve_launch.argtypes = [p, p, p, p, i, i, i, p]
    x = torch.empty_like(b)
    k = b.shape[2] if b.ndim == 3 else 1

    def run():
        rc = lib.damped_chol_solve_launch(a.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(),
                                          a.shape[0], a.shape[1], k,
                                          torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{tag}: CUDA error {rc}")
        return x

    return run


def _factor_in_turns(forms: dict) -> dict:
    """The profiler's device time of each form's factor kernel (the first of
    a matrix call's two), median of ROUNDS rounds with the forms in turns."""
    times = {name: [] for name in forms}
    for _ in range(ROUNDS):
        for name, fn in forms.items():
            times[name].append(kernel_device_ms(fn, FACTOR))
    return {name: None if None in t else statistics.median(t) for name, t in times.items()}


def psd_ab(previous: pathlib.Path, card: str):
    from momentum_tpu_torch.ops import psd

    sources = {"26e885b": previous / "psd.cu"}
    for name, edits in PSD_PROBES.items():
        sources[name] = _probe_source("psd_probe_" + "".join(c for c in name if c.isalnum()),
                                      edits, "psd.cu")
    libs = _build_all(sources)
    prev = libs.pop("26e885b")
    psd.damped_chol_solve(*_spd_systems(2, 40, 3))  # build today's form
    log = pathlib.Path(str(build._library_path("psd")) + ".log").read_text()
    print("built psd (today's): " + " | ".join(
        ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln))
    same_all = True
    for batch, n, *rest in FUSED_SHAPES + PSD_SHAPES:
        k = rest[0] if rest else 1
        a, d, b = _spd_systems(batch, n, k)
        forms = {"26e885b": _psd_raw(prev, a, d, b, "26e885b's psd.cu"),
                 "now": lambda: psd.damped_chol_solve(a, d, b),
                 **{f"probe {name}": _psd_raw(lib, a, d, b, name) for name, lib in libs.items()},
                 "library": library_solve(a, d, b),
                 "plain": lambda: psd.damped_chol_solve_plain(a, d, b)}
        same = torch.equal(forms["26e885b"](), forms["now"]())
        same_all &= same
        x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
        fwd = {name: float((fn().double() - x64).abs().max() / x64.abs().max())
               for name, fn in forms.items()}
        t = in_turns(forms, ROUNDS, busy=True)
        bnd = solve_bound(batch, n, k)
        line = (f"K2+K3 (B={batch}, n={n}, k={k}): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
            f"{bnd['bound_ms'] / t['now']:.1%} of it; 26e885b / now "
            f"{t['26e885b'] / t['now']:.3f}x; x bit-identical to 26e885b's: {same}; forward "
            "error " + ", ".join(f"{name} {e:.2e}" for name, e in fwd.items()))
        if k > 1:
            ad = a + torch.diag_embed(d)
            factors = _factor_in_turns(
                {name: fn for name, fn in forms.items() if name not in ("library", "plain")})
            # the library's factor is all of its call: every kernel counts
            factors["library cholesky_ex"] = kernel_device_ms(
                lambda: torch.linalg.cholesky_ex(ad), "", per_call=None)
            fb = factor_bound(batch, n)
            line += ("; the factor alone by the profiler: " + ", ".join(
                f"{name} {fmt_ms(ms)} ms" for name, ms in factors.items())
                + f"; its bound {fb['bound_ms']:.4f} ms ({fb['bound_by']})")
        print(line + f" [{card}]", flush=True)
    if not same_all:
        raise SystemExit("K2+K3 is not bit-identical to 26e885b's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", type=pathlib.Path,
                    help="directory holding b61b2af's raster.cu, psd.cu and chol.cu")
    ap.add_argument("--previous-psd", type=pathlib.Path,
                    help="directory holding 26e885b's psd.cu")
    ap.add_argument("--parts", default="raster,chol,psd",
                    help="comma-separated A/Bs to run: raster, chol, psd")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if parts & {"raster", "chol"} and args.previous is None:
        ap.error("the raster and chol parts need --previous")
    if "psd" in parts and args.previous_psd is None:
        ap.error("the psd part needs --previous-psd")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    card = card_name_and_power_limit()
    print(f"card: {card}")
    if "raster" in parts:
        raster_ab(args.previous, card)
    if "chol" in parts:
        chol_ab(args.previous, card)
    if "psd" in parts:
        psd_ab(args.previous_psd, card)


if __name__ == "__main__":
    main()
