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

DIR2 holds `psd.cu` of commit 9afd70a, the K2+K3 whose matrix right-hand
side was substituted column by column in the factor's block, unpacked with

    mkdir -p build/parent_psd
    git archive 9afd70a momentum_tpu_torch/csrc | tar -x -C build/parent_psd

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
  * (parts "psd", with DIR2) K2+K3's matrix right-hand side at the SPIKE
    shapes of the sequence paths (PSD_SHAPES), on random SPD systems of those
    shapes (the kernels' time does not depend on the values): 9afd70a's form,
    today's, the probes of PSD_PROBES built from today's csrc/psd.cu (the
    sweep that chose its KC and register budget), the library's cholesky_ex +
    cholesky_solve and the plain version; today's split into its factor and
    substitution kernels by the profiler; the forward error of each against
    the float64 solve. At k = 1, (2048, 157): x bit-identical to 9afd70a's.
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
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from momentum_tpu_torch.ops import build, raster  # noqa: E402
from momentum_tpu_torch.testing.profile_workload import (  # noqa: E402
    card_name_and_power_limit, in_turns, kernel_device_ms, library_solve, solve_bound)

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
def _build_previous(src: pathlib.Path, tag: str) -> ctypes.CDLL:
    """nvcc `src` into build/ab/ with the package's flags; the loaded library."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{tag}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    regs = [ln.split(":")[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln]
    print(f"built {tag}: " + " | ".join(regs))
    return ctypes.CDLL(str(lib))


def _build_probe(tag: str, edits, source: str = "raster.cu") -> ctypes.CDLL:
    """csrc/<source> with `edits` applied, built by _build_previous."""
    src = (build.CSRC / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"probe {tag}: {old!r} is not found once in csrc/{source}")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}.cu"
    path.write_text(src)
    return _build_previous(path, tag)


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


# (B, n, k) of K2+K3's matrix right-hand sides on the paths: config 5f's SPIKE
# forward step and its other steps, a rank's widest step in config 5fs,
# config G's step, config 5's (and 5c's) forward step
PSD_SHAPES = ((32, 156, 470), (32, 156, 314), (16, 156, 782), (10, 169, 508), (32, 23, 70))
# today's csrc/psd.cu with edits: the substitution's column tile KC and the
# register budget of its blocks (the sweep that chose them); its walk over the
# panels, or the updates in it, compiled out (wrong x: time only); its
# workspace from the device's default memory pool instead of its own
PSD_PROBES = {
    "KC = 64": [("constexpr int kCols = 32;", "constexpr int kCols = 64;")],
    "4 blocks an SM": [("constexpr int kSubstBlocksPerSm = 2;",
                        "constexpr int kSubstBlocksPerSm = 4;")],
    "walk compiled out": [("for (int r0 = 0; r0 < m; r0 += kPanel) {  // L y = b; the back",
                           "for (int r0 = 0; r0 < 0; r0 += kPanel) {  // L y = b; the back"),
                          ("for (int r0 = m - kPanel; r0 >= 0; r0 -= kPanel)  // Lᵀ x = y",
                           "for (int r0 = m - kPanel; r0 >= m; r0 -= kPanel)  // Lᵀ x = y")],
    "updates compiled out": [("i0 < hi; i0 += kWarps * kChunk) {",
                              "i0 < lo; i0 += kWarps * kChunk) {")],
    "default pool": [("cudaMallocFromPoolAsync(\n"
                      "      (void**)&work, floats * sizeof(float) + (k > 1 ? batch * sizeof(int) "
                      ": 0), pool, s);",
                      "cudaMallocAsync(\n"
                      "      (void**)&work, floats * sizeof(float) + (k > 1 ? batch * sizeof(int) "
                      ": 0), s);")],
}
TIME_ONLY = {"walk compiled out", "updates compiled out"}
SYNCED_CALLS = 20  # calls, each followed by a synchronize, of the pool comparison


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


def psd_ab(previous: pathlib.Path, card: str):
    from momentum_tpu_torch.ops import psd

    prev = _build_previous(previous / "psd.cu", "psd_9afd70a")
    probes = {name: _build_probe("psd_probe_" + "".join(c for c in name if c.isalnum()), edits,
                                 "psd.cu") for name, edits in PSD_PROBES.items()}
    psd.damped_chol_solve(*_spd_systems(2, 40, 3))  # build today's form
    log = pathlib.Path(str(build._library_path("psd")) + ".log").read_text()
    print("built psd (today's): " + " | ".join(
        ln.split(":")[-1].strip() for ln in log.splitlines() if "registers" in ln))
    for batch, n, k in PSD_SHAPES:
        a, d, b = _spd_systems(batch, n, k)
        forms = {"previous (9afd70a)": _psd_raw(prev, a, d, b, "9afd70a's psd.cu"),
                 "now": lambda: psd.damped_chol_solve(a, d, b),
                 **{f"probe {name}": _psd_raw(lib, a, d, b, name) for name, lib in probes.items()},
                 "library": library_solve(a, d, b),
                 "plain": lambda: psd.damped_chol_solve_plain(a, d, b)}
        x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
        fwd = {name: float((fn().double() - x64).abs().max() / x64.abs().max())
               for name, fn in forms.items() if name.removeprefix("probe ") not in TIME_ONLY}
        t = in_turns(forms, ROUNDS, busy=True)
        split = {kern: kernel_device_ms(forms["now"], kern) for kern in psd.KERNELS}
        both = kernel_device_ms(forms["now"], psd.KERNELS, per_call=2)
        bnd = solve_bound(batch, n, k)
        print(f"K2+K3 (B={batch}, n={n}, k={k}): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + "; now by the profiler: " + " + ".join(
                f"{kern} {'not measured' if ms is None else f'{ms:.4f}'}"
                for kern, ms in split.items())
            + f" = {'not measured' if both is None else f'{both:.4f}'} ms; bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {bnd['bound_ms'] / t['now']:.1%} of "
            f"it; previous / now {t['previous (9afd70a)'] / t['now']:.2f}x; forward error "
            + ", ".join(f"{name} {e:.2e}" for name, e in fwd.items()) + f" [{card}]")
    # as a path calls it: the host synchronizes between calls, and the
    # default pool gives its memory back at each synchronization
    a, d, b = _spd_systems(*PSD_SHAPES[0])
    forms = {"now": lambda: psd.damped_chol_solve(a, d, b),
             "probe default pool": _psd_raw(probes["default pool"], a, d, b, "default pool")}
    walls = {name: [] for name in forms}
    for _ in range(ROUNDS):
        for name, fn in forms.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SYNCED_CALLS):
                fn()
                torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / SYNCED_CALLS * 1e3)
    print("K2+K3 (B={}, n={}, k={}) called as a path calls it, each call followed by a "
          "synchronize: ".format(*PSD_SHAPES[0]) + ", ".join(
              f"{name} {statistics.median(w):.4f} ms a call" for name, w in walls.items())
          + f" (host clock, median of {ROUNDS} rounds of {SYNCED_CALLS}) [{card}]")
    a, d, b = _spd_systems(2048, 157, 1)
    forms = {"previous (9afd70a)": _psd_raw(prev, a, d, b, "9afd70a's psd.cu"),
             "now": lambda: psd.damped_chol_solve(a, d, b)}
    same = torch.equal(forms["previous (9afd70a)"](), forms["now"]())
    t = in_turns(forms, ROUNDS, busy=True)
    print("K2+K3 (B=2048, n=157, k=1): " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in t.items())
          + f"; x bit-identical to 9afd70a's: {same} [{card}]")
    if not same:
        raise SystemExit("K2+K3 at k = 1 is not bit-identical to 9afd70a's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", type=pathlib.Path,
                    help="directory holding b61b2af's raster.cu, psd.cu and chol.cu")
    ap.add_argument("--previous-psd", type=pathlib.Path,
                    help="directory holding 9afd70a's psd.cu")
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
