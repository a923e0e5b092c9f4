"""K1 and K4b against their previous forms on one CUDA card, in turns, at the
shapes of the port's paths, and the probes that show what holds each back.

    python tools/kernel_ab.py --previous DIR

DIR holds the previous sources `fk.cu` and `raster.cu`: the
`momentum_tpu_torch/csrc` of commit 211fac6, unpacked with

    mkdir -p build/parent
    git archive 211fac6 momentum_tpu_torch | tar -x -C build/parent

Their C interfaces are the ones of the forms they replace:

    fk_global_launch(local, parent, out, batch, nj, stream)
        one thread per batch element walks its joints in order;
    raster_planes_binned_launch(planes, fp, tile_fids, k, overflow, attr_tab,
        n_attr, want_bary, depth, face, bary, attrs, width, height, th, stream)
        one block per tile, an overflow tile scans every face row alone.

The probes build edited copies of the sources; each text edit is asserted
to apply, so a probe raises once its lines change rather than time
something else:
  * the previous K1 with its compose loop compiled out (loads and stores
    only), and with its loads replaced by a constant (compose and stores
    only);
  * the previous K4b on frame 0's camera pass with every overflow flag
    zeroed: its face map is wrong, it times the pass without its overflow
    tile;
  * the current K4b (csrc/raster.cu) with 1 and 32 tiles per set of chunk
    blocks (kGroup, 8), with a minimum of 9 resident blocks per SM
    (__launch_bounds__), without __restrict__ on its tables and images, and
    with the tiles' blocks before the chunk blocks in the grid.
Each build prints ptxas's register counts.

Every time is the device time per launch: CUDA events around 20 launches
queued behind a sleep kernel (profile_workload.event_ms, busy), the median of
ROUNDS rounds with the forms in turns. The current forms are called
through their wrappers, the others through ctypes with their outputs
allocated once. Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from momentum_tpu_torch.ops import build, raster  # noqa: E402
from momentum_tpu_torch.testing.profile_workload import (  # noqa: E402
    card_name_and_power_limit, in_turns)

ROUNDS = 3

# (name, text in the current csrc/raster.cu, replacement)
_K4B_PROBES = (
    ("group 1", "constexpr int kGroup = 8;", "constexpr int kGroup = 1;"),
    ("group 32", "constexpr int kGroup = 8;", "constexpr int kGroup = 32;"),
    ("at least 9 blocks per SM", "__launch_bounds__(kCols) raster_planes_binned_kernel(",
     "__launch_bounds__(kCols, 9) raster_planes_binned_kernel("),
    ("no __restrict__ on tables and images",
     "  const float* __restrict__ planes, const float* __restrict__ attr_tab, int n_attr, \\\n"
     "      int want_bary, float* __restrict__ depth, int* __restrict__ face,             \\\n"
     "      float* __restrict__ bary, float* __restrict__ attrs, int width, int height\n",
     "  const float* planes, const float* attr_tab, int n_attr, int want_bary, float* depth, \\\n"
     "      int* face, float* bary, float* attrs, int width, int height\n"),
    ("tile blocks first",
     "  const int cb = blockIdx.x;  // chunk blocks first,\n"
     "  const int tb = (int)blockIdx.x - n_chunk_blocks;  // then one block per tile\n",
     "  const int tb = (int)blockIdx.x < n_tiles ? (int)blockIdx.x : -1;\n"
     "  const int cb = (int)blockIdx.x - n_tiles;\n"),
)

# (name, text in the previous fk.cu, replacement)
_K1_PROBES = (
    ("loads + stores only", "if (p >= 0) compose(g + p * 8, g + j * 8);", "(void)p;"),
    ("compose + stores only", "sm[e * stride + (i - e * per)] = src[i];",
     "sm[e * stride + (i - e * per)] = 0.5f + 1e-3f * (float)(i & 7);"),
)


def _build_variant(src: pathlib.Path, tag: str, edit=None) -> ctypes.CDLL:
    """nvcc `src` (its text edited by `edit` = (old, new)) into build/ab/
    with the package's flags; the loaded library."""
    text = src.read_text()
    if edit is not None:
        if edit[0] not in text:
            raise RuntimeError(f"{src}: the probe edit {edit[0]!r} does not apply")
        text = text.replace(edit[0], edit[1])
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"lib{tag}.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr}")
    regs = [ln.split(":")[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln]
    print(f"built {tag}: " + " | ".join(regs))
    return ctypes.CDLL(str(lib))


def _previous_fk(lib, skeleton, local):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fk_global_launch.argtypes = [p, p, p, i, i, p]
    lib.fk_global_smem_bytes.argtypes = [i]
    out = torch.empty_like(local)
    nj = local.shape[1]
    args = (local.data_ptr(), skeleton.joint_parent.data_ptr(), out.data_ptr(),
            local.shape[0], nj)

    def run():
        rc = lib.fk_global_launch(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"previous fk_global_kernel: CUDA error {rc}")
        return out

    return run


def _raster_raw(lib, planes, tab, n_attr, fids, ovf, w, h, th, current=False):
    """K4b through ctypes, outputs allocated once: the previous interface or
    (current) this tree's, with the wrapper's merge scratch."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raster_planes_binned_launch.argtypes = (
        [p, i, p, i, p, p, i, i, p, p, p, p, i, i, i] + ([p, p] if current else []) + [p])
    dev = planes.device
    outs = [torch.empty((h, w), dtype=torch.float32, device=dev),
            torch.empty((h, w), dtype=torch.int32, device=dev),
            torch.empty((h, w, 3), dtype=torch.float32, device=dev),
            torch.empty((h, w, n_attr), dtype=torch.float32, device=dev) if n_attr else None]
    args = (planes.data_ptr(), planes.shape[0], fids.data_ptr(), fids.shape[1],
            ovf.data_ptr(), tab.data_ptr() if tab is not None else None, n_attr, 1,
            *(o.data_ptr() if o is not None else None for o in outs), w, h, th)
    if current:
        keys, arrivals = raster._merge_scratch(dev, fids.shape[0], th * 128)
        args += (keys.data_ptr(), arrivals.data_ptr())

    def run():
        rc = lib.raster_planes_binned_launch(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"raster_planes_binned_kernel: CUDA error {rc}")
        return outs

    return run


def k1_ab(previous: pathlib.Path, card: str):
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem

    char, _, _, x0 = build_fullbody_ik_problem(2048, seed=0, device="cuda")
    skel = char.skeleton
    libs = {"previous": _build_variant(previous / "fk.cu", "fk_previous")}
    for name, old, new in _K1_PROBES:
        libs[f"previous, {name}"] = _build_variant(previous / "fk.cu",
                                                   "fk_previous_" + name.split()[0], (old, new))
    local_all = fk.local_skel_states(skel, char.parameter_transform.apply(x0)).contiguous()
    for batch in (2048, 32):
        local = local_all[:batch].contiguous()
        plain = fk_ops.fk_global_plain(skel, local)
        forms = {name: _previous_fk(lib, skel, local) for name, lib in libs.items()}
        forms["current"] = lambda local=local: fk_ops.fk_global(skel, local)
        errs = {name: float((forms[name]() - plain).abs().max())
                for name in ("previous", "current")}
        t = in_turns(forms, ROUNDS, busy=True)
        print(f"K1 B={batch} nJ={local.shape[1]}: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; max|form - plain| previous {errs['previous']:.3e}, current "
            f"{errs['current']:.3e} [{card}]")


def k4b_ab(previous: pathlib.Path, card: str):
    from momentum_tpu_torch.testing.workloads import build_render_clip, render_clip_passes

    char, motion, cam = build_render_clip(32, seed=0, device="cuda")
    passes = render_clip_passes(char, cam, motion)
    lib = _build_variant(previous / "raster.cu", "raster_previous")
    variants = {name: _build_variant(build.CSRC / "raster.cu",
                                     "raster_current_" + "_".join(name.split()[:2]), (old, new))
                for name, old, new in _K4B_PROBES}
    counts = {name: [int(f[name][4].sum()) for f in passes] for name in ("camera", "shadow")}
    print(f"K4b overflow tiles per frame: camera {counts['camera']}, shadow "
          f"{counts['shadow']} (of {passes[0]['camera'][4].numel()} and "
          f"{passes[0]['shadow'][4].numel()} tiles)")

    def current(args):
        return lambda: raster._raster_kernel(*args, True)

    cases = [("frame 0 camera", passes[0]["camera"]), ("frame 5 camera", passes[5]["camera"]),
             ("frame 11 shadow", passes[11]["shadow"])]
    for label, args in cases:
        forms = {"previous": _raster_raw(lib, *args), "current": current(args)}
        for name, vlib in variants.items():
            forms[f"current, {name}"] = _raster_raw(vlib, *args, current=True)
        if label == "frame 0 camera":
            zeroed = args[:4] + (torch.zeros_like(args[4]),) + args[5:]
            forms["previous, overflow zeroed"] = _raster_raw(lib, *zeroed)
        same = torch.equal(forms["previous"]()[1], forms["current"]()["face"])
        t = in_turns(forms, ROUNDS, busy=True)
        print(f"K4b {label} ({int(args[4].sum())} overflow tiles): " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in t.items())
            + f"; face maps identical: {same} [{card}]")

    totals = {"previous": 0.0, "current": 0.0}
    per_pass = {"previous": [], "current": []}
    for frame in passes:
        for name in ("camera", "shadow"):
            args = frame[name]
            t = in_turns({"previous": _raster_raw(lib, *args), "current": current(args)},
                         1, busy=True)
            for form, ms in t.items():
                totals[form] += ms
                per_pass[form].append(round(ms, 4))
    print(f"K4b all {len(per_pass['current'])} passes of the clip, summed: previous "
          f"{totals['previous']:.4f} ms, current {totals['current']:.4f} ms [{card}]")
    for form, times in per_pass.items():
        print(f"K4b per pass (camera, shadow of frame 0, 1, ...) {form}: {times}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--previous", required=True, type=pathlib.Path,
                    help="directory holding the previous fk.cu and raster.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    card = card_name_and_power_limit()
    print(f"card: {card}")
    k1_ab(args.previous, card)
    k4b_ab(args.previous, card)


if __name__ == "__main__":
    main()
