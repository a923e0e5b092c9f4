"""Where one system's time goes in K2+K3's factor (csrc/psd.cu), on a CUDA
card: a probe build of csrc/psd.cu whose first block stamps clock64() at the
steps of its factor, at the shapes of the port's paths.

    python tools/psd_clocks.py [--blocks-per-sm 2]

The probe is today's csrc/psd.cu with text edits (each anchor must be found
once): a __device__ array of stamps, written by lane 0 of a warp of block 0
at each mark, and an extern "C" probe_clocks that copies it out. Cycles count
from the block's start, on the SM's clock (nvidia-smi's SM clock is printed
beside them). Marks:
  load0   the block barrier after block (0, 0)'s rows are in;
  a0      warp 0's factor of block (0, 0), and inv0, warp 1's inverse;
  w2 loaded  warp 2's copies of the rest in;
  loaded  the block barrier after the whole load;
  per panel p: slab, warp 0 past named barrier 1 (its 16 rows of L21 and
  warp 1's in); unit, warp 0 past named barrier 2 (the next diagonal block
  updated); a, warp 0's factor of it; inv, warp 1's inverse; w2, warp 2 done
  with its units of (c); c, the block barrier closing the panel;
  out, the factor handed on (k > 1); end, x stored (k = 1).
--blocks-per-sm builds the probe with that register budget for both forms
(kFusedBlocksPerSm, kFactorOnlyBlocksPerSm) instead of the source's.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from momentum_tpu_torch.ops import build  # noqa: E402
from momentum_tpu_torch.testing.profile_workload import card_name_and_power_limit  # noqa: E402

SHAPES = ((1, 157, 1), (128, 157, 1), (2048, 157, 1), (32, 156, 470), (10, 169, 508))
_MARK = ("#define MARK(k) if (blockIdx.x == 0 && lane == 0) g_clk[k] = clock64() - c0;\n")
EDITS = [
    ("namespace {\n\nconstexpr int kPanel",
     "__device__ long long g_clk[64];\nnamespace {\n\nconstexpr int kPanel"),
    ("  const int warp = tid >> 5;\n  const float* as = a + sys * n * n;",
     "  const int warp = tid >> 5;\n  const long long c0 = clock64();\n" + _MARK
     + "  const float* as = a + sys * n * n;"),
    ("    if ((lane & 7) == warp && lane < n0) *A.at(lane, lane) += d0;\n  }\n  __syncthreads();\n",
     "    if ((lane & 7) == warp && lane < n0) *A.at(lane, lane) += d0;\n  }\n  __syncthreads();\n"
     "  if (tid == 0) { MARK(0) }\n"),
    ("    cp_async_wait_all();\n    if constexpr (!kInWorkspace) {\n#pragma unroll\n",
     "    cp_async_wait_all();\n    if (warp == 2) { MARK(40) }\n    if constexpr (!kInWorkspace) {\n#pragma unroll\n"),
    ("  if (warp == 0) diag_factor(A.at(0, 0), A.rs(), lane, &ok);  // (a) of panel 0\n"
     "  else if (warp == 1) diag_inverse(A.at(0, 0), A.rs(), lane);\n",
     "  if (warp == 0) { diag_factor(A.at(0, 0), A.rs(), lane, &ok); MARK(1) }\n"
     "  else if (warp == 1) { diag_inverse(A.at(0, 0), A.rs(), lane); MARK(39) }\n"),
    ("  }\n  __syncthreads();\n\n  // The panels.",
     "  }\n  __syncthreads();\n  if (tid == 0) { MARK(2) }\n\n  // The panels."),
    ("      bar_sync(1, 64);\n",
     "      bar_sync(1, 64);\n      const int pp = r0 / kPanel;\n"
     "      if (tid == 0) { MARK(3 + 4 * pp) }\n"),
    ("        bar_sync(2, 64);\n"
     "        diag_factor(A.at(t0, t0), A.rs(), lane, &ok);  // (a) of the next panel, under (c)\n",
     "        bar_sync(2, 64);\n        if (tid == 0) { MARK(4 + 4 * pp) }\n"
     "        diag_factor(A.at(t0, t0), A.rs(), lane, &ok);  // (a) of the next panel, under (c)\n"
     "        if (tid == 0) { MARK(5 + 4 * pp) }\n"),
    ("        diag_inverse(A.at(t0, t0), A.rs(), lane);\n",
     "        diag_inverse(A.at(t0, t0), A.rs(), lane);\n        if (warp == 1) { MARK(57 + pp) }\n"),
    ("        trailing_unit(A, r0, t0 + kPanel * r, t0 + kPanel * c + 16 * (u & 1), lane);\n"
     "      }\n    }\n",
     "        trailing_unit(A, r0, t0 + kPanel * r, t0 + kPanel * c + 16 * (u & 1), lane);\n"
     "      }\n      if (warp == 2) { MARK(50 + r0 / kPanel) }\n    }\n"),
    ("    __syncthreads();  // (c) done\n",
     "    __syncthreads();  // (c) done\n    if (tid == 0) { MARK(6 + 4 * (r0 / kPanel)) }\n"),
    ("    if (tid == 0) ok_out[sys] = ok;\n  }\n",
     "    if (tid == 0) ok_out[sys] = ok;\n  }\n  if (tid == 0) { MARK(44) }\n"),
    ("    for (int i = tid; i < n; i += kThreads) x[sys * n + i] = ok ? y[i] : nanf(\"\");\n",
     "    for (int i = tid; i < n; i += kThreads) x[sys * n + i] = ok ? y[i] : nanf(\"\");\n"
     "    if (tid == 0) { MARK(45) }\n"),
    ("}  // extern \"C\"",
     "int probe_clocks(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n}  // extern \"C\""),
]


def build_probe(blocks_per_sm: int | None) -> ctypes.CDLL:
    src = (build.CSRC / "psd.cu").read_text()
    edits = list(EDITS)
    if blocks_per_sm is not None:
        for form in ("kFusedBlocksPerSm", "kFactorOnlyBlocksPerSm"):
            edits.append((f"constexpr int {form} = ",
                          f"constexpr int {form} = {blocks_per_sm};  // "))
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"psd_clocks: {old!r} is not found once in csrc/psd.cu")
        src = src.replace(old, new)
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"psd_clocks{blocks_per_sm or ''}"
    (out_dir / f"{tag}.cu").write_text(src)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{tag}.so"),
                           str(out_dir / f"{tag}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{proc.stderr}")
    print(f"built {tag}: " + " | ".join(ln.split(":")[-1].strip() for ln in
                                        (proc.stdout + proc.stderr).splitlines()
                                        if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(str(out_dir / f"lib{tag}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.damped_chol_solve_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.probe_clocks.argtypes = [p]
    return lib


def _spd(batch, n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    j = torch.randn(batch, n + 20, n, generator=g)
    a = j.transpose(-1, -2) @ j
    d = 0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5
    b = torch.randn(batch, n, k, generator=g) if k > 1 else torch.randn(batch, n, generator=g)
    return a.cuda(), d.cuda(), b.cuda()


def clocks(lib, batch, n, k) -> list:
    """Block 0's stamps of the third of three launches at (batch, n, k)."""
    a, d, b = _spd(batch, n, k)
    x = torch.empty_like(b)
    stamps = torch.zeros(64, dtype=torch.int64)
    for _ in range(3):
        torch.cuda.synchronize()
        rc = lib.damped_chol_solve_launch(a.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(),
                                          batch, n, k, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch: CUDA error {rc}")
        torch.cuda.synchronize()
    if lib.probe_clocks(stamps.data_ptr()) != 0:
        raise RuntimeError("probe_clocks failed")
    return stamps.tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[None],
                    help="register budgets to build (default: the source's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("psd_clocks needs a CUDA device")
    card = card_name_and_power_limit()
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; SM clock now, max: {clk}")
    for bps in args.blocks_per_sm:
        lib = build_probe(bps)
        for batch, n, k in SHAPES:
            c = clocks(lib, batch, n, k)
            parts = [f"load0 {c[0]}", f"a0 {c[1]} inv0 {c[39]}", f"w2 loaded {c[40]}",
                     f"loaded {c[2]}"]
            for p in range(-(-n // 32) - 1):
                parts.append(f"p{p}: slab {c[3 + 4 * p]} unit {c[4 + 4 * p]} a {c[5 + 4 * p]} "
                             f"inv {c[57 + p]} w2 {c[50 + p]} c {c[6 + 4 * p]}")
            parts.append(f"out {c[44]}" if k > 1 else f"end {c[45]}")
            budget = "source's" if bps is None else f"{bps} blocks an SM"
            print(f"({batch}, {n}, {k}), {budget}: " + "; ".join(parts) + f" [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
