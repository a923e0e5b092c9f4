"""Where the time of the bench.py IK workload goes on one CUDA card.

    python -m momentum_tpu_torch.testing.profile_workload [--batch 2048] [--out DIR]

Prints, for the main path (build_fullbody_ik_problem + make_solve_batch,
LM 5 + 6 compacted):
  * each layer of one full-batch LM iteration timed alone with CUDA events
    (FK context, residual + model Jacobian, JᵀJ/Jᵀr, damped solve, trial
    residual), at the batch and at the refinement capacity;
  * the wall time of the whole solve, and the device-busy share from
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


def main():
    from momentum_tpu_torch.testing.workloads import (
        DEFAULT_REFINE, build_fullbody_ik_problem, make_solve_batch)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="directory for the kernel table and trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_workload needs a CUDA device")
    card = card_name_and_power_limit()
    print(f"card: {card}")

    char, ef0, targets, x0 = build_fullbody_ik_problem(args.batch, seed=args.seed,
                                                       device="cuda")
    cap = DEFAULT_REFINE[2]
    for b in (args.batch, cap):
        for name, ms in layer_times(char, ef0, targets[:b], x0[:b]).items():
            print(f"layer B={b}: {name}: {ms:.4f} ms [{card}]")

    solve = make_solve_batch(char, ef0, args.batch)
    solve(targets, x0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(targets, x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"solve B={args.batch}: wall {wall * 1e3:.2f} ms (median of 3), "
          f"{args.batch / wall:.0f} solves/s [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(targets, x0)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side rows only (kernels, memcpy); the aten rows repeat their time
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiled solve: wall {prof_wall * 1e3:.2f} ms (profiler on), device busy "
          f"{device_ms:.2f} ms; idle share {1 - device_ms / (prof_wall * 1e3):.3f} of the "
          f"profiled wall, {1 - device_ms / (wall * 1e3):.3f} of the unprofiled wall [{card}]")
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_table.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))


if __name__ == "__main__":
    main()
