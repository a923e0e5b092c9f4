"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> [--seeds 12]
        [--control-seeds 3] [--seconds 3] [--faults] [--seed0 N] [--out FILE]

In one process: the program's run of the cell on `--seeds` seeds (short
windows, the cell's own sizes and load), then the control on
`--control-seeds` seeds: the plain reference put in the program's place and
computed with TF32 products (the precision below the configuration's float32
with TF32 off), judged as the program is. With `--faults`, each planted
fault of faults.py on the first seed too. Prints every reading and writes
them as JSON to `--out`.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402
from portbench.faults import FAULTS, planted  # noqa: E402

SEED0 = 2_900_000_017  # seeds past 2**31, as the driver's are


def control_hook(cell):
    def call(i):
        with run.matmul_tf32(True):
            return cell.reference_call(i)
    cell.call = call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seed0", type=int, default=SEED0, help="the first seed; then every 7919th")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    bench = run.load_benchmark()
    rows = []

    def one(kind, seed, hook=None):
        t0 = time.perf_counter()
        result, _, numbers = run.run_cell(bench, args.workload, seed, args.seconds, False, dev,
                                          t0, hook=hook)
        row = {"kind": kind, "seed": seed, "correct": result["correct"],
               "attempted": result["attempted"], "failed": result["failed"], **numbers,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)

    seeds = [args.seed0 + 7919 * k for k in range(args.seeds)]
    for seed in seeds:
        one("program", seed)
    for seed in seeds[:args.control_seeds]:
        one("control_tf32", seed, control_hook)
    if args.faults:
        for fault in FAULTS:
            with planted(fault):
                one(f"fault_{fault}", seeds[0])
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
