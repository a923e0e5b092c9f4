"""The benchmark of momentum_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card: builds its inputs and the
program from the seed (set-up), warms every shape the cell uses, calls the
program in a closed loop for `--seconds` (the window), then judges a sample
of the window's answers, drawn from the seed, against the plain reference
under portbench/reference/. It prints the card's name and power limit
first, each number compared beside its limit as the last lines on standard
error, and one JSON line last on standard output. `--trace 1` reports the
cell's per-layer metrics instead of its end-to-end ones, from three windows
of the traffic file's `trace_seconds` each: one without the profiler (the
host-clock readings and the driver's spans, synchronized on each side), one
profiling the card's activity alone (busy time, kernels, the judged
answers), and one profiling the host beside it (what the host did while the
card idled, and device time by the host operator that launched it).

Everything that belongs to one configuration, traffic mix or metric is
found by name: portbench/configs/<config>.json (its `kind` names
portbench/drivers/<kind>.py), portbench/traffic/<cell>.json and
portbench/metrics/<metric>.py, where a metric named `<reader>.<part>`
(one quantity split by the cells that report it) is read by <reader>.py. A run without a CUDA card, or with fewer
cards than the cell asks for, exits with code 3 and prints no result.
"""

import time

_T0 = time.perf_counter()  # set-up counts from here: imports, builds, inputs, warm-up

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no process of the benchmark may load: JAX and
# the JAX package (momentum_tpu_torch differs from momentum_tpu as a whole name)
FORBIDDEN = ("jax", "jaxlib", "flax", "momentum_tpu")


def forbidden_modules(names=FORBIDDEN) -> list:
    """The loaded modules whose top-level name is one of `names`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve_cell(bench: dict, name: str, root: pathlib.Path = ROOT):
    """(cell entry, configuration, traffic) of the cell `name`, each file
    found by the names BENCHMARK.json gives."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())
    return cell, config, traffic


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The reader module of the metric `name`: metrics/<name up to its first dot>.py."""
    return load_module(root / "portbench" / "metrics" / f"{name.split('.')[0]}.py")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of `kind` ("end_to_end" or "per_layer") that the
    cell reports (every per-layer entry lists its cells)."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


@contextlib.contextmanager
def matmul_tf32(on: bool):
    """float32 products in TF32 (on) or in float32 (off) inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _finite(out) -> torch.Tensor:
    parts = out if isinstance(out, tuple) else (out,)
    ok = torch.isfinite(parts[0]).all()
    for t in parts[1:]:
        ok = ok & torch.isfinite(t).all()
    return ok


def host_probe_ms() -> float:
    """The wall of a fixed piece of pure Python: how fast the host runs the
    program's own Python at this moment (printed, never a metric)."""
    t = time.perf_counter()
    sum(i * i for i in range(300_000))
    return 1e3 * (time.perf_counter() - t)


def stolen_jiffies() -> tuple:
    """(the machine's CPU time, the part the hypervisor stole) in jiffies
    from /proc/stat, for the stderr line that says what the host gave the
    run (printed, never a metric)."""
    try:
        fields = [int(v) for v in pathlib.Path("/proc/stat").read_text().split("\n")[0].split()[1:]]
        return sum(fields[:8]), fields[7]
    except (OSError, ValueError, IndexError):
        return 0, 0


def _window(cell, device, seconds: float, rng, keep: int, profiler=None):
    """Closed-loop calls for `seconds`: (walls, window_s, kept, failed),
    `kept` a uniform sample (reservoir, drawn from `rng`) of `keep` calls'
    (index, answer)."""
    from portbench.rig import sync

    walls, kept = [], []
    bad = torch.zeros((), dtype=torch.int64, device=device)
    with profiler if profiler is not None else contextlib.nullcontext():
        start = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            out = cell.call(i)
            bad += ~_finite(out)
            sync(device)
            walls.append(time.perf_counter() - t)
            if i < keep:
                kept.append((i, out))
            elif keep:
                j = int(rng.integers(0, i + 1))
                if j < keep:
                    kept[j] = (i, out)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    return walls, window_s, kept, int(bad)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, hook=None, root: pathlib.Path = ROOT):
    """Run one cell; (result dict, lines naming each number compared, every
    reading of the judge).
    `hook(cell)`, where given, runs after set-up and may replace the
    program's calls (the control and the tests' faults)."""
    cell_entry, config, traffic = resolve_cell(bench, name, root)
    driver = load_module(root / "portbench" / "drivers" / f"{config['kind']}.py")
    t_build = time.perf_counter()
    with matmul_tf32(False):
        cell = driver.build(config, traffic, seed, device)
    if hook is not None:
        hook(cell)
    t_warm = time.perf_counter()
    cell.warm()
    # what set-up made stays alive through the run: keep it out of the
    # collector's passes in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s: imports and the card {t_build - t0:.3f} s, inputs and "
          f"program {t_warm - t_build:.3f} s, warm-up {t0 + setup_s - t_warm:.3f} s",
          file=sys.stderr, flush=True)
    probe, jiffies = [host_probe_ms()], [stolen_jiffies()]
    rng = np.random.default_rng(seed % 2 ** 63)
    c0 = cell.counters()
    trace_obj = host_trace = plain = host_work = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from portbench.tracing import PROFILE_ATTEMPTS, Trace

        window = min(seconds, traffic["trace_seconds"])
        # the host clock's readings and the driver's spans, without the profiler
        cell.spans = True
        cell.reset_work()
        p_walls, p_window_s, _, p_failed = _window(cell, device, window, rng, 0)
        plain = SimpleNamespace(walls=p_walls, window_s=p_window_s, work=copy.deepcopy(cell.work))
        cell.spans = False
        # the card's activity alone: the profiler costs the host little here
        for _ in range(PROFILE_ATTEMPTS):
            prof = profile(activities=[ProfilerActivity.CUDA])
            cell.reset_work()
            c0 = cell.counters()
            walls, window_s, kept, failed = _window(cell, device, window, rng,
                                                    traffic["judged_calls"], prof)
            trace_obj = Trace(prof, window_s)
            if not trace_obj.blind:
                break
            print("the profile saw no device time: taking it again", file=sys.stderr, flush=True)
        if trace_obj.blind:
            raise SystemExit(f"{PROFILE_ATTEMPTS} profiles saw no device time: busy_s is "
                             "not measured, so no result is printed")
        c1 = cell.counters()
        work = copy.deepcopy(cell.work)
        # the host beside the card: its operators link the kernels they launch
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        cell.reset_work()
        h_walls, h_window_s, _, h_failed = _window(cell, device, window, rng, 0, prof)
        host_trace, host_work = Trace(prof, h_window_s), copy.deepcopy(cell.work)
        print(f"traced windows: {len(p_walls)} calls in {p_window_s:.3f} s unprofiled, "
              f"{len(walls)} in {window_s:.3f} s with the card profiled (idle "
              f"{100 * (1 - trace_obj.busy_s / window_s):.2f}%, "
              f"{len(trace_obj.device_names) / max(len(walls), 1):.0f} device events a call), "
              f"{len(h_walls)} in {h_window_s:.3f} s with the host profiled too (idle "
              f"{100 * (1 - host_trace.busy_s / h_window_s):.2f}%)", file=sys.stderr, flush=True)
        failed += p_failed + h_failed
        attempted = len(walls) + len(p_walls) + len(h_walls)
    else:
        walls, window_s, kept, failed = _window(cell, device, seconds, rng,
                                                traffic["judged_calls"])
        c1 = cell.counters()
        work = cell.work
        attempted = len(walls)
    jiffies.append(stolen_jiffies())
    probe.append(host_probe_ms())
    stolen = (jiffies[1][1] - jiffies[0][1]) / max(jiffies[1][0] - jiffies[0][0], 1)
    print(f"host probe {probe[0]:.2f} ms before the window, {probe[1]:.2f} ms after; the "
          f"machine's CPU time stolen {100 * stolen:.2f}%", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.release()
    with matmul_tf32(False):
        numbers = cell.judge(kept)
    limits = traffic["limits"]
    checks = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items()}
    correct = (failed == 0 and bool(kept)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    run = SimpleNamespace(
        walls=walls, window_s=window_s, calls=len(walls), setup_s=setup_s,
        frames=len(walls) * cell.frames_per_call, peak_bytes=peak, trace=trace_obj,
        work=work, counters={k: c1[k] - c0[k] for k in c1}, plain=plain,
        host_trace=host_trace, host_work=host_work, config=config, traffic=traffic,
        cell=cell_entry)
    metrics = {}
    for m in metrics_of(bench, name, "per_layer" if trace else "end_to_end"):
        value = metric_reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": cell_entry["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=trace_obj.busy_s, window_s=trace_obj.window_s)
        result["breakdown"] = {"device_ops": trace_obj.device_ops(),
                               "idle_gaps": host_trace.idle_gaps()}
    result["checks"] = checks
    others = {k: v for k, v in numbers.items() if k not in limits}
    lines = [f"judged calls {[i for i, _ in kept]} of {len(walls)}; failed {failed}; "
             f"stages {_stages(work)}; "
             f"other readings {json.dumps(others)}"]
    lines += [f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    return result, lines, numbers


def _stages(work: dict) -> str:
    """The solver iterations the window's calls ran, counted by kind."""
    counts = {}
    for stage in work.get("stages", ()):
        counts[stage] = counts.get(stage, 0) + 1
    if "iterations_each" in work:
        for it in work["iterations_each"]:
            counts[it] = counts.get(it, 0) + 1
    return json.dumps({str(k): v for k, v in sorted(counts.items())})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell, _, _ = resolve_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 3
    from portbench.tracing import card_name_and_power_limit

    print(f"card: {card_name_and_power_limit()}", file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded at start-up: {found}", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    result, lines, _ = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), _T0)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded after the window: {found}", file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
