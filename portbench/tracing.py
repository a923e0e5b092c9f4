"""The traced windows: torch.profiler over the calls, reduced to what the
per-layer readers and the result's `breakdown` need, and the card's name.

`card_name_and_power_limit` is a frozen copy of
momentum_tpu_torch/testing/profile_workload.py::card_name_and_power_limit
(commit 45bf5184d6b6a7fbab3c206b266155535e341f3c). The retry of a profile
that saw no device time follows that file's `kernel_device_ms`: on one H100
the profiler once stopped seeing kernels part-way through a process, so a
blind profile is taken again, and a reading it cannot give stays missing.
"""

from __future__ import annotations

import subprocess
from collections import defaultdict

import numpy as np
import torch

PROFILE_ATTEMPTS = 3  # traced windows taken before the device time counts as not measured
_GAPS_NAMED = 200  # longest idle gaps whose host activity is looked up


def card_name_and_power_limit() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` names it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged [start, end) intervals of the given ones, sorted."""
    order = np.argsort(starts, kind="stable")
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.float64).reshape(-1, 2)


class Trace:
    """One traced window: its wall `window_s`, the device events (kernels,
    copies, sets) and the host's events, read from the profiler's raw
    kineto events (times in ns)."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                dev.append((name, start, end, e.linked_correlation_id()))
            else:
                # an operator's own id is what its kernels link to; the
                # runtime's calls and the profiler's own events reuse ids
                cpu.append((name, start, end,
                            e.correlation_id() if name.startswith("aten::") else -1))
        self.device_names = [r[0] for r in dev]
        self.device_start = np.asarray([r[1] for r in dev], np.float64)
        self.device_end = np.asarray([r[2] for r in dev], np.float64)
        self.device_link = np.asarray([r[3] for r in dev], np.int64)
        self.cpu_names = [r[0] for r in cpu]
        self.cpu_start = np.asarray([r[1] for r in cpu], np.float64)
        self.cpu_end = np.asarray([r[2] for r in cpu], np.float64)
        self.cpu_id = np.asarray([r[3] for r in cpu], np.int64)
        self.busy = _union(self.device_start, self.device_end)
        self.busy_s = float(np.sum(self.busy[:, 1] - self.busy[:, 0])) / 1e9

    @property
    def blind(self) -> bool:
        return self.busy_s <= 0.0

    def device_s(self, names) -> float | None:
        """Seconds of the device events whose name contains one of `names`,
        or None where there is none."""
        hit = [i for i, n in enumerate(self.device_names) if any(k in n for k in names)]
        if not hit:
            return None
        return float(np.sum(self.device_end[hit] - self.device_start[hit])) / 1e9

    def op_device_s(self, op_names) -> float | None:
        """Seconds of the device events launched from inside the host
        operators named `op_names` exactly (the operator that launched each
        event, by the profiler's link, started within one of them), or None
        where none ran or none launched anything."""
        ops = [i for i, n in enumerate(self.cpu_names) if n in op_names]
        if not ops or not self.device_names:
            return None
        order = np.argsort(self.cpu_start[ops])
        lo, hi = self.cpu_start[ops][order], self.cpu_end[ops][order]
        launch = {k: t for k, t in zip(self.cpu_id.tolist(), self.cpu_start.tolist()) if k >= 0}
        t = np.asarray([launch.get(int(k), -1.0) for k in self.device_link])
        slot = np.searchsorted(lo, t, side="right") - 1
        inside = (t >= 0) & (slot >= 0) & (t <= hi[np.maximum(slot, 0)])
        total = float(np.sum((self.device_end - self.device_start)[inside])) / 1e9
        return total if total > 0 else None

    def device_ops(self) -> list:
        """[name, seconds] of the ten device operations that took most time."""
        by_name = defaultdict(float)
        for n, s, e in zip(self.device_names, self.device_start, self.device_end):
            by_name[n] += (e - s) / 1e9
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    def idle_gaps(self) -> list:
        """[name, seconds] of the ten host events under which the device idled
        longest (the innermost one running at each of the longest gaps'
        midpoints)."""
        gaps = np.stack([self.busy[:-1, 1], self.busy[1:, 0]], axis=1)
        lengths = gaps[:, 1] - gaps[:, 0]
        idle = defaultdict(float)
        for g in np.argsort(-lengths)[:_GAPS_NAMED]:
            mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
            covering = np.nonzero((self.cpu_start <= mid) & (self.cpu_end >= mid))[0]
            name = ("no host event" if covering.size == 0 else self.cpu_names[
                covering[np.argmin(self.cpu_end[covering] - self.cpu_start[covering])]])
            idle[name] += float(lengths[g]) / 1e9
        return [[n, t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
