"""The program's spans in the traced window that profiles the host
(momentum_tpu_torch/utils/profiling.py: host events the program names, on
the clock of the card's events). A call is one outermost span of its
cell's kind; a span belongs to the call whose outermost span holds it.
Where the program makes no spans, every function here finds none.
"""

from __future__ import annotations

import numpy as np

# the outermost span of one call, by the configuration's `kind`
OUTERMOST = {"ik": "compaction.solve", "sequence": "sequence.solve"}
SYNC = ".sync"  # the suffix of every span around a host sync


def intervals(trace, match) -> np.ndarray:
    """(n, 2) [start, end] in ns of the host events whose name `match`
    accepts, sorted by start."""
    hit = [i for i, n in enumerate(trace.cpu_names) if match(n)]
    iv = np.stack([np.asarray(trace.cpu_start, np.float64)[hit],
                   np.asarray(trace.cpu_end, np.float64)[hit]], axis=1).reshape(-1, 2)
    return iv[np.argsort(iv[:, 0], kind="stable")]


def calls(run):
    """The outermost spans of the cell's calls in the host-profiled window,
    or None where the window has none."""
    name = OUTERMOST.get(run.config.get("kind"))
    if run.host_trace is None or name is None:
        return None
    iv = intervals(run.host_trace, lambda n: n == name)
    return iv if len(iv) else None


def within(iv: np.ndarray, outer: np.ndarray) -> np.ndarray:
    """The rows of `iv` that lie inside one of the disjoint, sorted `outer`."""
    slot = np.searchsorted(outer[:, 0], iv[:, 0], side="right") - 1
    ok = (slot >= 0) & (iv[:, 1] <= outer[np.maximum(slot, 0), 1])
    return iv[ok]


def syncs(run, outer: np.ndarray) -> np.ndarray:
    """The `.sync` spans inside the calls `outer`."""
    return within(intervals(run.host_trace, lambda n: n.endswith(SYNC)), outer)


def named(run, name: str, outer: np.ndarray) -> np.ndarray:
    """The spans called `name` inside the calls `outer`."""
    return within(intervals(run.host_trace, lambda n: n == name), outer)
