"""The card's idle that the host syncs leave, in ms a call: for each `.sync`
span inside a call, the gap from the end of the card's last busy interval
that started before the span ended to the start of the next one (the queue
drained, the host launching again), each gap counted once, summed over the
window's calls and divided by their count (the traced window that profiles
the host, whose device intervals are on the spans' clock)."""

import numpy as np

from portbench import spans


def read(run):
    outer = spans.calls(run)
    if outer is None:
        return None
    ends = spans.syncs(run, outer)[:, 1]
    busy = run.host_trace.busy
    last = np.searchsorted(busy[:, 0], ends, side="right") - 1
    last = np.unique(last[(last >= 0) & (last + 1 < len(busy))])
    gaps = np.maximum(busy[last + 1, 0] - busy[last, 1], 0.0)
    return float(np.sum(gaps)) / 1e6 / len(outer)
