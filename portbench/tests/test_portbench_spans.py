"""The readers of the program's spans (host_syncs, sync_idle_ms,
jacobian_device_ms, normal_equations_device_ms) on hand-built traces whose
intervals are known: a known count, a known gap, a known device time, and
no reading where the window holds no span (the program before it had any)."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run as harness
from portbench.tracing import Trace, _union

MS = 1e6  # ns


def _trace(cpu, device):
    """A Trace of host events cpu [(name, start, end, id)] and device events
    [(name, start, end, link)], times in ms."""
    t = Trace.__new__(Trace)
    t.window_s = 1.0
    t.cpu_names = [c[0] for c in cpu]
    t.cpu_start = np.asarray([c[1] * MS for c in cpu], np.float64)
    t.cpu_end = np.asarray([c[2] * MS for c in cpu], np.float64)
    t.cpu_id = np.asarray([c[3] for c in cpu], np.int64)
    t.device_names = [d[0] for d in device]
    t.device_start = np.asarray([d[1] * MS for d in device], np.float64)
    t.device_end = np.asarray([d[2] * MS for d in device], np.float64)
    t.device_link = np.asarray([d[3] for d in device], np.int64)
    t.busy = _union(t.device_start, t.device_end)
    t.busy_s = float(np.sum(t.busy[:, 1] - t.busy[:, 0])) / 1e9
    return t


def _run(kind, trace):
    return SimpleNamespace(config={"kind": kind}, host_trace=trace)


def _ik_trace():
    """Two IK calls. Call 1 (0-100 ms): a Jacobian span (10-20) whose
    operator (id 1, at 11) launches 4 ms of kernels, an lm.sync at 30-40
    after which the card idles from 40 to 45, and an lm.init.sync at 1-2
    with no gap after. Call 2 (200-300): one lm.sync at 250-260, the card
    idle 258-262 (the queue drained before the span ended). A sync outside
    any call (400-410) and a kernel launched outside the spans count for
    nothing."""
    cpu = [("compaction.solve", 0, 100, -1), ("lm.init.sync", 1, 2, -1),
           ("lm.jacobian", 10, 20, -1), ("aten::mul", 11, 12, 1), ("lm.sync", 30, 40, -1),
           ("compaction.solve", 200, 300, -1), ("lm.sync", 250, 260, -1),
           ("aten::add", 50, 51, 2), ("other.sync", 400, 410, -1)]
    device = [("elementwise", 0.5, 40, 0), ("elementwise", 12, 16, 1),
              ("elementwise", 45, 258, 2), ("elementwise", 262, 300, 2)]
    return _trace(cpu, device)


def _take_trace():
    """One take (0-100 ms) of two GN iterations, each with its
    normal-equations span whose operator launches 3 ms of kernels, and two
    syncs: one before any kernel has run, one that leaves the card idle from
    56 to 72 ms."""
    cpu = [("sequence.solve", 0, 100, -1), ("sequence.iteration", 5, 50, -1),
           ("sequence.normal_equations", 6, 20, -1), ("aten::bmm", 7, 8, 1),
           ("sequence.sync", 4, 5, -1), ("sequence.iteration", 50, 95, -1),
           ("sequence.normal_equations", 51, 60, -1), ("aten::bmm", 52, 53, 2),
           ("sequence.index.sync", 60, 70, -1)]
    device = [("gemm", 8, 11, 1), ("gemm", 53, 56, 2), ("other", 72, 90, 3)]
    return _trace(cpu, device)


def _read(name, run):
    return harness.metric_reader(name).read(run)


def test_host_syncs_counts_the_sync_spans_of_a_call():
    assert _read("host_syncs.ik", _run("ik", _ik_trace())) == 3 / 2
    assert _read("host_syncs.take", _run("sequence", _take_trace())) == 2.0


def test_sync_idle_ms_sums_the_gap_after_each_sync():
    # call 1: 40 → 45; call 2: 258 → 262; the init sync lies inside busy time,
    # and its interval's following gap (40 → 45) counts once
    assert _read("sync_idle_ms.ik", _run("ik", _ik_trace())) == pytest.approx((5 + 4) / 2)
    # the index sync at 60-70: the card's last interval (53-56) ends before
    # it, the next starts at 72; the sequence.sync at 4-5 precedes every kernel
    assert _read("sync_idle_ms.take", _run("sequence", _take_trace())) == pytest.approx(16.0)


def test_device_time_under_a_span_a_call():
    assert _read("jacobian_device_ms.ik", _run("ik", _ik_trace())) == pytest.approx(4 / 2)
    assert _read("normal_equations_device_ms.take",
                 _run("sequence", _take_trace())) == pytest.approx((3 + 3) / 2)


@pytest.mark.parametrize("name,kind", [
    ("host_syncs.ik", "ik"), ("host_syncs.take", "sequence"), ("sync_idle_ms.ik", "ik"),
    ("sync_idle_ms.take", "sequence"), ("jacobian_device_ms.ik", "ik"),
    ("normal_equations_device_ms.take", "sequence")])
def test_no_reading_without_spans(name, kind):
    bare = _trace([("aten::mul", 0, 1, 1)], [("elementwise", 0.5, 2, 1)])
    assert _read(name, _run(kind, bare)) is None
    assert _read(name, _run(kind, None)) is None
