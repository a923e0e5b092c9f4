"""point_jacobian_ms reads K6's device time by kernel name over the calls
of the host-profiled window, and nothing where the program launches no K6
(the port before it) or makes no spans."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run as harness
from portbench.tracing import Trace, _union

MS = 1e6  # ns


def _trace(cpu, device):
    """A Trace of host events cpu [(name, start, end)] and device events
    [(name, start, end)], times in ms."""
    t = Trace.__new__(Trace)
    t.window_s = 1.0
    t.cpu_names = [c[0] for c in cpu]
    t.cpu_start = np.asarray([c[1] * MS for c in cpu], np.float64)
    t.cpu_end = np.asarray([c[2] * MS for c in cpu], np.float64)
    t.cpu_id = np.full(len(cpu), -1, np.int64)
    t.device_names = [d[0] for d in device]
    t.device_start = np.asarray([d[1] * MS for d in device], np.float64)
    t.device_end = np.asarray([d[2] * MS for d in device], np.float64)
    t.device_link = np.full(len(device), -1, np.int64)
    t.busy = _union(t.device_start, t.device_end)
    t.busy_s = float(np.sum(t.busy[:, 1] - t.busy[:, 0])) / 1e9
    return t


CALLS = [("compaction.solve", 0, 100), ("compaction.solve", 200, 300)]
K6 = "void (anonymous namespace)::point_jacobian_kernel(float const*, Inputs, int const*)"


def _read(cpu, device):
    run = SimpleNamespace(config={"kind": "ik"}, host_trace=_trace(cpu, device))
    return harness.metric_reader("point_jacobian_ms.ik").read(run)


def test_k6_device_time_a_call():
    device = [(K6, 10, 13), ("elementwise", 13, 20), (K6, 210, 211), (K6, 220, 222)]
    assert _read(CALLS, device) == pytest.approx((3 + 1 + 2) / 2)


@pytest.mark.parametrize("cpu,device", [
    (CALLS, [("elementwise", 10, 20)]),  # the program without K6
    ([("aten::mul", 0, 1)], [(K6, 10, 13)]),  # no spans
])
def test_no_reading(cpu, device):
    assert _read(cpu, device) is None
