"""Device time of K6's projection form, the camera projection rows'
model-space Jacobian (projection_jacobian_kernel, launched through the
port's extension), in ms a call: the device events of that name in the
traced window that profiles the host, over the calls' outermost spans
(`compaction.solve`) there. A program without the kernel, or without
spans, reads nothing."""

from portbench import spans

KERNELS = ("projection_jacobian_kernel",)
OUTERMOST = "compaction.solve"


def read(run):
    if run.host_trace is None:
        return None
    outer = spans.intervals(run.host_trace, lambda n: n == OUTERMOST)
    device_s = run.host_trace.device_s(KERNELS)
    if not len(outer) or device_s is None:
        return None
    return 1e3 * device_s / len(outer)
