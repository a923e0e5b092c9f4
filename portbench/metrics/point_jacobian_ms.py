"""Device time of K6, the position rows' model-space Jacobian
(point_jacobian_kernel, launched through the port's extension and so not
counted by jacobian_device_ms), in ms a call: the device events of that
name in the traced window that profiles the host, over the cell's outermost
spans there. A program without the kernel reads nothing."""

from portbench import spans

KERNELS = ("point_jacobian_kernel",)


def read(run):
    outer = spans.calls(run)
    if outer is None:
        return None
    device_s = run.host_trace.device_s(KERNELS)
    return None if device_s is None else 1e3 * device_s / len(outer)
