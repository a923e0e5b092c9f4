"""Device time of the sequence solve's normal equations, in ms a GN
iteration: the kernels launched by the host operators inside the
program's `sequence.normal_equations` spans (frame and window Jacobians
and their products; K1, launched through the port's extension, counts
apart), over the `sequence.iteration` spans inside the calls, in the
traced window that profiles the host."""

from portbench import spans

SPANS = ("sequence.normal_equations",)


def read(run):
    outer = spans.calls(run)
    if outer is None:
        return None
    iterations = len(spans.named(run, "sequence.iteration", outer))
    device_s = run.host_trace.op_device_s(SPANS)
    if not iterations or device_s is None:
        return None
    return 1e3 * device_s / iterations
