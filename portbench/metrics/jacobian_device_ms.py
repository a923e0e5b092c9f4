"""Device time of the errors-and-Jacobians layer, in ms a call: the kernels
launched by the host operators inside the program's `lm.jacobian` spans
(the rows and the analytic Jacobian at each LM trial; K1, launched through
the port's extension, is not an operator's and counts apart), over the
cell's outermost spans, in the traced window that profiles the host."""

from portbench import spans

SPANS = ("lm.jacobian",)


def read(run):
    outer = spans.calls(run)
    if outer is None:
        return None
    device_s = run.host_trace.op_device_s(SPANS)
    return None if device_s is None else 1e3 * device_s / len(outer)
