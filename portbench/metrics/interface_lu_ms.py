"""Device time per GN iteration of the SPIKE interface solve
(sequence/block_tridiag.py::_lu_solve, torch.linalg.solve_ex), in ms: the
kernels launched under the host operators named in OPS, over the GN
iterations the solves report, in the traced window that profiles the host
(which links each kernel to its operator)."""

OPS = ("aten::linalg_solve_ex",)


def read(run):
    if run.host_trace is None:
        return None
    iters = run.host_work.get("iterations")
    device_s = run.host_trace.op_device_s(OPS)
    if not iters or device_s is None:
        return None
    return 1e3 * device_s / iters
