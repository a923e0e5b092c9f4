"""Device time per GN iteration of K2+K3 in the sequence solve (every
damped solve of the SPIKE locals' Thomas steps and the Schur step), in ms:
the kernels named in KERNELS over the GN iterations the solves report."""

KERNELS = ("damped_chol_solve_kernel", "damped_chol_subst_kernel")


def read(run):
    iters = run.work.get("iterations")
    device_s = run.trace.device_s(KERNELS)
    if not iters or device_s is None:
        return None
    return 1e3 * device_s / iters
