"""K2+K3's share of its roofline in the traced window, in %: the least
time the card could take for every damped (n, n) solve the LM stages did
(each stage's batch × the iterations its SolveResult reports; one solve a
system, bytes 4·(n² + 3n), flops n³/3 + 2n², at 3.35 TB/s or 67 TFLOP/s,
roofline.py) over the device time of the kernels named in KERNELS.

The reckoned count is checked against the program's own counter of K2+K3
calls (momentum_tpu_torch.ops.psd.launches, one call an LM iteration); a
mismatch is printed, and the reckoned work still counts."""

import sys

from portbench.roofline import bound_s, solve_work

KERNELS = ("damped_chol_solve_kernel", "damped_chol_subst_kernel")


def read(run):
    stages = run.work.get("stages")
    kernel_s = run.trace.device_s(KERNELS)
    if not stages or kernel_s is None:
        return None
    n = run.work["n"]
    systems = sum(batch * iters for batch, iters in stages)
    launches = sum(iters for _, iters in stages)
    if launches != run.counters.get("k2k3_launches"):
        print(f"k2k3_roofline: {launches} LM iterations reckoned, the program counted "
              f"{run.counters.get('k2k3_launches')} K2+K3 calls", file=sys.stderr)
    return 100.0 * bound_s(*solve_work(systems, n)) / kernel_s
