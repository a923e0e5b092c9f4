"""K6's projection form's share of its roofline in the traced window, in
%: the least time the card could take for every launch the LM stages made
(one a stage iteration, each over the stage's batch:
projection_work.projection_jacobian_work, at 3.35 TB/s or 67 TFLOP/s,
roofline.bound_s) over the device time of the kernels named in KERNELS in
the window that profiles the card alone.

The reckoned launch count is checked against the program's own counter
(momentum_tpu_torch.ops.jacobian.projection_launches); a mismatch is
printed, and the reckoned work still counts. A program without the kernel
reads nothing."""

import sys

from portbench.projection_work import projection_jacobian_work
from portbench.roofline import bound_s

KERNELS = ("projection_jacobian_kernel",)


def read(run):
    work = run.work
    stages = work.get("stages")
    kernel_s = run.trace.device_s(KERNELS) if run.trace is not None else None
    if not stages or kernel_s is None or "cameras" not in work:
        return None
    launches = sum(iters for _, iters in stages)
    counted = run.counters.get("projection_launches")
    if launches != counted:
        print(f"projection_jacobian_roofline: {launches} LM iterations reckoned, the program "
              f"counted {counted} launches", file=sys.stderr)
    least = sum(iters * bound_s(*projection_jacobian_work(batch, work["cameras"], work["points"],
                                                          work["joints"], work["n"]))
                for batch, iters in stages)
    return 100.0 * least / kernel_s
