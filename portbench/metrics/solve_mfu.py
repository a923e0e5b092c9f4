"""The whole solve's share of the card's float32 peak, in %: the linear
algebra every implementation of this LM must do, counted from shapes
(roofline.lm_iteration_flops: JᵀJ, Jᵀr, the factor and the substitutions,
per element and iteration, over the iterations each stage's SolveResult
reports), over the wall × 67 TFLOP/s of the traced run's window without
the profiler."""

from portbench.roofline import F32_FLOPS_PER_S, lm_iteration_flops


def read(run):
    work = run.plain.work if run.plain is not None else {}
    stages = work.get("stages")
    if not stages:
        return None
    flops = sum(lm_iteration_flops(batch, work["rows"], work["n"]) * iters
                for batch, iters in stages)
    return 100.0 * flops / (run.plain.window_s * F32_FLOPS_PER_S)
