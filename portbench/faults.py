"""Faults planted under the timed path, for the checks that `correct`
comes out false: each patches the port's own solver entry, so the harness
runs unchanged on top of it.

  unchanged  the solve returns its start unchanged;
  half       half of the batch (of the frames) is left at its start;
  altered    an answer is altered where it is produced: a batch's answer
             by +0.01 on parameter 3 (the root's x rotation, 0.6°) of
             every frame, a take's by +0.05 on parameter 3 of its first frame.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


def _broken_params(kind: str, params, start, altered_rows, altered_by: float):
    if kind == "unchanged":
        return start.clone()
    out = params.clone()
    if kind == "half":
        half = params.shape[0] // 2
        out[half:] = start[half:]
    elif kind == "altered":
        out[altered_rows, 3] += altered_by
    else:
        raise ValueError(f"unknown fault {kind!r}")
    return out


@contextlib.contextmanager
def planted(kind: str):
    """Both cells' solver entries broken by `kind` inside the block (the
    drivers look them up when they build)."""
    import momentum_tpu_torch.sequence as seq
    import momentum_tpu_torch.solver.gauss_newton as gn

    lm, solve_sequence = gn.solve_levenberg_marquardt, seq.solve_sequence

    def broken_lm(residual_fn, error_fn, x0, *args, **kwargs):
        res = lm(residual_fn, error_fn, x0, *args, **kwargs)
        return res._replace(params=_broken_params(kind, res.params, x0, slice(None), 0.01))

    def broken_sequence(fn, pf0, u0, *args, **kwargs):
        res = solve_sequence(fn, pf0, u0, *args, **kwargs)
        return res._replace(per_frame=_broken_params(kind, res.per_frame, pf0, 0, 0.05),
                            universal=u0.clone() if kind == "unchanged" else res.universal)

    gn.solve_levenberg_marquardt, seq.solve_sequence = broken_lm, broken_sequence
    try:
        yield
    finally:
        gn.solve_levenberg_marquardt, seq.solve_sequence = lm, solve_sequence
