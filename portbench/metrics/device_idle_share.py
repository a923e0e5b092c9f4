"""The share of the traced window in which no kernel, copy or set ran on
the card: 1 − (the union of the profiler's device intervals) ÷ the
window's wall, in %, from the window that profiles the card's activity
alone (profiling the host as well slows it, and the share reads higher)."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
