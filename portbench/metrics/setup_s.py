"""Seconds from the start of run.py to the first timed call: imports,
building or loading the kernels, making the inputs and the program's
objects, warm-up (host clock)."""


def read(run):
    return run.setup_s
