"""Frames solved by the calls completed in the window, over the window's
seconds: all the work over all the time (host clock)."""


def read(run):
    return run.frames / run.window_s
