"""Profiling hooks, the MT_PROFILE_* equivalent (common/profile.h:10-130),
after momentum_tpu/utils/profiling.py on torch.profiler.

`profile_scope(name)` is a span: a named region of the solver's phases in
the profiler's trace. While no profiler records, it costs one flag check
and enters nothing. While one records, it is a host-side record-function
region (`_RecordFunctionFast`: torch.profiler.record_function's region
without its device-side mirror; with the card profiled beside the host,
kineto copies a record_function region onto the card's timeline as a
`gpu_user_annotation`, which a reader of the card's busy time would count
as work). The profiler keeps the spans in memory beside the card's kernels,
on the same clock (kineto's), and writes them out when it stops. A span's
parent is the span around it on the same thread, so a solve's spans nest
under its outermost one (`compaction.solve`, `sequence.solve`), and a
phase's self time is its span's wall less what its child spans cover.
`spanned(name)` makes each call of a function such a span.

`host_sync(name, read, ...)` runs `read`, a call that blocks the host until
the card has run all it was given (bool() or float() of a device tensor, a
copy from the host's memory), inside the span `<name>.sync`: one such span a
host sync, so their count is the count of syncs and the card's idle right
after each is the idle that sync leaves.

`start_trace`/`stop_trace` capture the host and the card into a Chrome
trace, the spans included: how an operator sees the solver's phases beside
the card's kernels (chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = ["host_sync", "profile_scope", "spanned", "start_trace", "stop_trace"]

_ACTIVE = {}
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def profile_scope(name: str):
    """A span named `name` (MT_PROFILE_EVENT): a host-side record-function
    region while a profiler records, else a shared null context."""
    if not _recording():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with profile_scope(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_sync(name: str, read, *args, **kwargs):
    """read(*args, **kwargs), which blocks the host on the card, inside the
    span `<name>.sync`."""
    with profile_scope(name + ".sync"):
        return read(*args, **kwargs)


def start_trace(log_dir: str | None = None) -> str:
    """Start a trace of the host and, where there is one, the card; →
    the directory stop_trace writes it into (MOMENTUM_TPU_TRACE_DIR, else
    momentum_tpu_trace under the working directory)."""
    log_dir = log_dir or os.environ.get("MOMENTUM_TPU_TRACE_DIR",
                                        os.path.join(os.getcwd(), "momentum_tpu_trace"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE["prof"], _ACTIVE["dir"] = prof, log_dir
    return log_dir


def stop_trace() -> str:
    """Stop the trace start_trace began and write it, the spans with the
    card's kernels, → the trace file."""
    prof, log_dir = _ACTIVE.pop("prof"), _ACTIVE.pop("dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
