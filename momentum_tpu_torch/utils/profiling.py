"""Profiling hooks, the MT_PROFILE_* equivalent (common/profile.h:10-130),
after momentum_tpu/utils/profiling.py on torch.profiler: `profile_scope`
names a region in the traces (record_function), and
`start_trace`/`stop_trace` capture a CPU and CUDA trace into a directory
as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["profile_scope", "start_trace", "stop_trace"]

_ACTIVE = {}


@contextlib.contextmanager
def profile_scope(name: str):
    """A named region in torch.profiler traces (MT_PROFILE_EVENT)."""
    with torch.profiler.record_function(name):
        yield


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
    """Stop the trace start_trace began and write it → the trace file."""
    prof, log_dir = _ACTIVE.pop("prof"), _ACTIVE.pop("dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
