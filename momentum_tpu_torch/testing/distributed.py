"""Run a function on the ranks of a fresh `torch.distributed` group, one
spawned process a rank, for the tests and the smoke:

    with Ranks(world, target, args) as ranks:
        ...  # the parent works meanwhile
        results = ranks.results()  # target(rank, world, *args) of each rank

The group's store is a file in a temporary directory (no port is opened);
`init_process_group` gets the timeout, so a rank whose peer died raises
instead of waiting. The parent joins every rank within the same timeout,
kills every rank still alive then, and raises; a rank that raised has its
traceback raised again in the parent. Results travel through torch.save
files: return CPU tensors and plain values.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Ranks"]


def _entry(rank, world, store, backend, threads, timeout, out, target, args):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = {"ok": target(rank, world, *args)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        result = {"error": traceback.format_exc()}
    torch.save(result, out)


class Ranks:
    """`world` spawned processes each calling target(rank, world, *args) in
    one group of `backend`, with `threads` torch threads each."""

    def __init__(self, world: int, target, args=(), timeout: float = 300.0,
                 backend: str = "gloo", threads: int = 1):
        self.timeout = timeout
        self._tmp = tempfile.TemporaryDirectory()
        store = os.path.join(self._tmp.name, "store")
        self._outs = [os.path.join(self._tmp.name, f"rank{r}.pt") for r in range(world)]
        ctx = mp.get_context("spawn")
        self._procs = [ctx.Process(target=_entry, daemon=True,
                                   args=(r, world, store, backend, threads, timeout,
                                         self._outs[r], target, tuple(args)))
                       for r in range(world)]
        self._start = time.monotonic()
        for p in self._procs:
            p.start()

    def results(self) -> list:
        """Each rank's return value, in rank order, once every rank has
        exited; raises if a rank failed or outlived the timeout."""
        deadline = self._start + self.timeout
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self._procs) if p.is_alive()]
        self.close()
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {self.timeout} s; all killed")
        out = []
        for r, (p, path) in enumerate(zip(self._procs, self._outs)):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {p.exitcode} and no result")
            res = torch.load(path, weights_only=False)
            if "error" in res:
                raise RuntimeError(f"rank {r} failed:\n{res['error']}")
            out.append(res["ok"])
        return out

    def close(self) -> None:
        """Kill every rank still alive and wait for each."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self._tmp.cleanup()
