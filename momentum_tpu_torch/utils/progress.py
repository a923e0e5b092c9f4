"""Terminal progress bar (reference: common/progress_bar.h ProgressBar), the
port's own copy of momentum_tpu/utils/progress.py.

Host-side only. Prints to stderr so piped
JSON/stdout output stays clean; silent when stderr is not a TTY unless
forced.
"""

from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar"]


class ProgressBar:
    """progress_bar.h: named bar over `total` operations with increment()."""

    def __init__(self, name: str, total: int, width: int = 40,
                 stream=None, force: bool = False):
        self.name = name
        self.total = max(int(total), 1)
        self.width = width
        self.count = 0
        self._stream = stream if stream is not None else sys.stderr
        self._enabled = force or (
            hasattr(self._stream, "isatty") and self._stream.isatty())
        self._t0 = time.monotonic()
        self._draw()

    def increment(self, n: int = 1) -> None:
        self.count = min(self.count + n, self.total)
        self._draw()

    def set_progress(self, count: int) -> None:
        self.count = min(int(count), self.total)
        self._draw()

    def _draw(self) -> None:
        if not self._enabled:
            return
        frac = self.count / self.total
        fill = int(frac * self.width)
        bar = "#" * fill + "-" * (self.width - fill)
        dt = time.monotonic() - self._t0
        self._stream.write(
            f"\r{self.name} [{bar}] {self.count}/{self.total}"
            f" ({100 * frac:3.0f}%) {dt:5.1f}s")
        if self.count >= self.total:
            self._stream.write("\n")
        self._stream.flush()

    # context-manager sugar
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.count < self.total:
            self.count = self.total
            self._draw()
        return False
