"""Leveled logging, the MT_LOG* equivalent (common/log.h:10-50): the
port's own copy of momentum_tpu/utils/logging.py, under the logger
"momentum_tpu_torch".

Thin wrapper over the stdlib logging module with the reference's level
vocabulary (Trace/Debug/Info/Warning/Error; setLogLevel at runtime).
"""

from __future__ import annotations

import logging

__all__ = ["get_logger", "set_log_level"]

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

logging.addLevelName(_LEVELS["trace"], "TRACE")
_root = logging.getLogger("momentum_tpu_torch")
if not _root.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    _root.addHandler(h)
    _root.setLevel(logging.INFO)


def get_logger(name: str = "momentum_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def set_log_level(level: str) -> None:
    """Runtime level control (log.h setLogLevel)."""
    _root.setLevel(_LEVELS[level.lower()])
