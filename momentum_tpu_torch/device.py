"""The device rule of the port's entry points: they build on the CUDA card
unless the caller asks for the CPU, and raise when the machine has no card,
instead of carrying on on the CPU. `to_host` copies what host code (numpy
drawing, file writers, loggers) takes off the device."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve", "to_host"]


def resolve(device, entry: str) -> torch.device:
    """`device` as a torch.device; `entry` names the caller in the error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} builds on the CUDA card by default and this machine "
                           "has none: pass device='cpu' to build it on the CPU")
    return device


def to_host(a) -> np.ndarray:
    """A numpy view of a tensor on the host (copied there from the card),
    or of any array-like."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
