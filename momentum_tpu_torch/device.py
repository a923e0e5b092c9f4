"""The device rule of the port's entry points: they build on the CUDA card
unless the caller asks for the CPU, and raise when the machine has no card,
instead of carrying on on the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device, entry: str) -> torch.device:
    """`device` as a torch.device; `entry` names the caller in the error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} builds on the CUDA card by default and this machine "
                           "has none: pass device='cpu' to build it on the CPU")
    return device
