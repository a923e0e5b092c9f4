"""A seeded random-number singleton (reference: math/random.h:33-50 Random<>,
a global generator with a settable seed for test determinism), after
momentum_tpu/utils/random.py: its numpy stream is the same, and `key`
gives a seeded torch.Generator where JAX's gives a PRNG key.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["GlobalRandom", "get_global_random", "set_global_seed"]

_DEFAULT_SEED = 12345  # the reference test fixture seed


class GlobalRandom:
    def __init__(self, seed: int = _DEFAULT_SEED):
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def seed(self) -> int:
        return self._seed

    def set_seed(self, seed: int) -> None:
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def uniform(self, lo=0.0, hi=1.0, size=None):
        return self._rng.uniform(lo, hi, size)

    def normal(self, mean=0.0, sigma=1.0, size=None):
        return self._rng.normal(mean, sigma, size)

    def integers(self, lo, hi, size=None):
        return self._rng.integers(lo, hi, size)

    def key(self, device="cuda") -> torch.Generator:
        """A torch.Generator seeded with the current seed, on `device` (the
        card unless the caller asks for the CPU)."""
        gen = torch.Generator(device=resolve(device, "GlobalRandom.key"))
        gen.manual_seed(self._seed)
        return gen


_SINGLETON = GlobalRandom()


def get_global_random() -> GlobalRandom:
    return _SINGLETON


def set_global_seed(seed: int) -> None:
    _SINGLETON.set_seed(seed)
