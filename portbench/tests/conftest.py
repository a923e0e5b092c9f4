"""Fixtures of the benchmark's own tests: `python3 -m pytest portbench/tests`.
The CPU tests run the cells at small sizes with the port's plain paths;
tests marked `cuda` skip without a card (decided inside each test)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the cells' sizes on the CPU: a batch of 32 frames (2 refined), a take of 12
SMALL = {"batch": 32, "frames": 12}


@pytest.fixture
def small_cells(monkeypatch):
    """portbench.run with every cell's traffic cut to SMALL's sizes."""
    from portbench import run

    full = run.resolve_cell

    def resolve(bench, name, root=run.ROOT):
        cell, config, traffic = full(bench, name, root)
        return cell, config, {**traffic, **{k: v for k, v in SMALL.items() if k in traffic}}

    monkeypatch.setattr(run, "resolve_cell", resolve)
    return run
