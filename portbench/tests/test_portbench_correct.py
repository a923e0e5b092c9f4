"""`correct` at small sizes: true for the program as it is and false with
the timed path broken underneath (faults.py); on the card, at the cells'
own sizes, false for the control: the reference in the program's place
with TF32 products."""

import time

import pytest
import torch

from portbench.faults import FAULTS, planted

CELLS = ("ik.b65536", "seq.f1024")
SEED = 3_000_000_007


def _run(run, cell, device="cpu", hook=None):
    result, _, numbers = run.run_cell(run.load_benchmark(), cell, SEED, 0.3, False,
                                      torch.device(device), time.perf_counter(), hook=hook)
    return result, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(small_cells, cell):
    result, numbers = _run(small_cells, cell)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(small_cells, cell, fault):
    with planted(fault):
        result, numbers = _run(small_cells, cell)
    assert not result["correct"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products exist only on a CUDA card")
    from portbench import run
    from portbench.calibrate import control_hook

    # at the cell's own size: the control's error grows with the batch (on
    # an H100 IK's p99 ratio read 1.06-1.11 at 2048 frames, 953 at 65536)
    result, numbers = _run(run, cell, "cuda", control_hook)
    assert not result["correct"], numbers
