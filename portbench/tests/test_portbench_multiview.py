"""The multi-view cell (mv31.b16384): its configuration, cameras and
traffic against their stated sources and rules; `correct` at small sizes,
true for the program and false with the timed path broken (faults.py);
the per-layer readers of K6's projection form on hand-made traces."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import run as harness
from portbench.faults import FAULTS, planted
from portbench.projection_work import CHAIN_FLOPS, projection_jacobian_work

CELL = "mv31.b16384"
SEED = 3_000_000_019
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_configuration_cameras_and_traffic():
    cell, config, traffic = harness.resolve_cell(BENCH, CELL)
    assert cell["chips"] == 1 and config["kind"] == "multiview" and config["reduced"] == []
    doc = json.loads((ROOT / config["cameras"]).read_text())
    cams = doc["cameras"]
    assert len(cams) == config["camera_count"] == 31
    assert doc["image_size"] == config["image_size"] == [1920, 1080] and doc["rate_hz"] == 29.97
    for c in cams:
        r = np.asarray(c["rotation"])
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(r) > 0 and c["k"][3:] == [0.0, 0.0, 0.0] and c["fx"] == 1400.0
        assert abs(c["cx"] - 960) <= 10 and abs(c["cy"] - 540) <= 10
        assert -0.25 <= c["k"][0] <= -0.15 and 0.05 <= c["k"][1] <= 0.15
        # on the 2.75 m sphere about (0, 0, 1.5), looking at (0, 0, 1)
        pos = np.asarray(c["position_m"])
        assert np.linalg.norm(pos - (0, 0, 1.5)) == pytest.approx(2.75)
        eye = r @ np.asarray([0.0, 0.0, 1.0]) + c["translation_m"]
        assert abs(eye[0]) < 1e-9 and abs(eye[1]) < 1e-9 and eye[2] > 0
        np.testing.assert_allclose(-r.T @ c["translation_m"], pos, atol=1e-9)
    elevations = [c["elevation_deg"] for c in cams]
    assert -15 < min(elevations) < max(elevations) < 55
    assert traffic["batch"] == 16384 and traffic["keyframe_stride"] == 2
    assert traffic["motion"]["period_frames"] == round(343 * 29.97 / 120)
    rows = 2 * config["camera_count"] * config["locators"]
    assert rows == config["rows_per_frame"] == 2542
    # J at the cell's batch: 12.16 GB
    nbytes, flops = projection_jacobian_work(16384, 31, 41, 23, 73)
    assert 4 * 16384 * rows * 73 == pytest.approx(12.16e9, rel=1e-3) and nbytes > 12.16e9
    assert flops == 16384 * (31 * 41 * CHAIN_FLOPS + 5 * rows * 73)


def _run(run, hook=None):
    result, _, numbers = run.run_cell(run.load_benchmark(), CELL, SEED, 0.3, False,
                                      torch.device("cpu"), time.perf_counter(), hook=hook)
    return result, numbers


def test_program_is_correct(small_cells):
    result, numbers = _run(small_cells)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    # peak_mem_gib reads nothing on the CPU
    assert set(result["metrics"]) == {"frames_per_s.ik", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(small_cells, fault):
    with planted(fault):
        result, numbers = _run(small_cells)
    assert not result["correct"], numbers


def test_a_program_with_answers_not_finite_fails_at_set_up(small_cells, monkeypatch):
    """A program whose answers are not finite fails at once, in the warm-up
    call, rather than run a window whose calls would all fail."""
    from momentum_tpu_torch.solver import gauss_newton

    solve = gauss_newton.solve_levenberg_marquardt

    def nan_lm(*args, **kwargs):
        res = solve(*args, **kwargs)
        return res._replace(params=torch.full_like(res.params, float("nan")))

    monkeypatch.setattr(gauss_newton, "solve_levenberg_marquardt", nan_lm)
    with pytest.raises(RuntimeError, match="not all finite"):
        _run(small_cells)


def test_counters_without_the_projection_counter():
    """A program that counts no projection launches reports none, and the
    cell's counters do not fail for it."""
    from portbench.drivers.multiview import MultiviewCell

    cell = MultiviewCell.__new__(MultiviewCell)
    cell._psd, cell._jac = SimpleNamespace(launches=4), SimpleNamespace()
    assert cell.counters() == {"k2k3_launches": 4}
    cell._jac = SimpleNamespace(projection_launches=7)
    assert cell.counters() == {"k2k3_launches": 4, "projection_launches": 7}


MS = 1e6  # ns
KERNEL = ("(anonymous namespace)::projection_jacobian_kernel(float const*, "
          "(anonymous namespace)::Inputs, float const*, float const*, int const*, float const*, "
          "float*, int, int, int, int, int, int)")
K6 = "void (anonymous namespace)::point_jacobian_kernel(float const*, Inputs, int const*)"


def _trace(cpu, device):
    from portbench.tracing import Trace, _union

    t = Trace.__new__(Trace)
    t.window_s = 1.0
    t.cpu_names = [c[0] for c in cpu]
    t.cpu_start = np.asarray([c[1] * MS for c in cpu], np.float64)
    t.cpu_end = np.asarray([c[2] * MS for c in cpu], np.float64)
    t.cpu_id = np.full(len(cpu), -1, np.int64)
    t.device_names = [d[0] for d in device]
    t.device_start = np.asarray([d[1] * MS for d in device], np.float64)
    t.device_end = np.asarray([d[2] * MS for d in device], np.float64)
    t.device_link = np.full(len(device), -1, np.int64)
    t.busy = _union(t.device_start, t.device_end)
    t.busy_s = float(np.sum(t.busy[:, 1] - t.busy[:, 0])) / 1e9
    return t


CALLS = [("compaction.solve", 0, 100), ("compaction.solve", 200, 300)]


def test_projection_jacobian_ms_reads_the_kernel_a_call():
    device = [(KERNEL, 10, 18), (K6, 20, 21), (KERNEL, 210, 214)]
    run = SimpleNamespace(config={"kind": "multiview"}, host_trace=_trace(CALLS, device))
    assert harness.metric_reader("projection_jacobian_ms").read(run) == pytest.approx(6.0)
    # K6 alone (the point Jacobian's name is not the projection form's)
    run.host_trace = _trace(CALLS, [(K6, 20, 21)])
    assert harness.metric_reader("projection_jacobian_ms").read(run) is None
    run.host_trace = _trace([("aten::mul", 0, 1)], device)  # no spans
    assert harness.metric_reader("projection_jacobian_ms").read(run) is None
    assert harness.metric_reader("point_jacobian_ms").read(
        SimpleNamespace(config={"kind": "ik"}, host_trace=_trace(CALLS, device))) == 0.5


def test_projection_jacobian_roofline_reads_the_stages_work(capsys):
    work = {"stages": [(16384, 5), (1024, 6)], "cameras": 31, "points": 41, "joints": 23,
            "n": 73}
    run = SimpleNamespace(work=work, counters={"projection_launches": 11},
                          trace=_trace([], [(KERNEL, 0, 40)]))
    least = sum(it * max(b_ / 3.35e12, f / 67e12) for it, (b_, f) in
                ((5, projection_jacobian_work(16384, 31, 41, 23, 73)),
                 (6, projection_jacobian_work(1024, 31, 41, 23, 73))))
    got = harness.metric_reader("projection_jacobian_roofline").read(run)
    assert got == pytest.approx(100 * least / 0.040)
    assert capsys.readouterr().err == ""
    run.counters = {"projection_launches": 12}
    harness.metric_reader("projection_jacobian_roofline").read(run)
    assert "11 LM iterations reckoned" in capsys.readouterr().err
    run.trace = _trace([], [(K6, 0, 1)])  # a program without the kernel
    assert harness.metric_reader("projection_jacobian_roofline").read(run) is None


def test_reference_and_driver_load_no_jax():
    """The cell's reference loads neither JAX nor the port; its driver loads
    the port but no JAX (whole top-level names, as test_portbench_guard.py)."""
    from test_portbench_guard import _top_level_names_after_import

    names = _top_level_names_after_import("portbench.reference.projection")
    assert not names & {"jax", "jaxlib", "flax", "momentum_tpu", "momentum_tpu_torch"}
    names = _top_level_names_after_import("portbench.drivers.multiview",
                                          "momentum_tpu_torch.errors.camera_projection",
                                          "momentum_tpu_torch.ops.jacobian")
    assert "momentum_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "momentum_tpu"}
