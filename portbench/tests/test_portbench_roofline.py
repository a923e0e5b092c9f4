"""The roofline and mfu arithmetic against hand-worked values."""

from types import SimpleNamespace

import pytest

from portbench import roofline
from portbench.run import metric_reader


def test_solve_work_and_bound_by_hand():
    # one (2048, 73) batch, one right-hand side: bytes 4·2048·(73² + 3·73)
    nbytes, flops = roofline.solve_work(2048, 73)
    assert nbytes == 4 * 2048 * (5329 + 219) == 45_449_216
    assert flops == pytest.approx(2048 * (389_017 / 3 + 2 * 5329))
    # bytes bound: 45.45 MB at 3.35 TB/s = 13.57 µs, over the flops' 4.29 µs
    assert roofline.bound_s(nbytes, flops) == pytest.approx(45_449_216 / 3.35e12)
    assert roofline.bound_s(0.0, 67e12) == pytest.approx(1.0)


def test_lm_iteration_flops_by_hand():
    # r = 123, n = 73: 2rn² = 1 310 934, 2rn = 17 958, n³/3 = 129 672.33, 2n² = 10 658
    per = 1_310_934 + 17_958 + 389_017 / 3 + 10_658
    assert roofline.lm_iteration_flops(1, 123, 73) == pytest.approx(per)
    assert roofline.lm_iteration_flops(2048, 123, 73) == pytest.approx(2048 * per)


class _Trace:
    def __init__(self, kernel_s, window_s):
        self.kernel_s, self.window_s = kernel_s, window_s

    def device_s(self, names):
        return self.kernel_s


def _metric(name):
    return metric_reader(name)


def test_k2k3_roofline_reads_the_stages_work():
    stages = [(2048, 5), (128, 6)] * 3
    run = SimpleNamespace(work={"stages": stages, "n": 73}, counters={"k2k3_launches": 33},
                          trace=_Trace(1e-3, 1.0))
    systems = 3 * (2048 * 5 + 128 * 6)
    expect = 100 * 4 * systems * (73 ** 2 + 3 * 73) / 3.35e12 / 1e-3
    assert _metric("k2k3_roofline").read(run) == pytest.approx(expect)
    run.trace = _Trace(None, 1.0)
    assert _metric("k2k3_roofline").read(run) is None


def test_solve_mfu_reads_the_unprofiled_window():
    work = {"stages": [(2048, 5), (128, 6)], "rows": 123, "n": 73}
    run = SimpleNamespace(plain=SimpleNamespace(work=work, window_s=0.1), trace=_Trace(None, 9.0))
    flops = (2048 * 5 + 128 * 6) * roofline.lm_iteration_flops(1, 123, 73)
    assert _metric("solve_mfu").read(run) == pytest.approx(100 * flops / (0.1 * 67e12))
    assert _metric("solve_mfu").read(SimpleNamespace(plain=None)) is None


def test_refine_stage_ms_reads_the_unprofiled_spans():
    run = SimpleNamespace(plain=SimpleNamespace(work={"refine_s": [0.010, 0.014]}))
    assert _metric("refine_stage_ms").read(run) == pytest.approx(12.0)
    run.plain.work["refine_s"] = []
    assert _metric("refine_stage_ms").read(run) is None


def test_end_to_end_readers():
    run = SimpleNamespace(frames=4096, window_s=0.2, walls=[0.1] * 19 + [0.3],
                          peak_bytes=2 ** 31, setup_s=12.5)
    assert _metric("frames_per_s.ik").read(run) == pytest.approx(20480.0)
    assert _metric("frames_per_s.take").read(run) == pytest.approx(20480.0)
    assert _metric("peak_mem_gib").read(run) == pytest.approx(2.0)
    assert _metric("setup_s").read(run) == 12.5
