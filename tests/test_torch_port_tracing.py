"""The port's spans (utils/profiling.py) on the CPU, at the benchmark
cells' shapes cut small: batched IK on the CMU 41-marker rig by LM 5 + 6
on the worst elements (solve_compacted), and a whole take solved by
solve_sequence through SPIKE.

Under torch.profiler every solve emits its spans, nested as the layers
call each other, with one loop-turn span an iteration and one `.sync` span
a host sync; with no profiler running nothing enters a record-function
region, and the answers are the same bit for bit either way."""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from momentum_tpu_torch.errors import PositionErrorFunction
from momentum_tpu_torch.sequence import (
    ModelParametersSequenceErrorFunction, SequenceSolverFunction, solve_sequence)
from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_compacted
from momentum_tpu_torch.solver.gauss_newton import (
    solve_gauss_newton, solve_gradient_descent, solve_levenberg_marquardt)
from momentum_tpu_torch.tracking.cmu import create_cmu_character
from momentum_tpu_torch.utils import profiling

BATCH, CAPACITY, FRAMES = 16, 2, 128  # SPIKE from 128 frames
LM = SolverOptions(regularization=1e-5, energy_from_residual=True, lambda_init=0.01,
                   lambda_up=10.0, lambda_down=0.1, lambda_min=1e-10, lambda_max=1e8)


@pytest.fixture(scope="module")
def rig():
    """The CMU rig in m, as the benchmark's cells run it (the module's mm ÷ 1000)."""
    mm = create_cmu_character(device="cpu")
    char = dataclasses.replace(
        mm, skeleton=dataclasses.replace(
            mm.skeleton, translation_offset=mm.skeleton.translation_offset / 1000),
        locators=dataclasses.replace(mm.locators, offset=mm.locators.offset / 1000))
    ef0 = PositionErrorFunction.create(
        char.locators.parent.numpy(), char.locators.offset.numpy(),
        torch.zeros(char.locators.num_locators, 3).numpy(), device="cpu")
    return char, ef0


def _walk(char, n, seed):
    """(markers (n, 41, 3) with 2 mm of noise, the poses they come from) of
    n frames at 120 Hz: the root walking 2 m a 343-frame period, every
    angle 0.2·sin(2πt + phase), the scale 0.1."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n)[:, None] / 120.0
    truth = 0.2 * torch.sin(2 * torch.pi * t + 6.0 * torch.rand(char.num_model_parameters,
                                                                  generator=g))
    walk = 2.0 * t * 120 / 343
    truth[:, :3] = torch.cat([walk, 0.0 * t, 0.9 + 0.02 * torch.sin(2 * torch.pi * t)], dim=-1)
    truth[:, 6] = 0.1
    markers = char.locators.world_positions(char.skeleton_states(truth))
    return markers + 0.002 * torch.randn(markers.shape, generator=g), truth


def _poses(char, n, seed):
    """(targets, starts) of n IK frames: each started 0.05 off its pose."""
    targets, truth = _walk(char, n, seed)
    g = torch.Generator().manual_seed(seed + 1)
    return targets, truth + 0.05 * torch.randn(truth.shape, generator=g)


@pytest.fixture(scope="module")
def ik(rig):
    char, ef0 = rig
    targets, x0 = _poses(char, BATCH, 7)

    def stage(targets, x0, iters, lam0):
        fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
        return solve_levenberg_marquardt(
            fn.residual, fn.error, x0, options=dataclasses.replace(LM, max_iterations=iters),
            jacobian_fn=fn.residual_and_jacobian, lambda0=lam0)

    return stage, targets, x0


@pytest.fixture(scope="module")
def take(rig):
    char, ef0 = rig
    targets, _ = _walk(char, FRAMES, 11)
    p = char.num_model_parameters
    universal = torch.zeros(p, dtype=torch.bool)
    universal[6] = True  # scale_global, shared by every frame
    fn = SequenceSolverFunction.create(
        char, FRAMES, universal=universal.numpy(),
        per_frame_errors=(dataclasses.replace(ef0, target=targets),),
        sequence_errors=(ModelParametersSequenceErrorFunction.create(p, weight=0.1,
                                                                     device="cpu"),))
    start = torch.zeros(FRAMES, p)
    start[:, :3] = targets.mean(dim=1)  # the tracker's seed: the root at the markers' centroid
    pf0, u0 = fn.split(start)
    return fn, pf0, u0, SolverOptions(max_iterations=2, regularization=0.05)


def _run_ik(ik, stages=None):
    stage, targets, x0 = ik

    def counted(*args):
        res = stage(*args)
        if stages is not None:
            stages.append((res.iterations, args[2]))
        return res

    return solve_compacted(counted, targets, x0, capacity=CAPACITY, k_full=5, r_refine=6)


def _traced(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the spans it emitted)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if "::" not in e.name() and "." in e.name()]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The name of the innermost span around spans[i], or None."""
    _, s, e = spans[i]
    around = [j for j, (_, s2, e2) in enumerate(spans)
              if j != i and s2 <= s and e <= e2 and (e2 - s2) > (e - s)]
    return spans[min(around, key=lambda j: spans[j][2] - spans[j][1])][0] if around else None


def _count(spans, name):
    return sum(n == name for n, _, _ in spans)


def _parents(spans, name):
    return {_parent(spans, i) for i, (n, _, _) in enumerate(spans) if n == name}


def _loop_heads(iterations, max_iterations):
    """The loop-head tests a solve made: one a turn, and one more that
    stopped it unless the cap did."""
    return iterations + (iterations < max_iterations)


def test_lm_spans_nest_and_count(ik):
    stage, targets, x0 = ik
    res, spans = _traced(lambda: stage(targets, x0, 4, None))
    assert _count(spans, "lm.solve") == 1
    assert _count(spans, "lm.iteration") == res.iterations > 0
    assert _count(spans, "lm.sync") == _loop_heads(res.iterations, 4)
    assert _count(spans, "lm.init.sync") == 1  # λ copied from the host
    assert _count(spans, "lm.jacobian") == _count(spans, "lm.step") == res.iterations
    assert _count(spans, "lm.energy") == res.iterations + 1  # the start's and each trial's
    for name in ("lm.iteration", "lm.sync", "lm.init.sync"):
        assert _parents(spans, name) == {"lm.solve"}
    for name in ("lm.jacobian", "lm.step"):
        assert _parents(spans, name) == {"lm.iteration"}
    assert _parents(spans, "lm.energy") == {"lm.solve", "lm.iteration"}


def test_compacted_spans_nest_and_count(ik):
    stages = []
    res, spans = _traced(lambda: _run_ik(ik, stages))
    assert [cap for _, cap in stages] == [5, 6]
    assert _count(spans, "compaction.solve") == 1
    for name in ("compaction.select", "compaction.refine", "compaction.scatter"):
        assert _count(spans, name) == 1 and _parents(spans, name) == {"compaction.solve"}
    assert _parents(spans, "lm.solve") == {"compaction.solve", "compaction.refine"}
    assert _count(spans, "lm.iteration") == res.iterations == sum(it for it, _ in stages)
    assert _count(spans, "lm.sync") == sum(_loop_heads(it, cap) for it, cap in stages)
    # the refinement resumes λ from the device: only the first stage copies it
    assert _count(spans, "lm.init.sync") == 1


def test_sequence_spans_nest_and_count(take):
    fn, pf0, u0, opts = take
    res, spans = _traced(lambda: solve_sequence(fn, pf0, u0, opts))
    assert _count(spans, "sequence.solve") == 1
    assert _count(spans, "sequence.iteration") == res.iterations == 2
    assert _count(spans, "sequence.sync") == _loop_heads(res.iterations, 2)
    assert _parents(spans, "sequence.iteration") == {"sequence.solve"}
    for name in ("sequence.normal_equations", "sequence.equilibrate", "sequence.system",
                 "sequence.error"):
        assert _count(spans, name) == res.iterations
        assert _parents(spans, name) == {"sequence.iteration"}
    assert _parents(spans, "sequence.schur") == {"sequence.system"}
    for name in ("sequence.spike_local", "sequence.spike_interface"):
        assert _count(spans, name) == res.iterations
        assert _parents(spans, name) == {"sequence.schur"}
    # the index tables copied from the host: inside the solve, none outside
    index = [i for i, (n, _, _) in enumerate(spans) if n == "sequence.index.sync"]
    assert index and all(spans[0][1] <= spans[i][1] for i in index)
    assert _count(spans, "sequence.init.sync") == 1


@pytest.mark.parametrize("solver,prefix", [(solve_gauss_newton, "gn"),
                                           (solve_gradient_descent, "gd")])
def test_other_solvers_mark_their_loops(rig, solver, prefix):
    char, ef0 = rig
    targets, x0 = _poses(char, 4, 3)
    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    opts = SolverOptions(max_iterations=3, energy_from_residual=True)
    res, spans = _traced(lambda: solver(fn.residual, fn.error, x0, options=opts,
                                        jacobian_fn=fn.residual_and_jacobian))
    assert _count(spans, f"{prefix}.solve") == 1
    assert _count(spans, f"{prefix}.iteration") == res.iterations
    assert _count(spans, f"{prefix}.sync") == _loop_heads(res.iterations, 3)
    assert _parents(spans, "lm.jacobian") == {f"{prefix}.iteration"}


def test_line_search_and_cg_syncs_are_spans(rig):
    char, ef0 = rig
    targets, x0 = _poses(char, 4, 5)
    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    opts = SolverOptions(max_iterations=2, do_line_search=True, line_search_steps=3,
                         energy_from_residual=True)
    _, spans = _traced(lambda: solve_gauss_newton(fn.residual, fn.error, x0, options=opts))
    assert _count(spans, "gn.line_search.sync") >= 1
    assert _parents(spans, "gn.line_search.sync") == {"gn.line_search"}
    opts = dataclasses.replace(opts, linear_solver="cg", cg_iterations=4, do_line_search=False)
    res, spans = _traced(lambda: solve_gauss_newton(fn.residual, fn.error, x0, options=opts))
    assert _parents(spans, "gn_cg.solve") == {"gn.solve"}
    assert _count(spans, "gn_cg.iteration") == res.iterations
    assert _count(spans, "cg.solve") == res.iterations
    assert _parents(spans, "cg.sync") == {"cg.solve"}


def test_no_profiler_enters_no_record_function(ik, take, monkeypatch):
    expected_ik = _run_ik(ik)
    fn, pf0, u0, opts = take
    expected_take = solve_sequence(fn, pf0, u0, opts)

    def refuse(*args, **kwargs):
        raise AssertionError("a record-function region was entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.profile_scope("a") is profiling.profile_scope("b")
    stage, targets, x0 = ik
    got = _run_ik(ik)
    assert torch.equal(got.params, expected_ik.params)
    assert torch.equal(stage(targets, x0, 3, None).params,
                       stage(targets, x0, 3, None).params)
    got = solve_sequence(fn, pf0, u0, opts)
    assert torch.equal(got.per_frame, expected_take.per_frame)
    assert torch.equal(got.universal, expected_take.universal)


def test_spans_leave_the_answers_bit_identical(ik, take):
    plain = _run_ik(ik)
    traced, _ = _traced(lambda: _run_ik(ik))
    assert torch.equal(plain.params, traced.params) and torch.equal(plain.error, traced.error)
    fn, pf0, u0, opts = take
    plain = solve_sequence(fn, pf0, u0, opts)
    traced, _ = _traced(lambda: solve_sequence(fn, pf0, u0, opts))
    assert torch.equal(plain.per_frame, traced.per_frame)
    assert torch.equal(plain.universal, traced.universal)


def test_start_stop_trace_writes_the_spans(ik, tmp_path):
    stage, targets, x0 = ik
    assert profiling.start_trace(str(tmp_path)) == str(tmp_path)
    stage(targets, x0, 2, None)
    path = profiling.stop_trace()
    names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"lm.solve", "lm.iteration", "lm.sync", "lm.jacobian"} <= names
