"""Parity of the port's multi-process entry points with momentum_tpu on the
CPU: solve_sequence_sharded (momentum_tpu_torch/sequence/sharded.py),
solve_ik_sharded and track_poses_sharded (momentum_tpu_torch/parallel/).

The port runs in gloo groups of 1, 2 and 4 spawned ranks
(testing/distributed.py::Ranks, one torch thread a rank, a join timeout),
each group spawned once for every case (tests/torch_port_sharded_ranks.py).
The inputs are made here from seeded numpy (the targets by the port's FK
on the CPU, which tests/test_torch_port_fk.py holds to JAX's) and handed
to the ranks and to JAX; JAX runs here on the conftest's virtual devices
meanwhile, its solves in a thread pool (XLA compiles outside the GIL).

The cases are tests/test_sharded_sequence.py's, at its tolerances: the
universal scale off and on (F = 8), window 3 at F = 11 (q = 2, padded),
window 4 with the universal scale at F = 13 (q = 3, padded; that file
holds its parameters to 2e-2 and its error to 5e-3: a step matches to
~1e-4 and six iterations amplify it), window 2 at F = 10 (padded) and the
convergence after 25 iterations. A group of S ranks is held against JAX's
shard_map on a mesh of S devices (the convergence case against the mesh
of 4, where that file runs it), a group of 1 against the port's
solve_sequence. solve_ik_sharded at B = 16 against JAX's at atol 1e-5,
track_poses_sharded at 16 frames against the port's track_poses_batched
at atol 2e-5 on the motion and 1e-6 on the errors (tests/
test_parallel_batch.py's), and against JAX's track_poses_sharded at 2e-5
on the motion and the port's tracking tolerance on the energies.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from momentum_tpu.errors import PositionErrorFunction as JPos
from momentum_tpu.parallel import solve_ik_sharded as jax_solve_ik_sharded
from momentum_tpu.parallel import track_poses_sharded as jax_track_poses_sharded
from momentum_tpu.sequence import (
    AccelerationSequenceErrorFunction, JerkSequenceErrorFunction,
    ModelParametersSequenceErrorFunction, SequenceSolverFunction, stack_frames)
from momentum_tpu.sequence.sharded import solve_sequence_sharded as jax_sharded
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu.tracking import MarkerSequence as JMarkers
from momentum_tpu.tracking.config import TrackingConfig as JTrackingConfig
from momentum_tpu_torch.sequence import solve_sequence
from momentum_tpu_torch.sequence.sharded import solve_sequence_sharded
from momentum_tpu_torch.solver import SolverOptions
from momentum_tpu_torch.testing.distributed import Ranks
from momentum_tpu_torch.testing.fixtures import create_test_character
from momentum_tpu_torch.tracking import track_poses_batched

import torch_port_sharded_ranks as ranks_side
from test_torch_port_helpers import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)
JOIN_TIMEOUT = 240.0
EIGHT = dict(max_iterations=8, min_iterations=8, regularization=1e-4)
SIX = dict(max_iterations=6, min_iterations=6, regularization=1e-4)
TIGHT = dict(params=dict(rtol=1e-3, atol=1e-4), error=dict(rtol=1e-3, atol=1e-6))
# name: (frames, universal scale, sequence modules, options, tolerances)
SEQUENCE_CASES = {
    "universal_off": (8, False, ("smooth",), EIGHT, TIGHT),
    "universal_on": (8, True, ("smooth",), EIGHT, TIGHT),
    "window3_f11": (11, False, ("accel",), SIX,
                    dict(params=dict(rtol=1e-3, atol=2e-4), error=TIGHT["error"])),
    "window4_universal_f13": (13, True, ("jerk",), SIX,
                              dict(params=dict(rtol=0, atol=2e-2),
                                   error=dict(rtol=5e-3, atol=1e-6))),
    "window2_f10": (10, False, ("smooth",), EIGHT, TIGHT),
    "converges": (8, False, ("smooth",), dict(max_iterations=25, regularization=1e-5), TIGHT),
}
IK_OPTIONS = dict(max_iterations=10, regularization=1e-6, energy_from_residual=True)
TRACK_CONFIG = dict(max_iter=10)
TRACK_REFINE = (4, 2, 4)  # LM 4 on every frame, 2 more on the clip's worst 4
MOTION_ATOL, ERRORS_ATOL, IK_ATOL = 2e-5, 1e-6, 1e-5
# the clip's energies reach 0.42 (its limits bind); against JAX's they are
# held as tests/test_torch_port_tracking.py holds the port's tracking
# energies (measured 1.1e-5 relative at most)
JAX_ENERGY_TOL = dict(rtol=1e-3, atol=1e-7)


def _targets(char, thetas):
    """The locators' world positions (F, C, 3) of the poses `thetas`."""
    return char.locators.world_positions(char.skeleton_states(torch.as_tensor(thetas))).numpy()


def _sequence_case(name):
    """tests/test_sharded_sequence.py's problem of case `name` as numpy:
    targets of a sine motion (the scale fixed at 0.2 where it is universal
    over F = 8, as its _problem does; its _problem_windowed leaves it)."""
    f, universal, sequence, options, _ = SEQUENCE_CASES[name]
    char = create_test_character(4, device="cpu")
    p, scale = char.num_model_parameters, char.parameter_transform.names.index("scale_global")
    rng = np.random.default_rng(12345)
    t = np.linspace(0, 1, f)[:, None]
    thetas = (0.25 * np.sin(2 * np.pi * t + rng.uniform(0, 6, p))).astype(np.float32)
    mask = None
    if universal:
        mask = np.zeros(p, bool)
        mask[scale] = True
        if sequence == ("smooth",):
            thetas[:, scale] = 0.2
    return dict(joints=4, frames=f, universal=mask, sequence=sequence, options=options,
                targets=_targets(char, thetas))


def _jax_sequence_function(jchar, case):
    p, nj, loc = jchar.num_model_parameters, jchar.skeleton.num_joints, jchar.locators
    efs = [JPos.create(np.asarray(loc.parent), np.asarray(loc.offset), t)
           for t in case["targets"]]
    made = {"smooth": lambda: ModelParametersSequenceErrorFunction.create(p, weight=1e-3),
            "accel": lambda: AccelerationSequenceErrorFunction.create(nj, weight=5e-3),
            "jerk": lambda: JerkSequenceErrorFunction.create(nj, weight=1e-3)}
    return SequenceSolverFunction.create(
        jchar, case["frames"], universal=case["universal"],
        per_frame_errors=(stack_frames(efs),),
        sequence_errors=tuple(made[s]() for s in case["sequence"]))


def _ik_case():
    """tests/test_parallel_batch.py's problem: B = 16 on the 6-joint rig."""
    char = create_test_character(6, device="cpu")
    rng = np.random.default_rng(0)
    gt = rng.uniform(-0.3, 0.3, (16, char.num_model_parameters)).astype(np.float32)
    x0 = (gt + 0.05 * rng.normal(0, 1, gt.shape)).astype(np.float32)
    return dict(joints=6, targets=_targets(char, gt), x0=x0, options=IK_OPTIONS)


def _tracking_case():
    """tests/test_parallel_batch.py's clip: 16 frames on the 4-joint rig."""
    char = create_test_character(4, device="cpu")
    rng = np.random.default_rng(12345)
    gt = rng.uniform(-0.2, 0.2, (16, char.num_model_parameters)).astype(np.float32)
    return dict(joints=4, positions=_targets(char, gt), config=TRACK_CONFIG,
                refine=TRACK_REFINE)


def _jax_results(inputs):
    """JAX's side, in a thread pool: each sequence case on meshes of 2 and
    4 devices under jit (one program, not op-by-op dispatch),
    solve_ik_sharded and track_poses_sharded on all 8."""
    jchar4 = jax_test_character(4)

    def sequence(name, n):
        jfn = _jax_sequence_function(jchar4, inputs["sequence"][name])
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
        opts = JOpts(**SEQUENCE_CASES[name][3])
        res = jax.jit(lambda a, b: jax_sharded(jfn, a, b, mesh, "seq", opts))(
            jnp.zeros((jfn.num_frames, jfn.num_per_frame)), jnp.zeros((jfn.num_universal,)))
        return jax.tree_util.tree_map(np.asarray, res)

    def solve_ik():
        case, jchar = inputs["ik"], jax_test_character(6)
        loc = jchar.locators
        ef = dataclasses.replace(JPos.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                             np.zeros((loc.num_locators, 3))),
                                 target=jnp.asarray(case["targets"]))
        res = jax_solve_ik_sharded(JFn(jchar, (ef,)), jnp.asarray(case["x0"]),
                                   options=JOpts(**IK_OPTIONS))
        return np.asarray(res.params)

    def track():  # eager, as tests/test_parallel_batch.py runs it (its jit form
        # lands up to 4e-5 away)
        pos = jnp.asarray(inputs["tracking"]["positions"])
        markers = JMarkers(positions=pos, occluded=jnp.zeros(pos.shape[:2], bool),
                           names=jchar4.locators.names)
        res = jax_track_poses_sharded(jchar4, markers, config=JTrackingConfig(**TRACK_CONFIG))
        return np.asarray(res.motion), np.asarray(res.errors)

    # the convergence case on 4 devices alone, as tests/test_sharded_sequence.py
    # runs it
    jobs = {(name, n): (sequence, name, n) for name in SEQUENCE_CASES for n in (2, 4)
            if (name, n) != ("converges", 2)}
    jobs["ik"], jobs["track"] = (solve_ik,), (track,)
    with ThreadPoolExecutor(6) as pool:
        futures = {k: pool.submit(*job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def runs():
    """(every rank's results for each world size, JAX's results, the
    inputs): the three groups run while JAX solves."""
    inputs = dict(sequence={name: _sequence_case(name) for name in SEQUENCE_CASES},
                  ik=_ik_case(), tracking=_tracking_case())
    groups = [Ranks(world, ranks_side.run_cases, (inputs,), timeout=JOIN_TIMEOUT)
              for world in WORLDS]
    try:
        jax_res = _jax_results(inputs)
        port = {world: g.results() for world, g in zip(WORLDS, groups)}
    finally:
        for g in groups:
            g.__exit__()
    return port, jax_res, inputs


def _close_solve(got, want, tol, universal):
    np.testing.assert_allclose(got["per_frame"].numpy(), np.asarray(want[0]), **tol["params"])
    if universal:
        np.testing.assert_allclose(got["universal"].numpy(), np.asarray(want[1]),
                                   **tol["params"])
    np.testing.assert_allclose(got["error"], float(want[2]), **tol["error"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(SEQUENCE_CASES))
def test_sequence_sharded_matches_jax(runs, name, world):
    port, jax_res, _ = runs
    got = port[world][0]["sequence"][name]
    want = jax_res[(name, 4 if name == "converges" else world)]
    _close_solve(got, want, SEQUENCE_CASES[name][4], SEQUENCE_CASES[name][1])
    if name == "converges":
        # where the energy stalls at float32 roundoff (the test's
        # threshold is one FLT_EPS of relative change) differs between
        # the packages
        assert got["converged"] and got["error"] < 1e-3
    else:
        assert got["iterations"] == int(want.iterations)


@pytest.mark.parametrize("name", list(SEQUENCE_CASES))
def test_sequence_world1_matches_solve_sequence(runs, name):
    """A group of one rank: the wrap-around shifts onto itself, and the
    result is solve_sequence's."""
    port, _, inputs = runs
    case = inputs["sequence"][name]
    fn = ranks_side.sequence_function(case)
    ref = solve_sequence(fn, torch.zeros(case["frames"], fn.num_per_frame),
                         torch.zeros(fn.num_universal), SolverOptions(**case["options"]))
    got = port[1][0]["sequence"][name]
    _close_solve(got, (ref.per_frame, ref.universal, ref.error), SEQUENCE_CASES[name][4],
                 SEQUENCE_CASES[name][1])
    if name == "converges":  # see test_sequence_sharded_matches_jax
        assert got["converged"] and bool(ref.converged)
    else:
        assert got["iterations"] == ref.iterations


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(runs, world):
    """The results are gathered: each rank holds the whole, bit for bit."""
    results = runs[0][world]
    assert len(results) == world

    def flat(res):  # the subgroup's solve is only its two ranks'
        out = []
        for part in ("sequence", "ik", "tracking"):
            for k, v in (res[part].items() if part != "sequence" else
                         [kv for r in res[part].values() for kv in r.items()]):
                if k != "subgroup":
                    out.append(v.numpy() if isinstance(v, torch.Tensor) else v)
        return out

    first = flat(results[0])
    for other in results[1:]:
        for a, b in zip(first, flat(other)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_solve_ik_sharded_matches_jax(runs, world):
    port, jax_res, inputs = runs
    got = port[world][0]["ik"]
    assert got["params"].shape == inputs["ik"]["x0"].shape
    np.testing.assert_allclose(got["params"].numpy(), jax_res["ik"], rtol=0, atol=IK_ATOL)


def test_solve_ik_sharded_on_a_subgroup(runs):
    """default_mesh(2) in a group of 4: its two ranks solve the batch, 8
    problems each, to what the whole group solves."""
    got = runs[0][4]
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank]["ik"]["subgroup"].numpy(),
                                   got[0]["ik"]["params"].numpy(), rtol=0, atol=IK_ATOL)
    assert got[2]["ik"]["subgroup"] is None and got[3]["ik"]["subgroup"] is None


@pytest.mark.parametrize("world", WORLDS)
def test_shard_batch_splits_the_batch_and_keeps_the_rest(runs, world):
    for rank, res in enumerate(runs[0][world]):
        part = res["shard_batch"]
        rows = slice(rank * 16 // world, (rank + 1) * 16 // world)
        np.testing.assert_array_equal(part["x"].numpy(),
                                      np.arange(16 * 3).reshape(16, 3)[rows])
        np.testing.assert_array_equal(part["y"].numpy(), np.arange(world + 1))
        assert part["names"] == ("a", "b")


@pytest.mark.parametrize("world", [2, 4])
def test_solve_ik_sharded_batch_not_divisible_raises(runs, world):
    raised = runs[0][world][0]["ik"]["raised"]
    assert raised == f"batch {world + 1} not divisible by mesh size {world}"


@pytest.mark.parametrize("world", WORLDS)
def test_track_poses_sharded_matches_batched_and_jax(runs, world):
    port, jax_res, inputs = runs
    got = port[world][0]["tracking"]
    from momentum_tpu_torch.tracking import MarkerSequence, TrackingConfig

    char = create_test_character(4, device="cpu")
    pos = torch.as_tensor(inputs["tracking"]["positions"])
    base = track_poses_batched(char, MarkerSequence(
        positions=pos, occluded=torch.zeros(pos.shape[:2], dtype=torch.bool),
        names=tuple(char.locators.names)), TrackingConfig(**TRACK_CONFIG))
    jax_motion, jax_errors = jax_res["track"]
    for motion in (base.motion.numpy(), jax_motion):
        np.testing.assert_allclose(got["motion"].numpy(), motion, rtol=0, atol=MOTION_ATOL)
    np.testing.assert_allclose(got["errors"].numpy(), base.errors.numpy(), rtol=0,
                               atol=ERRORS_ATOL)
    np.testing.assert_allclose(got["errors"].numpy(), jax_errors, **JAX_ENERGY_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_track_poses_sharded_refines_the_clips_worst_frames(runs, world):
    """With config.refine the frames refined are the whole clip's worst, as
    in track_poses_batched, wherever they lie among the ranks."""
    port, _, inputs = runs
    got = port[world][0]["tracking"]
    from momentum_tpu_torch.tracking import MarkerSequence, TrackingConfig

    char = create_test_character(4, device="cpu")
    pos = torch.as_tensor(inputs["tracking"]["positions"])
    base = track_poses_batched(char, MarkerSequence(
        positions=pos, occluded=torch.zeros(pos.shape[:2], dtype=torch.bool),
        names=tuple(char.locators.names)), TrackingConfig(**TRACK_CONFIG, refine=TRACK_REFINE))
    np.testing.assert_allclose(got["refined_motion"].numpy(), base.motion.numpy(), rtol=0,
                               atol=MOTION_ATOL)
    np.testing.assert_allclose(got["refined_errors"].numpy(), base.errors.numpy(), rtol=0,
                               atol=ERRORS_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_track_poses_sharded_frames_not_divisible_raises(runs, world):
    raised = runs[0][world][0]["tracking"]["raised"]
    assert raised == (f"frame count {world + 1} not divisible by mesh size {world}; "
                      "pad the clip")


def test_sharded_entry_points_need_a_group():
    """Without torch.distributed initialized the entry points raise rather
    than solve on one process."""
    fn = ranks_side.sequence_function(_sequence_case("universal_off"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        solve_sequence_sharded(fn, torch.zeros(8, fn.num_per_frame), torch.zeros(0))
