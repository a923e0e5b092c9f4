"""Parity of the port's bench.py IK workload with momentum_tpu on the CPU: the
full-body fixture, one LM iteration, and the whole compacted LM 5 + 6 solve
at B = 64, seed 0.

Tolerances: the fixture and the warm start are numpy-built, so they are
bit-equal. One LM step moves by δ with κ(JᵀJ + D) up to ~1e8, so δ agrees
to 1e-3 relative norm and the energies after it to 1e-3 relative (measured
5e-5). The energies then drift apart as they fall (measured max relative
difference 5e-4 after 2 iterations, 9e-3 after 3): the parameters differ
along near-null directions (ROADMAP F5; up to ~6e-3 after 11 iterations),
and an element close to convergence can flip an accept/reject decision in
one package and not the other (one element of the 64 ends at 5e-12 in the
port and 6e-6 in JAX). So the whole solve is compared by its statistics
(conv@1e-5 within 2/B, median Σr² within 20%) and by per-element energies
within a factor of 1.5 for at least 90% of elements (measured 62 of 64)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.testing import workloads as jwork
from momentum_tpu_torch.bridge import character_from_numpy
from momentum_tpu_torch.solver import (
    SkeletonSolverFunction, SolverOptions, gather_batch, scatter_batch, solve_compacted)
from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt
from momentum_tpu_torch.testing import workloads as twork
from momentum_tpu_torch.testing.fixtures import create_fullbody_character

from test_torch_port_helpers import character_to_numpy, jax_fullbody_character

B = 64


@pytest.fixture(scope="module")
def problems():
    jax_problem = jwork.build_fullbody_ik_problem(B, seed=0)
    port_problem = twork.build_fullbody_ik_problem(B, seed=0, device="cpu")
    return jax_problem, port_problem


def test_fixture_is_bit_equal_to_jax():
    d_j = character_to_numpy(jax_fullbody_character())
    d_t = character_to_numpy(create_fullbody_character(device="cpu"))
    assert d_j.keys() == d_t.keys()
    for k in d_j:
        assert d_t[k].dtype == d_j[k].dtype, k
        np.testing.assert_array_equal(d_t[k], d_j[k], err_msg=k)
    # and the bridge carries them over unchanged
    d_b = character_to_numpy(character_from_numpy(d_j, device="cpu"))
    for k in d_j:
        np.testing.assert_array_equal(d_b[k], d_j[k], err_msg=k)


def test_problem_matches_jax(problems):
    (_, ef_j, targets_j, x0_j), (char_t, ef_t, targets_t, x0_t) = problems
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0_j))
    # targets come from each package's FK of the same ground truth
    np.testing.assert_allclose(targets_t.numpy(), np.asarray(targets_j), atol=1e-5)
    np.testing.assert_array_equal(ef_t.parent.numpy(), np.asarray(ef_j.parent))
    np.testing.assert_array_equal(ef_t.offset.numpy(), np.asarray(ef_j.offset))
    assert char_t.num_model_parameters == 157 and char_t.num_joints == 51


def test_one_lm_iteration_matches_jax(problems):
    (char_j, ef_j, targets_j, x0_j), (char_t, ef_t, targets_t, x0_t) = problems
    res_j = jax.jit(lambda t, x: jwork.make_solve_stage(char_j, ef_j)(t, x, 1, None))(
        targets_j, x0_j)
    res_t = twork.make_solve_stage(char_t, ef_t)(targets_t, x0_t, 1, None)
    assert res_t.iterations == 1
    delta_j = np.asarray(res_j.params) - np.asarray(x0_j)
    delta_t = res_t.params.numpy() - x0_t.numpy()
    accepted = np.linalg.norm(delta_j, axis=-1) > 0
    assert accepted.mean() > 0.9
    np.testing.assert_array_equal(np.linalg.norm(delta_t, axis=-1) > 0, accepted)
    rel = (np.linalg.norm(delta_t - delta_j, axis=-1)
           / np.maximum(np.linalg.norm(delta_j, axis=-1), 1e-30))
    assert np.max(rel[accepted]) <= 1e-3
    np.testing.assert_allclose(res_t.lambda_final.numpy(), np.asarray(res_j.lambda_final))
    np.testing.assert_allclose(res_t.error.numpy(), np.asarray(res_j.error), rtol=1e-3)


def test_compacted_solve_matches_jax(problems):
    (char_j, ef_j, targets_j, x0_j), (char_t, ef_t, targets_t, x0_t) = problems
    res_j = jax.jit(jwork.make_solve_batch(char_j, ef_j, B))(targets_j, x0_j)
    res_t = twork.make_solve_batch(char_t, ef_t, B)(targets_t, x0_t)
    e_j = np.asarray(res_j.error)
    e_t = res_t.error.numpy()
    assert res_t.iterations == int(res_j.iterations) == 11
    assert np.all(np.isfinite(e_t))
    assert abs(np.mean(e_t < 1e-5) - np.mean(e_j < 1e-5)) <= 2 / B
    assert abs(np.median(e_t) / np.median(e_j) - 1) <= 0.2
    hi, lo = np.maximum(e_t, e_j), np.minimum(e_t, e_j)
    assert np.mean(hi <= 1.5 * lo) >= 0.9


@pytest.fixture(scope="module")
def port_stage():
    char, ef0, targets, x0 = twork.build_fullbody_ik_problem(32, seed=3, device="cpu")
    return twork.make_solve_stage(char, ef0), targets, x0


def test_full_capacity_compaction_matches_uncompacted(port_stage):
    """As tests/test_compaction.py checks for JAX: with capacity = B the
    two-stage solve reproduces the single 11-iteration solve exactly."""
    stage, targets, x0 = port_stage
    full = stage(targets, x0, 11, None)
    comp = solve_compacted(stage, targets, x0, capacity=32, k_full=5, r_refine=6)
    np.testing.assert_array_equal(comp.params.numpy(), full.params.numpy())
    np.testing.assert_array_equal(comp.error.numpy(), full.error.numpy())
    np.testing.assert_array_equal(comp.converged.numpy(), full.converged.numpy())


def test_partial_capacity_refines_the_worst(port_stage):
    stage, targets, x0 = port_stage
    stage1 = stage(targets, x0, 2, None)
    comp = solve_compacted(stage, targets, x0, capacity=8, k_full=2, r_refine=3)
    full = stage(targets, x0, 5, None)
    worst = np.argsort(-stage1.error.numpy())[:8]
    np.testing.assert_array_equal(comp.params.numpy()[worst], full.params.numpy()[worst])
    rest = np.setdiff1d(np.arange(32), worst)
    np.testing.assert_array_equal(comp.params.numpy()[rest], stage1.params.numpy()[rest])
    assert np.all(comp.error.numpy() <= stage1.error.numpy())
    assert comp.iterations == 5


def test_zero_capacity_is_stage1(port_stage):
    stage, targets, x0 = port_stage
    comp = solve_compacted(stage, targets, x0, capacity=0, k_full=2, r_refine=3)
    np.testing.assert_array_equal(comp.params.numpy(), stage(targets, x0, 2, None).params.numpy())


def test_gather_scatter_batch():
    idx = torch.tensor([3, 0])
    tree = {"a": torch.arange(5.0), "shared": torch.ones(3),
            "pair": (torch.arange(10).reshape(5, 2),)}
    sub = gather_batch(tree, idx, 5)
    np.testing.assert_array_equal(sub["a"].numpy(), [3.0, 0.0])
    assert sub["shared"] is tree["shared"]
    np.testing.assert_array_equal(sub["pair"][0].numpy(), [[6, 7], [0, 1]])
    back = scatter_batch(tree, {"a": torch.tensor([30.0, 10.0]), "shared": torch.zeros(3),
                                "pair": (sub["pair"][0] * 0,)}, idx, 2)
    np.testing.assert_array_equal(back["a"].numpy(), [10.0, 1.0, 2.0, 30.0, 4.0])
    assert back["shared"] is tree["shared"]
    assert back["pair"][0][0].sum() == 0 and back["pair"][0][1].sum() == 5


def test_energy_from_error_fn_matches_residual_energy(port_stage):
    """With an L2 loss the exact energy (error_fn) and Σ rows² coincide, so
    both acceptance energies give the same iterates."""
    _, targets, x0 = port_stage
    char, ef0, _, _ = twork.build_fullbody_ik_problem(4, seed=3, device="cpu")
    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets[:4]),))
    runs = [solve_levenberg_marquardt(
        fn.residual, fn.error, x0[:4], jacobian_fn=fn.residual_and_jacobian,
        options=SolverOptions(max_iterations=3, regularization=1e-5,
                              energy_from_residual=flag)) for flag in (True, False)]
    np.testing.assert_allclose(runs[0].params.numpy(), runs[1].params.numpy(), atol=1e-6)
    np.testing.assert_allclose(runs[0].error.numpy(), runs[1].error.numpy(), rtol=1e-5)


def test_solver_without_jacobian_is_refused():
    with pytest.raises(NotImplementedError):
        solve_levenberg_marquardt(lambda x: x, lambda x: x.sum(-1), torch.zeros(2, 3))
