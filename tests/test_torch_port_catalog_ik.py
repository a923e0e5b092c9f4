"""Config C (batched IK over the whole rigid error catalog,
momentum_tpu_torch/testing/workloads.py::build_catalog_ik_problem) against
the JAX package's build of the same problem in tools/jax_reference.py, on
the CPU at B = 16: the numpy recipe both read, the capsules' pair list, and
each element's per-module energies after solve_ik's LM 10 (energies and
statistics, not raw parameters: ROADMAP F5).

Tolerance: each element's total final energy to rtol 1e-3 (float32 LM
iterates of two implementations; measured 2.2e-5), each module's median
to 5% or 1e-8 of the median total (a converged term's float32 roundoff).
"""

import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from momentum_tpu_torch.testing import workloads

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402
from test_torch_port_helpers import one_torch_thread  # noqa: F401

BATCH = 16


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


def test_recipes_are_the_tools():
    """The port's numpy recipes and draws are tools/jax_reference.py's."""
    _equal(workloads.catalog_recipe(), jax_reference.catalog_recipe())
    _equal(workloads.keypoint_recipe(), jax_reference.keypoint_recipe())
    _equal(workloads.catalog_draws(8, 3, 157), jax_reference.catalog_draws(8, 3, 157))
    _equal(workloads.keypoint_draws(5, 0, 4, 41), jax_reference.keypoint_draws(5, 0, 4, 41))
    # the first elements are the same at every batch size
    _equal(workloads.catalog_draws(4, 0, 157), tuple(x[:4] for x in
                                                     workloads.catalog_draws(16, 0, 157)))


def _jax_catalog_energies():
    """JAX's per-module energies of config C's LM at B = BATCH, each
    element one vmapped solve (tools/jax_reference.py's recipe)."""
    from momentum_tpu.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu.solver.ik import solve_ik

    char = jax_reference.catalog_character()
    labels, make = jax_reference.catalog_modules(char)
    truth, x0 = jax_reference.catalog_draws(BATCH, 0, char.num_model_parameters)

    def one(x_truth, x):
        efs = make(char.skeleton_states(x_truth))
        fn = SkeletonSolverFunction(char, efs)
        res = solve_ik(fn, x, None, SolverOptions(max_iterations=workloads.CATALOG_ITERATIONS,
                                                  regularization=1e-5),
                       method="levenberg_marquardt")
        ctx = fn.context(res.params)
        return jnp.stack([ef.error(char, ctx) for ef in efs])

    per = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(truth), jnp.asarray(x0)), np.float64)
    ref = {}
    for i, label in enumerate(labels):
        ref[label] = ref.get(label, 0.0) + per[:, i]
    ref["total"] = per.sum(axis=1)
    return ref


@pytest.fixture(scope="module")
def solved():
    """The port's solve (on one torch thread, the module's) and JAX's (in a
    thread meanwhile: XLA runs outside the GIL)."""
    with ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(_jax_catalog_energies)
        problem = workloads.build_catalog_ik_problem(BATCH, device="cpu")
        res = workloads.solve_catalog(problem)
        port = {k: v.numpy().astype(np.float64)
                for k, v in workloads.catalog_energies(problem, res.params).items()}
        ref = jax_run.result()
    return problem, port, ref


def test_catalog_modules_and_pairs(solved):
    """Every module of the catalog is in the problem, with JAX's labels,
    and the capsules give JAX's pair list."""
    problem, port, ref = solved
    assert [label for label, _ in problem.modules] == [k for k in ref if k != "total"]
    from momentum_tpu.errors import compute_valid_pairs

    np.testing.assert_array_equal(problem.modules[-2][1].pair_a.numpy(),
                                  compute_valid_pairs(jax_reference.catalog_character())[:, 0])


def test_catalog_ik_matches_jax(solved):
    """Each element's total final energy and each module's median after
    LM 10 at B = 16 against JAX's."""
    _, port, ref = solved
    assert np.all(np.isfinite(port["total"]))
    np.testing.assert_allclose(port["total"], ref["total"], rtol=1e-3)
    floor = 1e-8 * float(np.median(ref["total"]))
    for label in ref:
        a, b = float(np.median(port[label])), float(np.median(ref[label]))
        assert abs(a - b) <= 0.05 * b + floor, (label, a, b)
