"""The pose prior's analytic Jacobian (ROADMAP F26) against momentum_tpu on
the CPU: PosePriorErrorFunction.jacobian's rows and model-space Jacobian,
the solver function's `fully_analytic` on the full stack's modules, and
the two routes that follow from it: solve_ik's analytic Jacobian for a QR
solve of the full stack, and the sequence solver's analytic per-frame
Jacobian on the full-body rig (P = 157 ≥ 64).

Tolerances: rows and J_model at rtol 1e-5 (the prior's rows are a product
of L* with d*, its Jacobian L* placed by the selection, both float32 the
same way in both packages; the rows are 1e-5 of the largest absolutely,
as test_torch_port_fullstack.py's rows); the per-frame Jacobians of the
sequence at test_torch_port_sequence.py's JAC_TOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu.errors.base import EvalContext as JCtx
from momentum_tpu.errors.pose_prior import Mppca as JMppca
from momentum_tpu.errors.pose_prior import PosePriorErrorFunction as JPrior
from momentum_tpu.sequence import solver as jsol, solver_function as jsf
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu_torch.errors import Mppca, PosePriorErrorFunction
from momentum_tpu_torch.errors.base import EvalContext as TCtx
from momentum_tpu_torch.sequence import solver as tsol, solver_function as tsf
from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
from momentum_tpu_torch.solver import ik as port_ik
from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

from test_torch_port_helpers import (
    jax_fullbody_character, jax_fullstack_modules, port_fullbody_character,
    port_fullstack_modules)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

JAC_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stack():
    jchar = jax_fullbody_character()
    jmods = jax_fullstack_modules(jchar)
    return jchar, port_fullbody_character(), jmods, port_fullstack_modules(jmods)


def _poses(p, batch, seed):
    return np.random.default_rng(seed).normal(0, 0.4, (batch, p)).astype(np.float32)


def test_fully_analytic_matches_jax_on_the_full_stack(stack):
    jchar, tchar, jmods, tmods = stack
    assert PosePriorErrorFunction.has_analytic_jacobian is True
    want = JFn(jchar, tuple(jmods)).fully_analytic
    assert want
    assert SkeletonSolverFunction(tchar, tuple(tmods)).fully_analytic == want


def _named_prior():
    """A prior over names that miss a parameter ("zz") and come in another
    order than the parameters."""
    rng = np.random.default_rng(7)
    args = dict(pi=np.asarray([0.7, 0.3]), mu=rng.normal(0, 0.3, (2, 3)),
                w_list=[rng.normal(0, 0.5, (3, 2)) for _ in range(2)],
                sigma2=np.asarray([0.4, 0.9]), names=("c", "zz", "a"))
    names = ("a", "b", "c", "d")
    return (JPrior.create(JMppca.from_components(**args), names, weight=2.0),
            PosePriorErrorFunction.create(Mppca.from_components(**args, device="cpu"), names,
                                          weight=2.0))


@pytest.mark.parametrize("case", ["full_stack", "named"])
def test_jacobian_matches_jax(stack, case):
    """rows and J_model at B = 4; the unmapped prior dimension owns no
    column."""
    jchar, tchar, jmods, tmods = stack
    if case == "full_stack":
        jpp, tpp = jmods[3], tmods[3]
        x = _poses(jchar.num_model_parameters, 4, 3)
    else:
        jpp, tpp = _named_prior()
        x = _poses(4, 4, 4)
    if case == "full_stack":
        jctx = JFn(jchar, (jpp,)).context(jnp.asarray(x))
        tctx = SkeletonSolverFunction(tchar, (tpp,)).context(torch.as_tensor(x))
    else:  # a bare parameter vector: the prior reads model_params alone
        jctx = JCtx(model_params=jnp.asarray(x), joint_params=None, skel_states=None)
        tctx = TCtx(model_params=torch.as_tensor(x), joint_params=None, skel_states=None)
    rows_j, jp_j, jm_j = jpp.jacobian(jchar, jctx, None)
    rows_t, jp_t, jm_t = tpp.jacobian(tchar, tctx, None)
    assert jp_j is None and jp_t is None
    assert jm_t.shape == jm_j.shape == (4, tpp.num_rows(), x.shape[1])
    rows_j, jm_j = np.asarray(rows_j), np.asarray(jm_j)
    np.testing.assert_allclose(rows_t.numpy(), rows_j, rtol=1e-5,
                               atol=1e-5 * np.abs(rows_j).max())
    np.testing.assert_allclose(jm_t.numpy(), jm_j, rtol=1e-5, atol=1e-7)
    if case == "named":
        assert not jm_t[..., 1].any() and not jm_t[..., 3].any()  # "b", "d": no dimension


def test_qr_solve_of_the_full_stack_takes_the_analytic_jacobian(stack, monkeypatch):
    """solve_ik hands a QR solve of the four modules their analytic
    Jacobian (JAX's route, solver/ik.py:73), which agrees with forward mode."""
    _, tchar, _, tmods = stack
    seen = []
    real = port_ik.solve_gauss_newton

    def spy(*args, **kwargs):
        seen.append(kwargs["jacobian_fn"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_ik, "solve_gauss_newton", spy)
    fn = SkeletonSolverFunction(tchar, tuple(tmods))
    x0 = torch.as_tensor(_poses(tchar.num_model_parameters, 4, 5))
    res = port_ik.solve_ik(fn, x0, None, SolverOptions(max_iterations=2, linear_solver="qr"))
    assert seen and seen[0] is not None
    assert torch.isfinite(res.params).all()
    rows, jac = seen[0](x0)
    rows_ad, jac_ad = ad_jacobian(fn.residual, x0)
    np.testing.assert_allclose(rows.numpy(), rows_ad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(jac.numpy(), jac_ad.transpose(-1, -2).numpy(), rtol=0,
                               atol=1e-4 * float(jac_ad.abs().max()))


def test_sequence_frame_jacobian_with_a_prior_is_analytic(stack, monkeypatch):
    """make_frame_jacobian on the full-body rig with a prior beside the
    markers: the analytic branch (forward mode is refused here), equal to
    JAX's per-frame Jacobian."""
    jchar, tchar, jmods, tmods = stack
    frames, p = 3, jchar.num_model_parameters
    x = _poses(p, frames, 6) * 0.5
    targets = np.array(jax.vmap(jchar.locators.world_positions)(
        jax.vmap(jchar.skeleton_states)(jnp.asarray(x))))
    mask = np.zeros(p, bool)
    mask[6] = True
    jpos = [dataclasses.replace(jmods[0], target=jnp.asarray(t)) for t in targets]
    tpos = [dataclasses.replace(tmods[0], target=torch.as_tensor(t)) for t in targets]
    jfn = jsf.SequenceSolverFunction.create(
        jchar, frames, universal=mask,
        per_frame_errors=(jsf.stack_frames(jpos), jsf.stack_frames([jmods[3]] * frames)))
    tfn = tsf.SequenceSolverFunction.create(
        tchar, frames, universal=mask,
        per_frame_errors=(tsf.stack_frames(tpos), tsf.stack_frames([tmods[3]] * frames)))

    def refuse(*args):
        raise AssertionError("the per-frame Jacobian took forward mode")

    monkeypatch.setattr(tsol, "_jacobian_columns", refuse)
    theta = _poses(p, frames, 8) * 0.3
    jpf, ju = jfn.split(jnp.asarray(theta))
    tpf, tu = tfn.split(torch.as_tensor(theta))
    got = tsol.make_frame_jacobian(tfn)(tpf, tu)
    want = jax.vmap(jsol.make_frame_jacobian(jfn), in_axes=(0, None, 0))(
        jpf, ju, jfn.per_frame_errors)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=JAC_TOL["rtol"],
                                   atol=JAC_TOL["atol"] * max(1.0, np.abs(w).max()))
