"""Parity of the port's torch_interop (native torch modules and functions)
with momentum_tpu.torch_interop (the JAX package's torch bridge) on the CPU:
every ported name's forward, and its gradient through .backward(), on the
same torch inputs.

Tolerances: forward and gradients of FK, skinning, the parameter transforms,
blend shapes and limits to rtol 1e-5 / atol 1e-5 of unit-scale values
(float32 chains summed in another order; test_torch_port_jacobian.py's);
the IK solve's θ* to 1e-4 and its gradients to 1e-3 of their largest
entry (tests/test_torch_port_diff_ik.py's); the sequence solve as
test_torch_port_sequence.py's, parameters to 1e-3.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import momentum_tpu.torch_interop as jti
import momentum_tpu_torch.torch_interop as tti
from momentum_tpu import errors as jerr
from momentum_tpu.character.blend_shape import BlendShape as JBlendShape
from momentum_tpu.character.utility import add_blend_shape_parameters as jadd_blend
from momentum_tpu.sequence import errors as jse
from momentum_tpu.sequence import solver_function as jsf
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.testing.fixtures import create_fullbody_character as jax_fullbody
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu_torch import bridge
from momentum_tpu_torch import errors as terr
from momentum_tpu_torch.sequence import errors as tse
from momentum_tpu_torch.sequence import solver_function as tsf
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn
from momentum_tpu_torch.solver import SolverOptions as TOpts
from momentum_tpu_torch.solver import solve_ik_ift
from momentum_tpu_torch.testing import workloads
from momentum_tpu_torch.testing.fixtures import create_test_character

from test_torch_port_helpers import character_to_numpy
from test_torch_port_helpers import one_torch_thread  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4


def _rig(name):
    """(JAX character, the port's from the same arrays): the full-body rig,
    with 8 blend shapes, or config C's with its extra limit records."""
    if name == "catalog":
        jchar = jax_reference.catalog_character()
    else:
        jchar = jax_fullbody()
        if name == "blend":
            v = jchar.mesh.num_vertices
            vectors = np.random.default_rng(0).normal(0, 0.01, (8, v, 3)).astype(np.float32)
            jchar = jadd_blend(jchar, JBlendShape(base_shape=jchar.mesh.vertices,
                                                  shape_vectors=jnp.asarray(vectors)))
    return jchar, bridge.character_from_numpy(character_to_numpy(jchar), device="cpu")


def _params(p, seed=0, scale=0.3):
    return np.random.default_rng(seed).uniform(-scale, scale, (B, p)).astype(np.float32)


def _both(j_out_fn, t_out_fn, x, seed=1):
    """Forward of each side on a leaf copy of x, then backward of a random
    projection of the output; (outputs, gradients) of (JAX, port)."""
    outs, grads = [], []
    for fn in (j_out_fn, t_out_fn):
        xt = torch.as_tensor(x).clone().requires_grad_()
        y = fn(xt)
        r = torch.as_tensor(np.random.default_rng(seed).normal(size=tuple(y.shape)),
                            dtype=y.dtype)
        (y * r).sum().backward()
        outs.append(y.detach().numpy())
        grads.append(xt.grad.numpy())
    return outs, grads


def _close(pair, **tol):
    np.testing.assert_allclose(pair[1], pair[0], **(tol or TOL))


@pytest.mark.parametrize("which", ["model", "joint"])
def test_skeleton_module(which):
    jchar, tchar = _rig("fullbody")
    js, ts = jti.Skeleton(jchar), tti.Skeleton(tchar)
    if which == "model":
        x = _params(tchar.num_model_parameters)
        outs, grads = _both(js, ts, x)
    else:
        x = _params(tchar.parameter_transform.num_joint_parameters, scale=0.2)
        outs, grads = _both(js.joint_parameters_to_skeleton_state,
                            ts.joint_parameters_to_skeleton_state, x)
    _close(outs)
    _close(grads, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rig", ["fullbody", "blend"])
def test_linear_blend_skinning_module(rig):
    jchar, tchar = _rig(rig)
    x = _params(tchar.num_model_parameters, scale=0.2)
    outs, grads = _both(jti.LinearBlendSkinning(jchar), tti.LinearBlendSkinning(tchar), x)
    _close(outs)
    _close(grads, rtol=1e-5, atol=1e-4)


def test_parameter_transform_modules():
    jchar, tchar = _rig("fullbody")
    x = _params(tchar.num_model_parameters)
    outs, grads = _both(jti.ParameterTransformModule(jchar),
                        tti.ParameterTransformModule(tchar), x)
    _close(outs)
    _close(grads)
    jp = outs[1]
    outs, grads = _both(jti.InverseParameterTransformModule(jchar),
                        tti.InverseParameterTransformModule(tchar), jp)
    _close(outs, rtol=1e-4, atol=1e-5)
    _close(grads, rtol=1e-4, atol=1e-5)
    # the pseudo-inverse recovers the model parameters
    np.testing.assert_allclose(outs[1], x, atol=1e-4)


def test_blend_shape_module():
    jchar, tchar = _rig("blend")
    x = np.random.default_rng(2).uniform(-1, 1, (B, 8)).astype(np.float32)
    outs, grads = _both(jti.BlendShapeModule(jchar.blend_shape),
                        tti.BlendShapeModule(tchar.blend_shape), x)
    _close(outs)
    _close(grads)


@pytest.mark.parametrize("rig", ["fullbody", "catalog"])
def test_parameter_limits_module(rig):
    """The total limit energy and its split per record type (config C's rig
    has five: every type but MinMaxJoint), forward and gradient, at poses
    past the limits."""
    jchar, tchar = _rig(rig)
    x = _params(tchar.num_model_parameters, scale=0.8)
    jm, tm = jti.ParameterLimitsModule(jchar, weight=0.7), tti.ParameterLimitsModule(tchar, 0.7)
    outs, grads = _both(jm, tm, x)
    _close(outs, rtol=1e-5, atol=1e-6)
    _close(grads, rtol=1e-5, atol=1e-5)
    xt = torch.as_tensor(x)
    jt, tt = jm.evaluate_by_type(xt), tm.evaluate_by_type(xt)
    assert list(jt) == list(tt) and len(tt) == (5 if rig == "catalog" else 1)
    for k in tt:
        np.testing.assert_allclose(tt[k].numpy(), jt[k].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sum(tt.values()).numpy(), tm(xt).numpy(), rtol=1e-5)


@pytest.fixture(scope="module")
def ik_problem():
    """The 4-joint rig's locators at one random pose as targets: JAX's and the
    port's build functions of solve_ik_torch's `inputs` (targets, cweight),
    with a 1e-3 prior toward zero (tests/test_diff_ik.py's problem)."""
    jchar = jax_test_character(4)
    tchar = create_test_character(4, device="cpu")
    p = jchar.num_model_parameters
    truth = np.random.default_rng(12345).uniform(-0.3, 0.3, p).astype(np.float32)
    targets = np.array(jchar.locators.world_positions(jchar.skeleton_states(jnp.asarray(truth))))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    jpos, tpos = jerr.PositionErrorFunction.create(*args), terr.PositionErrorFunction.create(
        *args, device="cpu")
    jprior = jerr.ModelParametersErrorFunction.create(np.zeros(p), weight=1e-3)
    tprior = terr.ModelParametersErrorFunction.create(np.zeros(p), weight=1e-3, device="cpu")

    def jbuild(inputs):
        return JFn(jchar, (dataclasses.replace(jpos, target=inputs["targets"],
                                               cweight=inputs["cweight"]), jprior))

    def tbuild(inputs):
        return TFn(tchar, (dataclasses.replace(tpos, target=inputs["targets"],
                                               cweight=inputs["cweight"]), tprior))

    return jbuild, tbuild, targets, p


def test_solve_ik_torch(ik_problem):
    """θ* and the gradients of w·θ* to the targets, the constraint weights
    and x0 through each package's solve_ik_torch (one problem: JAX's
    backward holds unbatched only, ROADMAP F20)."""
    jbuild, tbuild, targets, p = ik_problem
    w = torch.as_tensor(np.random.default_rng(3).normal(size=p).astype(np.float32))
    opts = dict(max_iterations=40, regularization=1e-6)
    results = []
    for solve, build, options in ((jti.solve_ik_torch, jbuild, JOpts(**opts)),
                                  (tti.solve_ik_torch, tbuild, TOpts(**opts))):
        t = torch.as_tensor(targets).clone().requires_grad_()
        c = torch.ones(targets.shape[0], requires_grad=True)
        x0 = torch.zeros(p, requires_grad=True)
        theta = solve(build, x0, {"targets": t, "cweight": c}, options)
        (theta * w).sum().backward()
        results.append((theta.detach().numpy(), t.grad.numpy(), c.grad.numpy(),
                        x0.grad.numpy()))
    (jtheta, *jgrads), (ttheta, *tgrads) = results
    np.testing.assert_allclose(ttheta, jtheta, atol=1e-4)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * max(np.abs(want).max(), 1e-6))
    assert tti.solve_ik is tti.solve_ik_torch


def test_residual_gradient_jacobian(ik_problem):
    """residual, gradient and jacobian of an IK problem at B poses, and the
    gradient statistics they count."""
    jbuild, tbuild, targets, p = ik_problem
    x = torch.as_tensor(_params(p))
    inputs = {"targets": torch.as_tensor(targets), "cweight": torch.ones(targets.shape[0])}
    jinputs = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    np.testing.assert_allclose(tti.residual(tbuild, x, inputs).numpy(),
                               jti.residual(jbuild, x, inputs).numpy(), **TOL)
    for mod in (jti, tti):
        mod.reset_gradient_statistics()
    for _ in range(2):
        g_t = tti.gradient(tbuild, x, inputs)
        g_j = jti.gradient(lambda d: jbuild(jinputs), x, inputs)
    np.testing.assert_allclose(g_t.numpy(), g_j.numpy(), rtol=1e-5, atol=1e-4)
    assert tti.get_gradient_statistics() == jti.get_gradient_statistics() == {
        "n_gradient": 2, "n_gradient_batch": 2 * B}
    (rt, jt), (rj, jj) = tti.jacobian(tbuild, x, inputs), jti.jacobian(jbuild, x, inputs)
    np.testing.assert_allclose(rt.numpy(), rj.numpy(), **TOL)
    np.testing.assert_allclose(jt.numpy(), jj.numpy(), rtol=1e-5, atol=1e-4)


def test_solve_ik_statistics(ik_problem):
    """The solve counters after a reset and one solve of B problems."""
    _, tbuild, targets, p = ik_problem
    tti.reset_solve_ik_statistics()
    inputs = {"targets": torch.as_tensor(targets).expand(B, -1, -1),
              "cweight": torch.ones(B, targets.shape[0])}
    tti.solve_ik_torch(tbuild, torch.zeros(B, p), inputs, TOpts(max_iterations=3))
    assert tti.get_solve_ik_statistics() == {
        "n_total_solve_ik": B, "n_total_solve_ik_iter": 3 * B, "n_solve_ik": 0,
        "n_solve_ik_batch": 0}
    tti.reset_solve_ik_statistics()
    jti.reset_solve_ik_statistics()
    assert tti.get_solve_ik_statistics() == jti.get_solve_ik_statistics()


def test_solve_sequence_ik():
    """solve_sequence_ik on 8 frames of the 4-joint rig with motion
    smoothness, the parameter 6 shared, GN 6, against JAX's."""
    frames = 8
    jchar, tchar = jax_test_character(4), create_test_character(4, device="cpu")
    p = jchar.num_model_parameters
    gt = np.random.default_rng(0).uniform(-0.2, 0.2, (frames, p)).astype(np.float32)
    targets = np.array(jax.vmap(jchar.locators.world_positions)(
        jax.vmap(jchar.skeleton_states)(jnp.asarray(gt))))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    universal = np.zeros(p, bool)
    universal[6] = True

    def jbuild(inputs):
        jef = jax.vmap(lambda t: dataclasses.replace(jerr.PositionErrorFunction.create(*args),
                                                     target=t))(inputs["targets"])
        return jsf.SequenceSolverFunction.create(
            jchar, frames, universal=universal, per_frame_errors=(jef,),
            sequence_errors=(jse.ModelParametersSequenceErrorFunction.create(p, weight=0.1),))

    def tbuild(inputs):
        tef = tsf.stack_frames([dataclasses.replace(
            terr.PositionErrorFunction.create(*args, device="cpu"), target=t)
            for t in inputs["targets"]])
        return tsf.SequenceSolverFunction.create(
            tchar, frames, universal=universal, per_frame_errors=(tef,),
            sequence_errors=(tse.ModelParametersSequenceErrorFunction.create(
                p, weight=0.1, device="cpu"),))

    tfn = tbuild({"targets": torch.as_tensor(targets)})
    pf0, u0 = tfn.split(torch.zeros(frames, p))
    inputs = {"targets": torch.as_tensor(targets)}
    pf_t, u_t = tti.solve_sequence_ik(tbuild, pf0, u0, inputs, TOpts(max_iterations=6))
    pf_j, u_j = jti.solve_sequence_ik(jbuild, pf0, u0, inputs, JOpts(max_iterations=6))
    np.testing.assert_allclose(pf_t.numpy(), pf_j.numpy(), atol=1e-3)
    np.testing.assert_allclose(u_t.numpy(), u_j.numpy(), atol=1e-3)


def test_set_num_threads():
    n = torch.get_num_threads()
    tti.set_num_threads(n)
    jti.set_num_threads(n)
    assert torch.get_num_threads() == n


def test_config_d_entry_point_matches_solve_ik_ift():
    """Config D's solve through solve_ik_torch (workloads.solve_diff_ik) and
    through solve_ik_ift directly give the same θ* and gradients."""
    prob = workloads.build_diff_ik_problem(4, device="cpu")
    grads = []
    for direct in (False, True):
        t, c, x0 = (v.clone().requires_grad_() for v in (prob.targets, prob.cweight, prob.x0))
        if direct:
            fn = workloads.diff_ik_solver_fn(prob, {"targets": t, "cweight": c})
            theta = solve_ik_ift(fn, x0, prob.mask, workloads.diff_ik_options())
        else:
            theta = workloads.solve_diff_ik(prob, t, c, x0)
        (theta * prob.w).sum().backward()
        grads.append((theta.detach(), t.grad, c.grad, x0.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
