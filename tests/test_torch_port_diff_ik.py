"""Parity of the port's differentiable IK (solver/diff_ik.py, solve_ik_ift and
gradient_rmse) with momentum_tpu on the CPU: against JAX's solve_ik_ift
vmapped per element on the 4-joint rig (tests/test_diff_ik.py's problem at
B = 3), against float64 central differences, x0's pass-through, JAX's
batched backward (ROADMAP F20), and config D (workloads.build_diff_ik_problem)
at B = 16 against tools/jax_reference.py's.

Tolerances, each with what this file measured:
  * against vmapped JAX on the 4-joint rig (GN 40, converged): θ* to 1e-4,
    the gradients to 1e-3 of their largest entry (measured 7e-5);
  * float64 gradcheck with reachable targets (zero residual at θ*, where
    the Gauss-Newton H is the exact Hessian): torch.autograd.gradcheck's
    defaults, eps 1e-6, atol 1e-5, rtol 1e-3;
  * float64 central differences with the prior (a nonzero residual, where
    H ≈ 2·JᵀJ is the reference's approximation): test_diff_ik.py's
    5e-2·max(1, |fd|);
  * config D at B = 16 as chip_smoke.py holds the card: the median energy
    at θ* within 20%, ∂L/∂targets' median per-element relative L2 error
    within 5e-2, and on the elements stationary in both (gradient rmse ≤
    1e-3; 9 of 16) the per-element gradients within 5e-2 (measured ≤ 6e-3).
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu.errors import ModelParametersErrorFunction as JPrior
from momentum_tpu.errors import PositionErrorFunction as JPos
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.solver.diff_ik import gradient_rmse as jax_gradient_rmse
from momentum_tpu.solver.diff_ik import solve_ik_ift as jax_solve_ik_ift
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu_torch.errors import ModelParametersErrorFunction as TPrior
from momentum_tpu_torch.errors import PositionErrorFunction as TPos
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn
from momentum_tpu_torch.solver import SolverOptions as TOpts
from momentum_tpu_torch.solver import gradient_rmse, solve_ik_ift
from momentum_tpu_torch.testing import workloads
from momentum_tpu_torch.testing.fixtures import create_test_character

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402
from test_torch_port_helpers import one_torch_thread  # noqa: F401

B = 3
OPTS = dict(max_iterations=40, regularization=1e-6)


def _double(obj):
    """obj with every float tensor (and its dataclasses') in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, tuple):
        return tuple(_double(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _double(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


@pytest.fixture(scope="module")
def rig():
    """tests/test_diff_ik.py's problem on B poses: the 4-joint rig, targets
    from U(±0.3) poses, a 1e-3 prior toward zero; (JAX char, port char,
    targets (B, 4, 3), loss weights (B, P), the JAX and port modules)."""
    jchar = jax_test_character(4)
    tchar = create_test_character(4, device="cpu")
    p = jchar.num_model_parameters
    rng = np.random.default_rng(12345)
    truth = rng.uniform(-0.3, 0.3, (B, p)).astype(np.float32)
    targets = np.array(jax.vmap(lambda t: jchar.locators.world_positions(
        jchar.skeleton_states(t)))(jnp.asarray(truth)))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    w = np.random.default_rng(3).normal(size=(B, p)).astype(np.float32)
    return dict(jchar=jchar, tchar=tchar, targets=targets, w=w, jpos=JPos.create(*args),
                tpos=TPos.create(*args, device="cpu"),
                jprior=JPrior.create(np.zeros(p), weight=1e-3),
                tprior=TPrior.create(np.zeros(p), weight=1e-3, device="cpu"))


def _jax_one(r, x0, mask=None):
    """Per element, JAX's θ* from x0 (B, P) and the gradients of w·θ* to its
    targets and constraint weights, vmapped (JAX's backward holds one
    element, F20)."""
    m = None if mask is None else jnp.asarray(mask)

    def one(tg, cw, x, wi):
        def loss(tg, cw):
            fn = JFn(r["jchar"], (dataclasses.replace(r["jpos"], target=tg, cweight=cw),
                                  r["jprior"]))
            theta = jax_solve_ik_ift(fn, x, m, JOpts(**OPTS))
            return jnp.sum(wi * theta), theta

        (_, theta), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(tg, cw)
        return theta, grads

    cw = jnp.ones(r["targets"].shape[:2], jnp.float32)
    return jax.jit(jax.vmap(one))(jnp.asarray(r["targets"]), cw, jnp.asarray(x0),
                                  jnp.asarray(r["w"]))


def _port(r, x0=None, mask=None, dtype=torch.float32):
    """The port's batched θ*, and the leaves (targets, cweight, x0) after
    back-propagating w·θ*."""
    char = r["tchar"] if dtype == torch.float32 else _double(r["tchar"])
    conv = (lambda t: t) if dtype == torch.float32 else _double
    t = torch.as_tensor(r["targets"], dtype=dtype).requires_grad_()
    c = torch.ones(r["targets"].shape[:2], dtype=dtype, requires_grad=True)
    x0 = torch.zeros(r["w"].shape, dtype=dtype) if x0 is None else x0
    fn = TFn(char, (dataclasses.replace(conv(r["tpos"]), target=t, cweight=c),
                    conv(r["tprior"])))
    m = None if mask is None else torch.as_tensor(mask, dtype=dtype)
    theta = solve_ik_ift(fn, x0, m, TOpts(**OPTS))
    (theta * torch.as_tensor(r["w"], dtype=dtype)).sum().backward()
    return theta.detach(), t, c, fn


def test_solve_ik_ift_matches_vmapped_jax(rig):
    """θ*, its gradient rmse and the gradients to the targets and the
    constraint weights, batch-native in the port, against JAX's vmapped."""
    jtheta, (jg_t, jg_c) = _jax_one(rig, np.zeros(rig["w"].shape, np.float32))
    theta, t, c, fn = _port(rig)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), atol=1e-4)
    for got, want in ((t.grad, jg_t), (c.grad, jg_c)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())
    rmse = gradient_rmse(fn, theta).detach().numpy()
    jfns = [JFn(rig["jchar"], (dataclasses.replace(rig["jpos"], target=rig["targets"][i]),
                               rig["jprior"])) for i in range(B)]
    want = [float(jax_gradient_rmse(f, jtheta[i])) for i, f in enumerate(jfns)]
    assert rmse.shape == (B,) and rmse.max() < 1e-4
    np.testing.assert_allclose(rmse, want, atol=2e-5)


def test_jax_backward_holds_unbatched_only(rig):
    """F20: JAX's solve_ik_ift backward takes jax.grad of a scalar energy and
    transposes every axis of Jᵀ (diff_ik.py:78-88), so a batched solve's
    gradient raises; the port's batched backward gives each element the
    gradient JAX's vmapped one gives it (the test above)."""
    fn = JFn(rig["jchar"], (dataclasses.replace(rig["jpos"], target=jnp.asarray(rig["targets"])),
                            rig["jprior"]))
    p = rig["w"].shape[1]

    def loss(x0):
        return jnp.sum(jax_solve_ik_ift(fn, x0, None, JOpts(**OPTS)))

    with pytest.raises((ValueError, TypeError)):
        jax.grad(loss)(jnp.zeros((B, p)))


def test_gradcheck_float64_at_reachable_targets(rig):
    """torch.autograd.gradcheck of θ*(targets) in float64, no prior and the
    targets reachable: at zero residual the IFT gradient is the solve's
    exact derivative."""
    char = _double(rig["tchar"])
    pos = _double(rig["tpos"])
    x0 = torch.zeros(1, rig["w"].shape[1], dtype=torch.float64)

    def solve(targets):
        fn = TFn(char, (dataclasses.replace(pos, target=targets),))
        return solve_ik_ift(fn, x0, None, TOpts(max_iterations=40, regularization=1e-9))

    targets = torch.as_tensor(rig["targets"][:1], dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(solve, (targets,), eps=1e-6, atol=1e-5, rtol=1e-3)


def test_gradients_match_float64_central_differences(rig):
    """With the prior (a nonzero residual at θ*), the float64 IFT gradients
    to a target coordinate and a constraint weight of each element against
    central differences of the float64 solve (tests/test_diff_ik.py's
    check)."""
    _, t, c, _ = _port(rig, dtype=torch.float64)
    char, pos, prior = _double(rig["tchar"]), _double(rig["tpos"]), _double(rig["tprior"])
    w = torch.as_tensor(rig["w"], dtype=torch.float64)

    def loss(targets, cweight):
        fn = TFn(char, (dataclasses.replace(pos, target=targets, cweight=cweight), prior))
        theta = solve_ik_ift(fn, torch.zeros_like(w), None, TOpts(**OPTS))
        return (theta * w).sum(-1)

    t0 = torch.as_tensor(rig["targets"], dtype=torch.float64)
    c0 = torch.ones(t0.shape[:2], dtype=torch.float64)
    eps = 1e-4
    for (i, j), k in (((0, 0), 1), ((2, 1), 2)):
        dt = torch.zeros_like(t0)
        dt[:, i, j] = eps
        fd = (loss(t0 + dt, c0) - loss(t0 - dt, c0)) / (2 * eps)
        dc = torch.zeros_like(c0)
        dc[:, k] = eps
        fd_c = (loss(t0, c0 + dc) - loss(t0, c0 - dc)) / (2 * eps)
        for b in range(B):
            assert abs(float(t.grad[b, i, j] - fd[b])) < 5e-2 * max(1.0, abs(float(fd[b])))
            assert abs(float(c.grad[b, k] - fd_c[b])) < 5e-2 * max(1.0, abs(float(fd_c[b])))


def test_disabled_parameters_pass_through(rig):
    """x0's gradient is g on the parameters the mask disables and 0 on the
    others; the disabled parameters stay at x0 (tests/test_diff_ik.py's
    check, batched)."""
    p = rig["w"].shape[1]
    mask = np.ones(p, np.float32)
    mask[0] = 0.0
    x0 = torch.zeros((B, p), requires_grad=True)
    theta, t, _, _ = _port(rig, x0=x0, mask=mask)
    np.testing.assert_array_equal(theta[:, 0].numpy(), np.zeros(B, np.float32))
    np.testing.assert_array_equal(x0.grad[:, 0].numpy(), rig["w"][:, 0])
    assert float(x0.grad[:, 1:].abs().max()) == 0.0
    _, (jg_t, _) = _jax_one(rig, np.zeros((B, p), np.float32), mask)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_t), rtol=0,
                               atol=1e-3 * float(np.abs(np.asarray(jg_t)).max()))


def test_solve_ik_ift_without_leaves_returns_theta(rig):
    """No error-function tensor requires grad: θ* is the plain solve's and
    only x0 receives a gradient."""
    fn = TFn(rig["tchar"], (dataclasses.replace(rig["tpos"],
                                                target=torch.as_tensor(rig["targets"])),
                            rig["tprior"]))
    x0 = torch.zeros(rig["w"].shape, requires_grad=True)
    mask = torch.ones(rig["w"].shape[1])
    mask[3] = 0.0
    theta = solve_ik_ift(fn, x0, mask, TOpts(**OPTS))
    (theta * torch.as_tensor(rig["w"])).sum().backward()
    np.testing.assert_array_equal(x0.grad[:, 3].numpy(), rig["w"][:, 3])


@pytest.fixture(scope="module")
def config_d():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prob = workloads.build_diff_ik_problem(16, device="cpu")
        t, c, x0 = (v.clone().requires_grad_() for v in (prob.targets, prob.cweight, prob.x0))
        theta = workloads.solve_diff_ik(prob, t, c, x0)
        (theta * prob.w).sum().backward()
    finally:
        torch.set_num_threads(threads)
    fig, arrays = jax_reference.diffik(16)
    return prob, theta.detach(), (t.grad, c.grad, x0.grad), arrays


def test_config_d_problem_matches_the_tools(config_d):
    """The port's config D is the tool's: warm starts, loss weights and mask
    equal, targets to float32 FK rounding."""
    prob = config_d[0]
    _, _, _, targets, x0, mask, w = jax_reference.diffik_problem(16)
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(x0))
    np.testing.assert_array_equal(prob.w.numpy(), np.asarray(w))
    np.testing.assert_array_equal(prob.mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(prob.targets.numpy(), np.asarray(targets), rtol=0, atol=1e-5)


def test_config_d_matches_the_tools(config_d):
    """Config D at B = 16 (GN 20 through solve_ik_torch, the loss Σ w·θ*)
    against the tool's vmapped JAX: the median energy at θ*, ∂L/∂targets'
    median per-element error, on the elements stationary in both every
    per-element gradient, and x0's pass-through at scale_global."""
    prob, theta, (g_t, g_c, g_x0), ref = config_d
    fn = workloads.diff_ik_solver_fn(prob, {"targets": prob.targets, "cweight": prob.cweight})
    energy = fn.error(theta).numpy()
    assert abs(np.median(energy) / np.median(ref["energy"]) - 1) <= 0.2
    rel = {}
    for name, got, want in (("targets", g_t, ref["grad_targets"]),
                            ("cweight", g_c, ref["grad_cweight"])):
        a, b = got.flatten(1).numpy(), want.reshape(want.shape[0], -1)
        rel[name] = np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)
    assert np.median(rel["targets"]) <= 5e-2
    stationary = ((gradient_rmse(fn, theta, prob.mask).numpy() <= 1e-3)
                  & (ref["gradient_rmse"] <= 1e-3))
    assert stationary.sum() >= 6
    for name in rel:
        assert rel[name][stationary].max() <= 5e-2, name
    scale = prob.char.parameter_transform.names.index("scale_global")
    np.testing.assert_array_equal(g_x0[:, scale].numpy(), prob.w[:, scale].numpy())
    assert float(np.abs(np.delete(g_x0.numpy(), scale, axis=1)).max()) == 0.0
