"""Differentiable IK by the implicit function theorem, after
momentum_tpu/solver/diff_ik.py (the reference's
fully_differentiable_body_ik.h:49-57, tensor_ik.cpp:191-360).

Given dL/dθ* at an IK optimum θ*, the gradient to every input φ of the
error functions (targets, per-constraint weights, offsets, global weights)
is

    dL/dφ = −(∂G/∂φ)ᵀ · H⁻¹ · dL/dθ*,

with G(θ, φ) = ∂E/∂θ and H = ∂G/∂θ ≈ 2·JᵀJ (the Gauss-Newton approximation,
the reference's). It holds near a stationary point (`gradient_rmse` is the
reference's check).

`solve_ik_ift` is one torch.autograd.Function: its forward is `solve_ik`;
its backward is JAX's `_bwd` (:71-91), batch-native (JAX's holds only
unbatched, ROADMAP F20):
  * H = 2·JᵀJ on the enabled subspace (the normal equations at θ*, through
    K1), plus regularization + (1 − mask) on the diagonal;
  * u = H⁻¹ (g·mask), masked: one damped solve, K2+K3 on the card;
  * φ̄ = −∂/∂φ Σ D_θE(θ*, φ)[u]: the energy's directional derivative along u
    by forward mode (FK's tangent through K1's jvp rule, from θ* and u
    alone, so no derivative of FK is differentiated again), reverse-mode
    differentiated in φ only;
  * x0's gradient is g on the disabled parameters, which pass through.

The φ are the error functions' floating tensors that require grad when the
solve is called, found by walking the frozen dataclasses; each is an input
of the Function, so the gradient reaches whatever built it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from momentum_tpu_torch.math.linalg import damped_psd_solve
from momentum_tpu_torch.solver.gauss_newton import SolverOptions
from momentum_tpu_torch.solver.ik import solve_ik
from momentum_tpu_torch.solver.skeleton_solver_function import SkeletonSolverFunction

__all__ = ["solve_ik_ift", "gradient_rmse"]


def gradient_rmse(solver_fn: SkeletonSolverFunction, theta: torch.Tensor,
                  enabled_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMS of the (masked) energy gradient at theta (..., P), per element
    (...,): ~0 where the IFT backward is valid (the reference's
    gradientRmse, tensor_ik.cpp)."""
    g = solver_fn.gradient(theta)
    if enabled_mask is not None:
        g = g * enabled_mask
    return torch.sqrt(torch.mean(g * g, dim=-1))


def _leaves(obj, out: list) -> list:
    """Append the floating tensors requiring grad under obj (the fields of
    its frozen dataclasses and tuples) to `out`, each once."""
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad and obj.is_floating_point() and not any(obj is t for t in out):
            out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out)
    elif isinstance(obj, tuple):
        for item in obj:
            _leaves(item, out)
    return out


def _swap(obj, subs: dict):
    """obj with each tensor whose id is a key of `subs` replaced by its
    value, rebuilding the frozen dataclasses and tuples on the way."""
    if isinstance(obj, torch.Tensor):
        return subs.get(id(obj), obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {f.name: _swap(getattr(obj, f.name), subs)
                   for f in dataclasses.fields(obj) if f.init}
        changed = {k: v for k, v in changes.items() if v is not getattr(obj, k)}
        return dataclasses.replace(obj, **changed) if changed else obj
    if isinstance(obj, tuple):
        items = tuple(_swap(item, subs) for item in obj)
        return obj if all(a is b for a, b in zip(items, obj)) else items
    return obj


class _SolveIkIft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, enabled_mask, solver_fn, options, method, *leaves):
        theta = solve_ik(solver_fn, x0, enabled_mask, options, method).params
        ctx.solver_fn, ctx.options, ctx.leaves = solver_fn, options, leaves
        ctx.save_for_backward(theta, enabled_mask)
        return theta

    @staticmethod
    def backward(ctx, g):
        theta, enabled_mask = ctx.saved_tensors
        theta = theta.detach()
        p = theta.shape[-1]
        mask = theta.new_ones(p) if enabled_mask is None else enabled_mask.to(theta.dtype)
        with torch.no_grad():  # also under create_graph: the IFT is differentiated once
            jtj = ctx.solver_fn.normal_equations(theta)[0]
            h = jtj * (mask[:, None] * mask[None, :])
            u = damped_psd_solve(2.0 * h, ctx.options.regularization + (1.0 - mask),
                                 g * mask) * mask
        fresh = [t.detach().requires_grad_() for t in ctx.leaves]
        grads = [None] * len(fresh)
        if fresh:
            fn = _swap(ctx.solver_fn, {id(t): f for t, f in zip(ctx.leaves, fresh)})
            with torch.enable_grad():
                _, de = torch.func.jvp(fn.error, (theta,), (u,))
                grads = torch.autograd.grad(-de.sum(), fresh, allow_unused=True)
        x0_bar = g * (1.0 - mask)
        return (x0_bar, None, None, None, None, *grads)


def solve_ik_ift(
    solver_fn: SkeletonSolverFunction,
    x0: torch.Tensor,
    enabled_mask: Optional[torch.Tensor],
    options: SolverOptions = SolverOptions(),
    method: str = "gauss_newton",
) -> torch.Tensor:
    """Differentiable IK solve of x0 (..., P): θ*, through which gradients
    flow to solver_fn's error-function tensors that require grad (targets,
    weights, offsets, ...) by the IFT, and to x0 through the disabled
    parameters, which pass through untouched."""
    leaves = _leaves(solver_fn.error_functions, [])
    return _SolveIkIft.apply(x0, enabled_mask, solver_fn, options, method, *leaves)
