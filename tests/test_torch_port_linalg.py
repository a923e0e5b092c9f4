"""Parity of the port's damped SPD solve (the plain path of kernel K2+K3)
with momentum_tpu on the CPU: against the JAX CPU solve and against the
Pallas panel kernels (ops/psd_pallas.py) in interpret mode, as
tests/test_psd_pallas.py runs them.

Solves are compared by relative residual ‖(A + D)x − b‖/‖b‖ ≤ 1e-4, not by
raw x: reassociation alone moves x of an ill-conditioned system (ROADMAP
F5). An indefinite system gives NaN in both packages (ROADMAP F1)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.math import linalg as jlinalg
from momentum_tpu.ops.psd_pallas import psd_solve_pallas
from momentum_tpu_torch.math import linalg as tlinalg
from momentum_tpu_torch.ops import psd

RELRES_TOL = 1e-4


def _system(rng, b_sz, n, rows_extra=40):
    j = rng.normal(size=(b_sz, n + rows_extra, n)).astype(np.float32)
    a = np.einsum("brp,brq->bpq", j, j).astype(np.float32)
    diag = np.einsum("bii->bi", a)
    damp = (0.01 * diag + 1e-5).astype(np.float32)
    b = rng.normal(size=(b_sz, n)).astype(np.float32)
    return a, damp, b


def _relres(a, damp, b, x):
    a64 = a.astype(np.float64) + np.einsum("bi,ij->bij", damp.astype(np.float64),
                                           np.eye(a.shape[-1]))
    r = np.einsum("bij,bj->bi", a64, np.asarray(x, np.float64)) - b
    return np.linalg.norm(r, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("n", [157, 40])
def test_damped_solve_matches_jax_and_pallas(rng, n):
    a, damp, b = _system(rng, 32, n)
    x_t = tlinalg.damped_psd_solve(torch.as_tensor(a), torch.as_tensor(damp),
                                   torch.as_tensor(b)).numpy()
    x_j = np.asarray(jlinalg.damped_psd_solve(jnp.asarray(a), jnp.asarray(damp),
                                              jnp.asarray(b)))
    x_p = np.asarray(psd_solve_pallas(jnp.asarray(a), jnp.asarray(b),
                                      damp_diag=jnp.asarray(damp), interpret=True))
    for x in (x_t, x_j, x_p):
        assert np.max(_relres(a, damp, b, x)) <= RELRES_TOL
    # the same solution up to the conditioning of the system
    scale = np.max(np.abs(x_j))
    np.testing.assert_allclose(x_t / scale, x_j / scale, atol=1e-4)
    np.testing.assert_allclose(x_t / scale, x_p / scale, atol=1e-4)


def test_psd_solve_matches_jax(rng):
    a, damp, b = _system(rng, 8, 24)
    a = a + np.einsum("bi,ij->bij", damp, np.eye(24)).astype(np.float32)
    x_t = tlinalg.psd_solve(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    x_j = np.asarray(jlinalg.psd_solve(jnp.asarray(a), jnp.asarray(b)))
    assert np.max(_relres(a, np.zeros_like(damp), b, x_t)) <= RELRES_TOL
    scale = np.max(np.abs(x_j))
    np.testing.assert_allclose(x_t / scale, x_j / scale, atol=1e-4)


def test_unbatched_and_broadcast_damping(rng):
    a, damp, b = _system(rng, 1, 30)
    x_batched = tlinalg.damped_psd_solve(torch.as_tensor(a), torch.tensor(0.5),
                                         torch.as_tensor(b))
    x_single = tlinalg.damped_psd_solve(torch.as_tensor(a[0]), torch.tensor(0.5),
                                        torch.as_tensor(b[0]))
    assert x_single.shape == (30,)
    np.testing.assert_array_equal(x_single.numpy(), x_batched[0].numpy())
    assert np.max(_relres(a, np.full_like(damp, 0.5), b, x_batched.numpy())) <= RELRES_TOL


def test_indefinite_system_gives_nan_in_both_packages(rng):
    """ROADMAP F1: the JAX CPU path's NaN, not the TPU kernels' pivot clamp."""
    a, damp, b = _system(rng, 4, 64)
    a[1, 7, 7] = -1e4
    x_t = tlinalg.damped_psd_solve(torch.as_tensor(a), torch.as_tensor(damp),
                                   torch.as_tensor(b)).numpy()
    x_j = np.asarray(jlinalg.damped_psd_solve(jnp.asarray(a), jnp.asarray(damp),
                                              jnp.asarray(b)))
    for x in (x_t, x_j):
        assert np.all(np.isnan(x[1]))
        assert np.all(np.isfinite(np.delete(x, 1, axis=0)))


def test_matrix_right_hand_side_is_refused(rng):
    a, damp, b = _system(rng, 2, 8)
    with pytest.raises(ValueError):
        tlinalg.psd_solve(torch.as_tensor(a), torch.as_tensor(b)[..., None].expand(2, 8, 3))


def test_cpu_wrapper_takes_the_plain_path(rng):
    a, damp, b = (torch.as_tensor(v) for v in _system(rng, 4, 20))
    before = psd.launches
    x = psd.damped_chol_solve(a, damp, b)
    np.testing.assert_array_equal(x.numpy(), psd.damped_chol_solve_plain(a, damp, b).numpy())
    assert psd.launches == before == 0
