"""Parity of the port's K5 entry points (ops/chol.py) with
momentum_tpu/ops/chol_pallas.py on the CPU, where they take their plain
versions: tests/test_chol_pallas.py's problems through JAX's kernels in
interpret mode and through the port, at that test's tolerance (atol 3e-6
after dividing by max |x|). Also ROADMAP F1 (an indefinite system gives an
all-NaN x) and F6 (the blocked entry point refuses n % 32 ≠ 0, where JAX's
kernel silently misfactors), and the identity padding that F6 asks for."""

import numpy as np
import pytest
import torch

from momentum_tpu.ops.chol_pallas import chol_solve_pallas, chol_solve_pallas_blocked
from momentum_tpu_torch.ops import chol
from test_torch_port_helpers import one_torch_thread  # noqa: F401

ATOL = 3e-6  # tests/test_chol_pallas.py, on x / max|x|


def _problem(B=4, n=64, seed=0):
    """tests/test_chol_pallas.py::_problem, in numpy."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 1, (B, n, n)).astype(np.float32)
    a = m @ np.transpose(m, (0, 2, 1)) + n * np.eye(n, dtype=np.float32)
    damp = rng.uniform(0.1, 1.0, (B, n)).astype(np.float32)
    b = rng.normal(0, 1, (B, n)).astype(np.float32)
    ref = np.stack([np.linalg.solve(a[i] + np.diag(damp[i]), b[i]) for i in range(B)])
    return a, damp, b, ref


CASES = [(chol.chol_solve, chol_solve_pallas, {}),
         (chol.chol_solve_blocked, chol_solve_pallas_blocked, {"bt": 4})]


@pytest.mark.parametrize("shape", [(4, 64), (3, 32)])
@pytest.mark.parametrize("port,jax_kernel,kw", CASES,
                         ids=["chol_solve", "chol_solve_blocked"])
def test_entry_point_matches_jax_kernel(port, jax_kernel, kw, shape):
    a, damp, b, ref = _problem(*shape)
    x_jax = np.asarray(jax_kernel(a, damp, b, interpret=True, **kw))
    x = port(*(torch.as_tensor(v) for v in (a, damp, b))).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x / scale, ref / scale, rtol=0, atol=ATOL)
    np.testing.assert_allclose(x / scale, x_jax / scale, rtol=0, atol=ATOL)


@pytest.mark.parametrize("solve", [chol.chol_solve_plain, chol.chol_solve_blocked_plain,
                                   chol.chol_solve, chol.chol_solve_blocked])
def test_indefinite_system_is_all_nan(solve):
    """ROADMAP F1: a pivot that is not > 0 gives an all-NaN x (the TPU
    kernels clamp it to 1e-30 instead); the other systems are unaffected."""
    a, damp, b, _ = _problem(4, 32, seed=1)
    a[2, 7, 7] = -1e4
    x = solve(*(torch.as_tensor(v) for v in (a, damp, b)))
    assert torch.isnan(x[2]).all()
    assert torch.isfinite(x[[0, 1, 3]]).all()


@pytest.mark.parametrize("solve", [chol.chol_solve_blocked, chol.chol_solve_blocked_plain])
def test_blocked_refuses_n_not_a_multiple_of_32(solve):
    """ROADMAP F6: JAX's blocked kernel factors only n // 32 panels; the
    port raises instead of returning a wrong x."""
    a, damp, b, _ = _problem(2, 157)
    with pytest.raises(ValueError, match="multiple of 32"):
        solve(*(torch.as_tensor(v) for v in (a, damp, b)))


def test_identity_padding_gives_the_unpadded_solution():
    a, damp, b, ref = _problem(2, 157, seed=2)
    ap, dp, bp = chol.pad_identity(*(torch.as_tensor(v) for v in (a, damp, b)))
    assert ap.shape == (2, 160, 160) and dp.shape == bp.shape == (2, 160)
    np.testing.assert_array_equal(ap[:, :157, :157].numpy(), a)
    np.testing.assert_array_equal(ap[:, 157:, 157:].numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)))
    assert not ap[:, 157:, :157].any() and not dp[:, 157:].any() and not bp[:, 157:].any()
    x = chol.chol_solve_blocked(ap, dp, bp).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x[:, :157] / scale, ref / scale, rtol=0, atol=ATOL)
    assert not x[:, 157:].any()
    same = chol.pad_identity(ap, dp, bp)
    assert all(s is t for s, t in zip(same, (ap, dp, bp)))  # already a multiple


def test_cpu_entry_points_launch_no_kernel():
    from momentum_tpu_torch.ops import psd

    a, damp, b, _ = _problem(2, 32)
    before = psd.launches
    for solve in (chol.chol_solve, chol.chol_solve_blocked):
        solve(*(torch.as_tensor(v) for v in (a, damp, b)))
    assert psd.launches == before
