"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; every test skips without a CUDA device. This file imports no
jax, so it also runs where only the port is installed — without the suite's
conftest, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.ops import fk as fk_ops, psd
from momentum_tpu_torch.testing import workloads

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return workloads.build_fullbody_ik_problem(256, seed=2, device="cuda")


def _spd(n, batch, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    j = torch.randn(batch, n + 20, n, generator=g)
    a = j.transpose(-1, -2) @ j
    return (a.cuda(), (0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5).cuda(),
            torch.randn(batch, n, generator=g).cuda())


def test_fk_kernel_matches_plain(cuda_problem):
    char, _, _, x0 = cuda_problem
    local = fk.local_skel_states(char.skeleton, char.parameter_transform.apply(x0))
    before = fk_ops.launches
    out = fk_ops.fk_global(char.skeleton, local.contiguous())
    assert fk_ops.launches == before + 1
    torch.testing.assert_close(out, fk_ops.fk_global_plain(char.skeleton, local),
                               rtol=0, atol=2e-5)
    # a ragged last block and a single element
    for b in (37, 1):
        torch.testing.assert_close(fk_ops.fk_global(char.skeleton, local[:b].contiguous()),
                                   fk_ops.fk_global_plain(char.skeleton, local[:b]),
                                   rtol=0, atol=2e-5)


def test_fk_kernel_refuses_what_it_cannot_take(cuda_problem):
    char, _, _, x0 = cuda_problem
    local = fk.local_skel_states(char.skeleton, char.parameter_transform.apply(x0))
    with pytest.raises(ValueError):
        fk_ops.fk_global(char.skeleton, local.double())
    with pytest.raises(ValueError):
        fk_ops.fk_global(char.skeleton, local.transpose(0, 1))
    with pytest.raises(RuntimeError):
        fk_ops.fk_global(char.skeleton, local.clone().requires_grad_())


@pytest.mark.parametrize("n", [157, 40, 1])
def test_damped_solve_kernel_matches_plain(cuda_problem, n):
    a, damp, b = _spd(n, 64, seed=n)
    before = psd.launches
    x = psd.damped_chol_solve(a, damp, b)
    assert psd.launches == before + 1
    ad = (a + torch.diag_embed(damp)).double()
    res = torch.linalg.norm((ad @ x.double()[..., None])[..., 0] - b.double(), dim=-1)
    assert float((res / torch.linalg.norm(b.double(), dim=-1)).max()) <= 1e-5
    x_plain = psd.damped_chol_solve_plain(a, damp, b)
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


def test_damped_solve_kernel_nan_on_indefinite(cuda_problem):
    """ROADMAP F1: a pivot that is not > 0 gives an all-NaN x, as in the
    plain version; the other systems of the batch are unaffected."""
    a, damp, b = _spd(64, 4, seed=5)
    a[1, 10, 10] = -1e5
    a[3, 0, 0] = float("nan")
    for x in (psd.damped_chol_solve(a, damp, b), psd.damped_chol_solve_plain(a, damp, b)):
        assert torch.isnan(x[1]).all() and torch.isnan(x[3]).all()
        assert torch.isfinite(x[0]).all() and torch.isfinite(x[2]).all()


def test_damped_solve_kernel_refuses_what_it_cannot_take(cuda_problem):
    a, damp, b = _spd(16, 2, seed=1)
    with pytest.raises(ValueError):
        psd.damped_chol_solve(a.double(), damp.double(), b.double())
    with pytest.raises(ValueError):
        psd.damped_chol_solve(a.transpose(-1, -2).contiguous()[:, :, :8], damp, b)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 300, 300, device="cuda")
        psd.damped_chol_solve(big, torch.ones(1, 300, device="cuda"),
                              torch.ones(1, 300, device="cuda"))


def test_main_path_on_cuda_matches_cpu(cuda_problem):
    """The whole compacted solve at B = 256 on the card against the same
    solve on the CPU (plain versions): the same convergence statistics."""
    char, ef0, targets, x0 = cuda_problem
    fk_ops.launches = psd.launches = 0
    res = workloads.make_solve_batch(char, ef0, 256)(targets, x0)
    assert fk_ops.launches > 0 and psd.launches > 0
    char_c, ef0_c, targets_c, x0_c = workloads.build_fullbody_ik_problem(256, seed=2)
    res_c = workloads.make_solve_batch(char_c, ef0_c, 256)(targets_c, x0_c)
    e, e_c = res.error.cpu().numpy(), res_c.error.numpy()
    assert np.all(np.isfinite(e))
    assert abs(np.mean(e < 1e-5) - np.mean(e_c < 1e-5)) <= 4 / 256
    assert abs(np.median(e) / np.median(e_c) - 1) <= 0.2
