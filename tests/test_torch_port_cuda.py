"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`; every test skips without a CUDA device. This file imports no
jax, so it also runs where only the port is installed — without the suite's
conftest, which imports jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from momentum_tpu_torch.character import fk
from momentum_tpu_torch.math import linalg
from momentum_tpu_torch.ops import chol, fk as fk_ops, psd, raster
from momentum_tpu_torch.testing import workloads

from test_torch_port_helpers import TILE_EDGE_SCENES, tile_edge_scene

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


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 32, 37, 2048])
def test_fk_kernel_batch_sizes(cuda_problem, batch):
    """Four elements of 64 joint slots per block: ragged last blocks (1, 3,
    5, 37), whole ones (4, 32) and the IK path's 2048."""
    char, _, _, x0 = cuda_problem
    local = fk.local_skel_states(char.skeleton, char.parameter_transform.apply(x0))
    local = local.repeat(8, 1, 1)[:batch].contiguous()
    before = fk_ops.launches
    out = fk_ops.fk_global(char.skeleton, local)
    assert fk_ops.launches == before + 1
    torch.testing.assert_close(out, fk_ops.fk_global_plain(char.skeleton, local),
                               rtol=0, atol=2e-5)


def _random_local(nj, batch, seed):
    """Unit rotations, short offsets and scales near 1: a 1000-joint chain
    stays in range."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(batch, nj, 4, generator=g), dim=-1)
    t = 0.05 * torch.rand(batch, nj, 3, generator=g)
    s = 0.98 + 0.04 * torch.rand(batch, nj, 1, generator=g)
    return torch.cat([t, q, s], dim=-1).cuda()


@pytest.mark.parametrize("parents", [
    [-1] + list(range(225)),  # a 226-joint chain: 8 levels, one element per block
    [-1] + list(range(299)),  # 300 slots: two per thread
    [-1] + [j // 2 for j in range(1022)],  # 1023 joints, the most taken: four per thread
    [-1, 0, 1, -1, 3, 3, 0],  # two roots, eight slots: 32 elements per block
], ids=["chain226", "chain300", "tree1023", "two_roots"])
def test_fk_kernel_on_other_skeletons(cuda_device, parents):
    from momentum_tpu_torch.character import make_skeleton

    skel = make_skeleton(parents, device="cuda")
    local = _random_local(len(parents), 37, seed=len(parents))
    torch.testing.assert_close(fk_ops.fk_global(skel, local),
                               fk_ops.fk_global_plain(skel, local), rtol=0, atol=2e-5)


def test_fk_kernel_refuses_what_it_cannot_take(cuda_problem):
    from momentum_tpu_torch.character import make_skeleton

    char, _, _, x0 = cuda_problem
    local = fk.local_skel_states(char.skeleton, char.parameter_transform.apply(x0))
    with pytest.raises(ValueError):
        fk_ops.fk_global(char.skeleton, local.double())
    with pytest.raises(ValueError):
        fk_ops.fk_global(char.skeleton, local.transpose(0, 1))
    flat = torch.zeros(local.numel() + 1, device="cuda")
    with pytest.raises(ValueError):  # 4 bytes off a float4 boundary
        fk_ops.fk_global(char.skeleton, flat[1:].view(local.shape))
    big = make_skeleton([-1] + list(range(1023)), device="cuda")  # past the 1023-joint limit
    with pytest.raises(ValueError):
        fk_ops.fk_global(big, _random_local(1024, 2, seed=1))


def test_fk_kernel_gradients_match_plain(cuda_problem):
    """ROADMAP F8: FK through K1 is differentiable (its backward is the VJP
    of the plain lifted product), and the gradients of a seeded loss equal
    those of the plain path, up to the order of the index_select backward's
    atomic sums. The loss is quadratic in the FK output, so its cotangent
    carries K1's forward."""
    char, _, _, x0 = cuda_problem
    skel = char.skeleton
    g = torch.Generator(device="cpu").manual_seed(3)
    weight = torch.randn(64, skel.num_joints, 8, generator=g).cuda()
    grads = {}
    for name, fk_fn in (("kernel", fk_ops.fk_global), ("plain", fk_ops.fk_global_plain)):
        x = x0[:64].clone().requires_grad_()
        local = fk.local_skel_states(skel, char.parameter_transform.apply(x))
        before = fk_ops.launches
        out = fk_fn(skel, local)
        assert fk_ops.launches == before + (name == "kernel")
        (0.5 * (out * weight).square().sum()).backward()
        grads[name] = x.grad
    assert bool(torch.isfinite(grads["kernel"]).all())
    diff = (grads["kernel"] - grads["plain"]).abs().max() / grads["plain"].abs().max()
    assert float(diff) <= 1e-5
    x = x0[:4].clone().requires_grad_()
    out = fk.global_skel_states(skel, char.parameter_transform.apply(x))
    assert type(out.grad_fn).__name__ == "_FkGlobalBackward"


def test_fk_kernel_forward_mode_matches_plain(cuda_problem):
    """K1 under torch.func at B = 64 on the full-body rig: jacfwd (vmapped
    over the batch) and jvp vmapped over a batch of 5 tangents, through
    fk_global (the kernel for the primal, its jvp and vmap rules for the
    tangents) against the same through fk_global_plain."""
    char, _, _, x0 = cuda_problem
    skel, pt = char.skeleton, char.parameter_transform
    x = x0[:64].contiguous()

    def fk_of(fk_fn):
        return lambda th: fk_fn(skel, fk.local_skel_states(skel, pt.apply(th)))

    g = torch.Generator(device="cpu").manual_seed(5)
    tangents = torch.randn(5, *x.shape, generator=g).cuda()
    out = {}
    for name, fk_fn in (("kernel", fk_ops.fk_global), ("plain", fk_ops.fk_global_plain)):
        before = fk_ops.launches
        jac = torch.func.vmap(torch.func.jacfwd(fk_of(fk_fn)))(x)
        jvps = torch.func.vmap(lambda t: torch.func.jvp(fk_of(fk_fn), (x,), (t,)))(tangents)
        out[name] = (jac, *jvps)
        assert (fk_ops.launches > before) == (name == "kernel")
    assert out["kernel"][0].shape == (64, char.num_joints, 8, char.num_model_parameters)
    for k, p in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(k, p, rtol=1e-5, atol=2e-5)


def test_damped_solve_kernel_sequence_shape(cuda_problem):
    """K2+K3 at the full-body SPIKE forward step's shape: 32 systems of
    n = 156 with 470 right-hand sides, against the plain solve."""
    a, d, b = _spd(156, 32, seed=11)
    rhs = torch.randn(32, 156, 470, generator=torch.Generator(device="cpu").manual_seed(12))
    rhs = rhs.cuda()
    before = psd.launches
    x = psd.damped_chol_solve(a, d, rhs)
    assert psd.launches == before + 1
    x_plain = psd.damped_chol_solve_plain(a, d, rhs)
    ad = (a + torch.diag_embed(d)).double()
    res = (torch.linalg.norm(ad @ x.double() - rhs.double(), dim=-2)
           / torch.linalg.norm(rhs.double(), dim=-2))
    assert float(res.max()) <= 1e-5
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


def test_kernel_device_ms_is_none_for_a_kernel_it_did_not_see(cuda_problem):
    """The profiler's time of K2+K3 is positive; for a name no launch has
    it is None (not measured), not an error that would end chip_smoke.py."""
    from momentum_tpu_torch.testing.profile_workload import fmt_ms, kernel_device_ms

    a, d, b = _spd(157, 64, seed=13)
    ms = kernel_device_ms(lambda: psd.damped_chol_solve(a, d, b), "damped_chol_solve_kernel")
    assert ms is not None and ms > 0
    none = kernel_device_ms(lambda: psd.damped_chol_solve(a, d, b), "no_such_kernel")
    assert none is None and fmt_ms(none) == "not measured"


def test_config5_on_cuda_matches_cpu():
    """Config 5's sequence solve at F = 256 (SPIKE with 8 parts) on the card,
    through K1 and K2+K3, against the port on the CPU: the same iteration
    count, final errors within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    results = {}
    for device in ("cuda", "cpu"):
        prob = workloads.build_sequence_problem(256, device=device)
        fk_ops.launches = psd.launches = 0
        results[device] = workloads.make_sequence_solve(prob.fn)(prob.pf0, prob.u0)
        if device == "cuda":
            assert fk_ops.launches > 0 and psd.launches > 0
    gpu, cpu = results["cuda"], results["cpu"]
    assert gpu.iterations == cpu.iterations
    assert abs(float(gpu.error) / float(cpu.error) - 1) <= 1e-3
    assert bool(torch.isfinite(gpu.per_frame).all())


@pytest.mark.parametrize("n", [157, 40, 33, 1, 64, 224, 225, 300, 512])
def test_damped_solve_kernel_matches_plain(cuda_problem, n):
    """The rig's n = 157 (padded to 160 in shared memory), a ragged last panel
    of one row (33), one unknown, whole panels (64), the largest n that fits
    in shared memory (224), and the workspace form past it (225, 300, 512).
    At n = 157 only every fourth system's span starts 16-byte aligned, so the
    load's scalar head and tail run too."""
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


@pytest.mark.parametrize("pivot", [70, 150])
def test_damped_solve_kernel_nan_in_later_panels(cuda_problem, pivot):
    """ROADMAP F1 at n = 157: a pivot that fails in the third 32-wide panel
    (row 70) or in the ragged last one (row 150) gives that system an all-NaN
    x, in kernel and plain version alike; its neighbours stay finite."""
    a, damp, b = _spd(157, 5, seed=pivot)
    a[3, pivot, pivot] = -1e6
    for x in (psd.damped_chol_solve(a, damp, b), psd.damped_chol_solve_plain(a, damp, b)):
        assert torch.isnan(x[3]).all()
        assert torch.isfinite(x[[0, 1, 2, 4]]).all()


@pytest.mark.parametrize("n", [157, 300])
def test_damped_solve_kernel_nan_past_shared_memory(cuda_problem, n):
    """ROADMAP F1 in both forms, with three right-hand sides: a failed pivot
    in the last panel gives that system all-NaN columns; its neighbours'
    columns stay finite."""
    a, damp, b = _spd(n, 4, seed=n + 1)
    a[2, n - 3, n - 3] = -1e6
    b = torch.stack([b, -b, 2 * b], dim=-1)
    for x in (psd.damped_chol_solve(a, damp, b), psd.damped_chol_solve_plain(a, damp, b)):
        assert torch.isnan(x[2]).all()
        assert torch.isfinite(x[[0, 1, 3]]).all()


def test_damped_solve_kernel_refuses_what_it_cannot_take(cuda_problem):
    a, damp, b = _spd(16, 2, seed=1)
    with pytest.raises(ValueError):
        psd.damped_chol_solve(a.double(), damp.double(), b.double())
    with pytest.raises(ValueError):
        psd.damped_chol_solve(a.transpose(-1, -2).contiguous()[:, :, :8], damp, b)
    with pytest.raises(ValueError):  # b neither (B, n) nor (B, n, k)
        psd.damped_chol_solve(a, damp, b[..., None, None])
    n = psd.MAX_N + 1
    with pytest.raises(ValueError):
        psd.damped_chol_solve(torch.zeros(1, n, n, device="cuda"),
                              torch.ones(1, n, device="cuda"),
                              torch.ones(1, n, device="cuda"))


@pytest.mark.parametrize("case", ["n225", "n300", "float64", "matrix_rhs", "matrix_rhs_n300"])
@pytest.mark.parametrize("solve", ["damped_psd_solve", "psd_solve"])
def test_damped_solve_domain_rule(cuda_problem, case, solve):
    """ROADMAP F7: float32 systems past the kernel's shared memory (n = 225,
    300) and (B, n, k) right-hand sides launch damped_chol_solve_kernel once,
    as JAX gives them its TPU kernel, and solve to the plain solve's residual;
    float64 takes the plain solve on the card with no launch."""
    n = {"n225": 225, "n300": 300, "matrix_rhs_n300": 300}.get(case, 157)
    a, damp, b = _spd(n, 16, seed=n)
    if case == "float64":
        a, damp, b = a.double(), damp.double(), b.double()
    if case.startswith("matrix_rhs"):
        b = torch.stack([b, 2 * b + 1, -b], dim=-1)
    if solve == "psd_solve":
        a = a + torch.diag_embed(damp)
        damp = torch.zeros_like(damp)
    before = psd.launches
    x = (linalg.damped_psd_solve(a, damp, b) if solve == "damped_psd_solve"
         else linalg.psd_solve(a, b))
    kernel = case != "float64"
    assert psd.kernel_takes(a, b) == kernel
    assert psd.launches == before + kernel
    assert x.shape == b.shape and x.dtype == a.dtype and x.is_cuda
    x_plain = psd.damped_chol_solve_plain(a, damp, b)
    if kernel:
        assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3
    else:
        torch.testing.assert_close(x, x_plain, rtol=0, atol=0)
    cols = b[..., None] if b.ndim == 2 else b
    xs = x[..., None] if x.ndim == 2 else x
    for c in range(cols.shape[-1]):
        assert _relres(a, damp, cols[..., c], xs[..., c]) <= 1e-5


def test_main_path_on_cuda_matches_cpu(cuda_problem):
    """The whole compacted solve at B = 256 on the card against the same
    solve on the CPU (plain versions): the same convergence statistics."""
    char, ef0, targets, x0 = cuda_problem
    fk_ops.launches = psd.launches = 0
    res = workloads.make_solve_batch(char, ef0, 256)(targets, x0)
    assert fk_ops.launches > 0 and psd.launches > 0
    char_c, ef0_c, targets_c, x0_c = workloads.build_fullbody_ik_problem(256, seed=2,
                                                                           device="cpu")
    res_c = workloads.make_solve_batch(char_c, ef0_c, 256)(targets_c, x0_c)
    e, e_c = res.error.cpu().numpy(), res_c.error.numpy()
    assert np.all(np.isfinite(e))
    assert abs(np.mean(e < 1e-5) - np.mean(e_c < 1e-5)) <= 4 / 256
    assert abs(np.median(e) / np.median(e_c) - 1) <= 0.2


# ---- K5a / K5b: the entry points of ops/chol_pallas.py ----

def _relres(a, damp, b, x):
    ad = (a + torch.diag_embed(damp)).double()
    res = torch.linalg.norm((ad @ x.double()[..., None])[..., 0] - b.double(), dim=-1)
    return float((res / torch.linalg.norm(b.double(), dim=-1)).max())


@pytest.mark.parametrize("n", [160, 64, 40])
def test_chol_solve_reaches_the_rank1_kernel(cuda_problem, n):
    """K5a's entry point launches damped_chol_solve_kernel (any n ≤ MAX_N)."""
    a, damp, b = _spd(n, 64, seed=10 + n)
    before = psd.launches
    x = chol.chol_solve(a, damp, b)
    assert psd.launches == before + 1
    assert _relres(a, damp, b, x) <= 1e-5
    x_plain = chol.chol_solve_plain(a, damp, b)
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


@pytest.mark.parametrize("n,batch", [(160, 300), (224, 8), (32, 5), (64, 1), (256, 4)])
def test_chol_blocked_kernel_matches_plain(cuda_problem, n, batch):
    """K5b's entry point launches damped_chol_solve_kernel: relative residual
    as small as the plain solve's, x within 1e-3 of max|x| (FMA contraction
    and the panel order round differently; ROADMAP F5)."""
    a, damp, b = _spd(n, batch, seed=n)
    before = psd.launches
    x = chol.chol_solve_blocked(a, damp, b)
    assert psd.launches == before + 1
    x_plain = chol.chol_solve_blocked_plain(a, damp, b)
    assert _relres(a, damp, b, x) <= max(1e-5, 10 * _relres(a, damp, b, x_plain))
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


def test_chol_blocked_kernel_padded_system(cuda_problem):
    """n = 157 padded to 160 with identity rows: the unpadded solution."""
    a, damp, b = _spd(157, 32, seed=3)
    x = chol.chol_solve_blocked(*chol.pad_identity(a, damp, b))
    assert (x[:, 157:] == 0).all()
    assert _relres(a, damp, b, x[:, :157].contiguous()) <= 1e-5


def test_chol_kernels_nan_on_indefinite(cuda_problem):
    """ROADMAP F1 in both K5 kernels: all-NaN x for a failed pivot, in the
    first panel or a later one; the other systems are unaffected."""
    a, damp, b = _spd(96, 4, seed=6)
    a[1, 10, 10] = -1e5
    a[3, 70, 70] = -1e5
    for solve in (chol.chol_solve, chol.chol_solve_blocked, chol.chol_solve_blocked_plain):
        x = solve(a, damp, b)
        assert torch.isnan(x[1]).all() and torch.isnan(x[3]).all()
        assert torch.isfinite(x[0]).all() and torch.isfinite(x[2]).all()


def test_chol_blocked_kernel_refuses_what_it_cannot_take(cuda_problem):
    a, damp, b = _spd(32, 2, seed=1)
    before = psd.launches
    with pytest.raises(ValueError, match="multiple of 32"):  # ROADMAP F6
        chol.chol_solve_blocked(*_spd(157, 2, seed=1))
    with pytest.raises(ValueError):
        chol.chol_solve_blocked(a.double(), damp.double(), b.double())
    with pytest.raises(ValueError):
        chol.chol_solve_blocked(a.transpose(-1, -2), damp, b)
    with pytest.raises(ValueError):
        chol.chol_solve_blocked(a, damp.cpu(), b)
    with pytest.raises(RuntimeError):
        chol.chol_solve_blocked(a.clone().requires_grad_(), damp, b)
    n = -(-(psd.MAX_N + 1) // chol.PANEL) * chol.PANEL  # past the kernel's n, in panels
    with pytest.raises(ValueError):
        chol.chol_solve_blocked(torch.zeros(1, n, n, device="cuda"),
                                torch.ones(1, n, device="cuda"), torch.ones(1, n, device="cuda"))
    assert psd.launches == before


def test_fullstack_on_cuda_matches_cpu(cuda_problem):
    """bench.py's full-stack solve at B = 64 on the card (K1, K2+K3) against
    the same solve on the CPU (plain versions)."""
    stats = {}
    for device in ("cuda", "cpu"):
        char, efs, targets, q, x0 = workloads.build_fullstack_problem(64, seed=0,
                                                                      device=device)
        fk_ops.launches = psd.launches = 0
        params, e, _ = workloads.make_fullstack_solve(char, efs, 64)(targets, q, x0)
        if device == "cuda":
            assert fk_ops.launches > 0 and psd.launches > 0
            assert bool(torch.isfinite(params).all())
        stats[device] = e.cpu().numpy()
    e, e_c = stats["cuda"], stats["cpu"]
    assert np.all(np.isfinite(e))
    assert abs(np.mean(e < 1e-5) - np.mean(e_c < 1e-5)) <= 2 / 64
    assert abs(np.median(e) / np.median(e_c) - 1) <= 0.2


# ---- configs 2 and 4: LM on the normal equations, the skinned-vertex fit ----

@pytest.mark.parametrize("batch,n", [(256, 165), (64, 165), (1, 165), (1, 157)])
def test_damped_solve_kernel_at_the_configs_shapes(cuda_problem, batch, n):
    """K2+K3 at config 4b's n = 165 (padded to 192 in shared memory) at its
    batch 256 and compacted 64, and on the single systems (B = 1) of
    config 4's and config 2's frame solves, which math/linalg.py passes
    unbatched: against the plain version, one launch each."""
    a, damp, b = _spd(n, batch, seed=batch + n)
    if batch == 1:
        a, damp, b = a[0], damp[0], b[0]  # (n, n): linalg flattens it to B = 1
    before = psd.launches
    x = linalg.damped_psd_solve(a, damp, b)
    assert psd.launches == before + 1 and x.shape == b.shape
    assert _relres(a.reshape(-1, n, n), damp.reshape(-1, n), b.reshape(-1, n),
                   x.reshape(-1, n)) <= 1e-5
    x_plain = psd.damped_chol_solve_plain(a.reshape(-1, n, n), damp.reshape(-1, n),
                                          b.reshape(-1, n)).reshape(b.shape)
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


@pytest.fixture(scope="module")
def vertex_problems():
    """Config 4 at B = 16 on the card and on the CPU, from the same seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {d: workloads.build_vertex_fit_problem(16, device=d) for d in ("cuda", "cpu")}


def test_vertex_context_and_jacobian_on_cuda_match_cpu(vertex_problems):
    """The mesh context and the vertex rows and model-space Jacobian on the
    card (K1, skinning, normals by atomics) against the same code on the
    CPU: 1e-5 abs (plus 1e-5 of the largest entry) on vertices, rows and
    Jacobian, 5e-4 on the normals (an H100 gave 1.7e-4 at 1e-4, where this
    test failed: the vertices' last-bit differences between the devices
    grow through cross products of 0.04-long edges and the normalization)."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    out = {}
    for device, prob in vertex_problems.items():
        fn = SkeletonSolverFunction(prob.char,
                                    (dataclasses.replace(prob.ef0, target=prob.targets),))
        before = fk_ops.launches
        ctx = fn.context(prob.x0)
        assert fk_ops.launches == before + (device == "cuda")
        rows, j = fn.residual_and_jacobian(prob.x0)
        out[device] = [t.cpu() for t in (ctx.rest_vertices, ctx.mesh_vertices,
                                         ctx.mesh_normals, rows, j)]
    for name, g, c in zip(("rest", "vertices", "normals", "rows", "jacobian"),
                          out["cuda"], out["cpu"]):
        diff = float((g - c).abs().max())
        assert diff <= (5e-4 if name == "normals" else 1e-5) + 1e-5 * float(c.abs().max()), \
            f"{name}: max|card - cpu| {diff:.3e}"


def test_vertex_fit_on_cuda_launches_and_matches_cpu(vertex_problems):
    """Config 4b's path at B = 16 (GN 4 + 2 on the worst 4) runs through K1
    and K2+K3 on the card, and ends with the CPU's statistics:
    median_param_sq_err within a factor 1.5, nothing divergent; the single
    frame's LM energy within 1e-2."""
    sq, frame = {}, {}
    for device, prob in vertex_problems.items():
        fk_ops.launches = psd.launches = 0
        res = workloads.make_vertex_fit_solve(prob.char, prob.ef0, 16)(prob.targets, prob.x0)
        if device == "cuda":
            assert fk_ops.launches > 0 and psd.launches == res.iterations == 6
        sq[device] = ((res.params - prob.gt) ** 2).sum(-1).cpu().numpy()
        psd.launches = 0
        fr = workloads.solve_vertex_fit_frame(prob.char, prob.ef0, prob.targets_frame,
                                              torch.zeros_like(prob.gt_frame))
        assert psd.launches == (fr.iterations if device == "cuda" else 0)
        frame[device] = float(fr.error)
    assert np.isfinite(sq["cuda"]).all()
    assert 1 / 1.5 <= np.median(sq["cuda"]) / np.median(sq["cpu"]) <= 1.5
    assert abs(frame["cuda"] / frame["cpu"] - 1) <= 1e-2


def test_config2_lm_on_cuda_launches_and_matches_cpu(cuda_problem):
    """Config 2's single frame by LM on the normal equations (one system an
    iteration through K2+K3), and the 40-iteration optimum at B = 16, on the
    card against the CPU: energies within 1e-2 and 1e-3."""
    energies = {}
    for device in ("cuda", "cpu"):
        char, efs, x0 = workloads.build_fullstack_frame(device=device)
        fk_ops.launches = psd.launches = 0
        res = workloads.solve_fullstack_frame(char, efs, x0)
        if device == "cuda":
            assert psd.launches == res.iterations and fk_ops.launches > res.iterations
        char, efs, targets, q, x0 = workloads.build_fullstack_problem(16, device=device)
        ref = workloads.fullstack_lm_optimum(char, efs, targets, q, x0)
        energies[device] = (float(res.error), ref.error.cpu().numpy())
    (fg, rg), (fc, rc) = energies["cuda"], energies["cpu"]
    assert abs(fg / fc - 1) <= 1e-2
    np.testing.assert_allclose(rg, rc, rtol=1e-3)


# ---- K4a / K4b: the plane rasterizer ----

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _scene(seed, v, f, w, h, n_vattr=2, n_fattr=3):
    """tests/test_raster_pallas.py's random scene, with attributes."""
    rng = np.random.default_rng(seed)
    verts = np.zeros((v, 3), np.float32)
    verts[:, 0] = rng.uniform(-10, w + 10, v)
    verts[:, 1] = rng.uniform(-5, h + 5, v)
    verts[:, 2] = rng.uniform(0.5, 5.0, v)
    faces = rng.integers(0, v, (f, 3)).astype(np.int32)
    kw = dict(vertex_attrs=rng.normal(size=(v, n_vattr)).astype(np.float32) if n_vattr else None,
              face_attrs=rng.normal(size=(f, n_fattr)).astype(np.float32) if n_fattr else None)
    return verts, faces, w, h, kw


def _on(device, verts, faces, kw):
    return (torch.as_tensor(verts, device=device), torch.as_tensor(faces, device=device),
            {k: None if a is None else torch.as_tensor(a, device=device) for k, a in kw.items()})


def _kernel_vs_plain(verts, faces, w, h, kw, **opts):
    """Run the wrapper (a kernel) and the plain version on the card; the
    face maps must be identical (the same plane arithmetic), depth and
    barycentrics within 1e-5, attributes within 1e-4. Returns the kernel's
    output and the name of the kernel it launched."""
    v, f, a = _on("cuda", verts, faces, kw)
    before = dict(raster.launches)
    out = raster.rasterize_planes(v, f, w, h, **a, **opts)
    ref = raster.rasterize_planes_plain(v, f, w, h, **a, **opts)
    torch.cuda.synchronize()
    launched = [k for k in raster.launches if raster.launches[k] != before[k]]
    assert len(launched) == 1 and raster.launches[launched[0]] == before[launched[0]] + 1
    assert torch.equal(out["face"], ref["face"])
    hit = ref["face"] >= 0
    assert torch.isinf(out["depth"][~hit]).all()
    torch.testing.assert_close(out["depth"][hit], ref["depth"][hit], rtol=0, atol=1e-5)
    for key, tol in (("bary", 1e-5), ("attrs", 1e-4)):
        assert (key in out) == (key in ref)
        if key in out:
            torch.testing.assert_close(out[key], ref[key], rtol=0, atol=tol)
    return out, launched[0]


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raster_kernels_match_plain_on_random_scenes(cuda_device, cull, seed):
    verts, faces, w, h, kw = _scene(seed, 400, 300, 640, 200)
    out, name = _kernel_vs_plain(verts, faces, w, h, kw, cull=cull)
    assert name == ("raster_planes_binned_kernel" if cull else "raster_planes_kernel")
    assert (out["face"] >= 0).float().mean() > 0.2


@pytest.mark.parametrize("opts", [dict(cull=False), dict(cull=True),
                                  dict(cull=True, bin_capacity=8)],
                         ids=["K4a", "K4b", "K4b_overflow"])
def test_raster_kernels_more_attributes_than_staged(cuda_device, opts):
    """Ten attributes (6 vertex + 4 face), more than the epilogue stages in
    shared memory (kOutChannels = 8), so each thread stores its own pixel's:
    K4a, K4b's binned tiles and its overflow tiles' merged pixels."""
    verts, faces, w, h, kw = _scene(4, 400, 300, 640, 200, n_vattr=6, n_fattr=4)
    out, name = _kernel_vs_plain(verts, faces, w, h, kw, **opts)
    assert name == ("raster_planes_binned_kernel" if opts["cull"] else "raster_planes_kernel")
    assert out["attrs"].shape == (h, w, 10)
    if "bin_capacity" in opts:
        v, f, _ = _on("cuda", verts, faces, kw)
        assert int(raster.bin_faces(v, f, 320, w, h, 8, 8)[1].sum()) > 0


def test_raster_binned_kernel_overflow_tiles(cuda_device):
    """tests/test_raster_pallas.py's culled case: bin_capacity 8 sends tiles
    to the full scan, chunk 16 pads the face table."""
    verts, faces, w, h, kw = _scene(7, 80, 70, 256, 40, n_fattr=1)
    v, f, _ = _on("cuda", verts, faces, kw)
    _, overflow = raster.bin_faces(v, f, 80, w, h, 8, 8)
    assert int(overflow.sum()) > 0
    for cap in (8, 45):  # all tiles overflow / some do
        _kernel_vs_plain(verts, faces, w, h, kw, cull=True, chunk=16, th=8, bin_capacity=cap)
    # binned and unbinned kernels agree exactly too
    a = raster.rasterize_planes(*_on("cuda", verts, faces, kw)[:2], w, h, cull=True, th=8,
                                chunk=16, bin_capacity=45)
    b = raster.rasterize_planes(*_on("cuda", verts, faces, kw)[:2], w, h, cull=False)
    assert torch.equal(a["face"], b["face"]) and torch.equal(a["depth"], b["depth"])


@pytest.fixture(scope="module")
def clip_frames(cuda_device):
    """Config 7's clip on the card: per frame, the camera and shadow passes
    of render_mesh_shadowed (`render.shadowed_passes`)."""
    from momentum_tpu_torch.rasterizer import render

    char, motion, cam = workloads.build_render_clip(32, seed=0, device="cuda")
    verts = workloads.clip_vertices(char, motion)

    def frame(i):
        return render.shadowed_passes(cam, verts[i], char.mesh.faces, 1280, 960)

    return char.mesh.faces, frame


@pytest.mark.parametrize("frame,pass_,overflow", [
    (0, "camera", 1), (5, "camera", 0), (10, "camera", 2), (11, "shadow", 1), (5, "shadow", 0)])
def test_raster_binned_kernel_on_clip_frames(clip_frames, frame, pass_, overflow):
    """K4b on the clip's passes with and without overflow tiles: the overflow
    tile's chunk blocks merge to the plain version's face map exactly."""
    faces, get = clip_frames
    sv, w, h, kw = get(frame)[pass_]
    _, ovf = raster.bin_faces(sv, faces, 640, w, h, 8, 128)
    assert int(ovf.sum()) == overflow
    _, name = _kernel_vs_plain(sv, faces, w, h, kw)
    assert name == "raster_planes_binned_kernel"


def test_raster_binned_kernel_many_overflow_tiles(clip_frames):
    """bin_capacity 8: 77 of the 1200 tiles of frame 0's camera pass
    overflow, each scanned by five chunk blocks, 8 consecutive tiles
    sharing one set of them."""
    faces, get = clip_frames
    sv, w, h, kw = get(0)["camera"]
    _, ovf = raster.bin_faces(sv, faces, 640, w, h, 8, 8)
    assert int(ovf.sum()) == 77
    _kernel_vs_plain(sv, faces, w, h, kw, bin_capacity=8)


def test_raster_binned_kernel_across_streams(clip_frames):
    """K4b's merge scratch is one per device: overflow passes launched on
    a side stream and then on the default stream, with no synchronization
    between them, each give the plain version's face map."""
    faces, get = clip_frames
    sv, w, h, kw = get(0)["camera"]
    ref = raster.rasterize_planes_plain(sv, faces, w, h, bin_capacity=8, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
    b = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(a["face"], ref["face"]) and torch.equal(b["face"], ref["face"])
    assert list(raster._scratch) == [sv.device]


def test_raster_binned_scratch_grows_after_a_side_stream_launch(clip_frames):
    """ROADMAP F9: a side stream launches K4b with the merge scratch of a
    small pass (allocated on the default stream), then a larger pass on the
    same stream grows the scratch and frees the small pair while the side
    stream's launch still waits behind a sleep. The default stream then
    allocates and zeroes memory of the small keys' size at once: were the
    freed keys among it, the side stream's launch would merge into zeros.
    Each stream's face maps must be the plain version's."""
    faces, get = clip_frames
    passes = get(0)
    refs = {name: raster.rasterize_planes_plain(sv, faces, w, h, bin_capacity=8, **kw)["face"]
            for name, (sv, w, h, kw) in ((k, passes[k]) for k in ("camera", "shadow"))}
    sv, w, h, kw = passes["shadow"]
    svl, wl, hl, kwl = passes["camera"]
    assert int(raster.bin_faces(sv, faces, 640, w, h, 8, 8)[1].sum()) > 0  # keys are merged
    torch.cuda.synchronize()
    raster._scratch.clear()
    raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)  # small pair, default stream
    small_keys = raster._scratch[sv.device][0]
    n_keys, old_ptr = small_keys.numel(), small_keys.data_ptr()
    del small_keys
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s: the host queues all below first
        a = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
        b = raster.rasterize_planes(svl, faces, wl, hl, bin_capacity=8, **kwl)  # grows it
    assert raster._scratch[sv.device][0].numel() > n_keys
    reused = []
    for _ in range(64):  # until the allocator hands out the freed keys, if it does
        reused.append(torch.zeros(n_keys, dtype=torch.int64, device="cuda"))
        if reused[-1].data_ptr() == old_ptr:
            break
    c = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(a["face"], refs["shadow"]) and torch.equal(b["face"], refs["camera"])
    assert torch.equal(c["face"], refs["shadow"])


@pytest.mark.parametrize("th", [4, 8])
@pytest.mark.parametrize("name", TILE_EDGE_SCENES)
def test_raster_kernel_tile_reject_on_edge_scenes(cuda_device, name, th):
    """K4a's per-tile reject on faces whose edges pass exactly through
    tile-corner pixel centres, faces across tile borders and depths crossing
    0 inside a tile: the face maps are identical to the plain version's, and
    the plain reject (`tile_face_may_cover`) drops most (tile, face) pairs
    here, so the kernel's reject is exercised."""
    verts, faces, w, h = tile_edge_scene(name)
    rng = np.random.default_rng(th)
    kw = dict(vertex_attrs=rng.normal(size=(verts.shape[0], 2)).astype(np.float32))
    out, kernel = _kernel_vs_plain(verts, faces, w, h, kw, cull=False, th=th)
    assert kernel == "raster_planes_kernel" and bool((out["face"] >= 0).any())
    planes = raster._tables(torch.as_tensor(verts, device="cuda"),
                            torch.as_tensor(faces, device="cuda"), None, None, None, 128)[0]
    may = raster.tile_face_may_cover(planes, w, h, th)[:, :faces.shape[0]]
    assert int((~may).sum()) > int(may.sum()) // 2


@pytest.mark.parametrize("bin_capacity", [8, 384])
def test_raster_binned_kernel_cross_chunk_ties(cuda_device, bin_capacity):
    """tests/test_torch_port_render.py's scene of faces duplicated across the
    128-row chunk boundaries: the lower id wins the tie on the card too."""
    verts = np.zeros((126, 3), np.float32)
    rng = np.random.default_rng(11)
    verts[:120, 0] = rng.uniform(-10, 266, 120)
    verts[:120, 1] = rng.uniform(-5, 45, 120)
    verts[:120, 2] = rng.uniform(0.5, 5.0, 120)
    faces = rng.integers(0, 120, (300, 3)).astype(np.int32)
    verts[120:] = [[10, -5, 0.3], [120, -5, 0.3], [10, 60, 0.3],
                   [140, 2, 0.4], [250, 2, 0.4], [200, 45, 0.4]]
    faces[20] = faces[150] = [120, 121, 122]
    faces[140] = faces[260] = [123, 124, 125]
    out, _ = _kernel_vs_plain(verts, faces, 256, 40, {}, cull=True, th=8,
                              bin_capacity=bin_capacity)
    face = out["face"]
    assert int((face == 20).sum()) > 1000 and int((face == 140).sum()) > 1000
    assert not bool(torch.isin(face, torch.tensor([150, 260], device="cuda")).any())


def test_raster_kernels_nonfinite_screen_vertices(cuda_device):
    """Grazing projections give inf/NaN screen coordinates: their faces
    never win, and no NaN reaches a covered pixel (test_raster_pallas.py:128)."""
    rng = np.random.default_rng(7)
    v = rng.uniform(4, 60, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (200, 3)).astype(np.int32)
    v[5] = [np.inf, np.inf, 3.0]
    v[17] = [np.nan, 1e4, 2.0]
    v[42] = [1e12, -1e12, 5.0]
    kw = dict(vertex_attrs=rng.normal(0, 1, (300, 3)).astype(np.float32))
    bad = np.unique(np.where(np.isin(faces, [5, 17, 42]).any(1))[0])
    for cull in (True, False):
        out, _ = _kernel_vs_plain(v, faces, 128, 64, kw, cull=cull)
        face = out["face"].cpu().numpy()
        cov = face >= 0
        assert cov.any()
        assert np.isfinite(out["attrs"].cpu().numpy()[cov]).all()
        assert not np.isin(face[cov], bad).any()


@pytest.mark.parametrize("th", [4, 8])
@pytest.mark.parametrize("cull", [False, True])
def test_raster_kernels_ragged_images(cuda_device, th, cull):
    verts, faces, w, h, kw = _scene(3, 40, 24, 100, 6)
    out, _ = _kernel_vs_plain(verts, faces, w, h, kw, cull=cull, th=th, bin_capacity=8)
    assert out["face"].shape == (6, 100) and out["attrs"].shape == (6, 100, 5)
    behind = verts.copy()
    behind[:, 2] = -1.0
    empty, _ = _kernel_vs_plain(behind, faces, w, h, kw, cull=cull, th=th)
    assert (empty["face"] == -1).all() and torch.isinf(empty["depth"]).all()
    assert (empty["attrs"] == 0).all() and (empty["bary"] == 0).all()


def test_raster_kernels_refuse_what_they_cannot_take(cuda_device):
    verts, faces, w, h, kw = _scene(0, 40, 24, 128, 8)
    v, f, a = _on("cuda", verts, faces, kw)
    with pytest.raises(ValueError):
        raster.rasterize_planes(v.double(), f, w, h)
    with pytest.raises(ValueError):
        raster.rasterize_planes(torch.cat([v, v], 1)[:, ::2], f, w, h)  # not contiguous
    with pytest.raises(ValueError):
        raster.rasterize_planes(v, f, w, h, vertex_attrs=a["vertex_attrs"].double())
    with pytest.raises(ValueError):
        raster.rasterize_planes(v, f.cpu(), w, h)
    with pytest.raises(ValueError):
        raster.rasterize_planes(v, f, w, h, th=3)
    with pytest.raises(RuntimeError):
        raster.rasterize_planes(v.clone().requires_grad_(), f, w, h)


@pytest.fixture(scope="module")
def tracking_clip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return workloads.build_tracking_clip(16, seed=0, device="cuda")


@pytest.mark.parametrize("batch", [1, 16])
def test_ad_jacobian_through_k1_matches_plain(tracking_clip, batch):
    """The forward-mode Jacobian of config 6s's marker rows on the card,
    FK through K1 (launched for the primal), against the same with FK on
    the plain version (K1 replaced by fk_global_plain) and against the
    analytic Jacobian."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian
    from momentum_tpu_torch.tracking import TrackingConfig
    from momentum_tpu_torch.tracking.tracker import _marker_error_template

    char, markers = tracking_clip.char, tracking_clip.markers
    ef0, per_frame = _marker_error_template(char, markers, TrackingConfig())
    x = tracking_clip.truth[:batch] if batch > 1 else tracking_clip.truth[0]
    pos, occ = (markers.positions[:batch], markers.occluded[:batch]) if batch > 1 else (
        markers.positions[0], markers.occluded[0])
    fn = SkeletonSolverFunction(char, (per_frame(ef0, pos, occ),))
    before = fk_ops.launches
    rows, jt = ad_jacobian(fn.residual, x)
    assert fk_ops.launches > before
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        rows_p, jt_p = ad_jacobian(fn.residual, x)
    finally:
        fk_ops._fk_global_kernel = real
    scale = float(jt_p.abs().max())
    # the rows differ by the rounding of world positions ~2 m from the origin
    # (mm units): K1 and the plain FK compose in float32, each to its own ulp
    torch.testing.assert_close(rows, rows_p, rtol=0,
                               atol=1e-6 * float(markers.positions.abs().max()))
    torch.testing.assert_close(jt, jt_p, rtol=0, atol=1e-5 * scale)
    _, jac = fn.residual_and_jacobian(x)
    torch.testing.assert_close(jt.transpose(-1, -2), jac, rtol=0, atol=1e-4 * scale)


def test_per_frame_tracking_on_the_card_matches_the_cpu(tracking_clip):
    """16 frames of config 6s's per-frame tracking (LM 15, warm-started
    from the first frame's true pose, AD Jacobians through K1, steps
    through K2+K3) on the card against the same on the CPU: the medians of
    the per-frame energies and of the marker errors. Single frames are not
    compared: a frame whose LM stops in another valley under a 1e-6
    perturbation of the start (frame 10: energy 609.6 or 221.8 on the CPU)
    does so between the card and the CPU too."""
    from momentum_tpu_torch.tracking import MarkerSequence, create_cmu_character

    clip = tracking_clip
    cpu_char = create_cmu_character(device="cpu")
    cpu_markers = MarkerSequence(clip.markers.positions.cpu(), clip.markers.occluded.cpu(),
                                 clip.markers.names)
    before = (fk_ops.launches, psd.launches)
    card = workloads.track_clip_per_frame(clip.char, clip.markers, clip.truth[0])
    assert fk_ops.launches > before[0] and psd.launches > before[1]
    cpu = workloads.track_clip_per_frame(cpu_char, cpu_markers, clip.truth[0].cpu())
    e_card, e_cpu = float(card.errors.median()), float(cpu.errors.median())
    assert abs(e_card - e_cpu) <= 1e-2 * e_cpu
    d_card = workloads.clip_marker_errors_mm(clip.char, clip.markers, card.motion)
    d_cpu = workloads.clip_marker_errors_mm(cpu_char, cpu_markers, cpu.motion)
    assert abs(np.median(d_card) - np.median(d_cpu)) <= 0.02 * np.median(d_cpu)


@pytest.fixture(scope="module")
def catalog_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return (workloads.build_catalog_ik_problem(64, seed=0, device="cuda"),
            workloads.build_catalog_ik_problem(64, seed=0, device="cpu"))


def test_catalog_ik_on_the_card_matches_the_cpu(catalog_problems):
    """Config C at B = 64 (every rigid module of the catalog, LM 10) on the
    card, K1 and K2+K3 launched, against the same on the CPU's plain path:
    each module's median final energy within 20% as chip_smoke.py holds it
    against JAX CPU's (or under 1e-8 of the total, float32 roundoff of a
    converged term), and the elements' total energies at a median relative
    difference under 1e-3."""
    card, cpu = catalog_problems
    before = (fk_ops.launches, psd.launches)
    res_card = workloads.solve_catalog(card)
    assert fk_ops.launches > before[0] and psd.launches > before[1]
    res_cpu = workloads.solve_catalog(cpu)
    e_card = {k: v.cpu().numpy() for k, v in workloads.catalog_energies(
        card, res_card.params).items()}
    e_cpu = {k: v.numpy() for k, v in workloads.catalog_energies(cpu, res_cpu.params).items()}
    floor = 1e-8 * float(np.median(e_cpu["total"]))
    for k in e_cpu:
        a, b = float(np.median(e_card[k])), float(np.median(e_cpu[k]))
        assert abs(a - b) <= 0.2 * b + floor, (k, a, b)
    rel = np.abs(e_card["total"] - e_cpu["total"]) / e_cpu["total"]
    assert float(np.median(rel)) <= 1e-3
    assert bool(torch.isfinite(res_card.params).all())


def test_camera_projection_rows_through_k1_match_plain(catalog_problems):
    """The forward-mode Jacobian of config C's CameraProjection rows (the
    OpenCV and the fisheye camera) at B = 64, FK's primal through K1, against
    the same with FK on the plain version."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

    card, _ = catalog_problems
    mods = tuple(ef for label, ef in card.modules if label.startswith("camera_"))
    fn = SkeletonSolverFunction(card.char, mods)
    before = fk_ops.launches
    rows, jt = ad_jacobian(fn.residual, card.x0)
    assert fk_ops.launches > before
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        rows_p, jt_p = ad_jacobian(fn.residual, card.x0)
    finally:
        fk_ops._fk_global_kernel = real
    torch.testing.assert_close(rows, rows_p, rtol=0, atol=1e-5 * float(rows_p.abs().max()))
    torch.testing.assert_close(jt, jt_p, rtol=0, atol=1e-5 * float(jt_p.abs().max()))
