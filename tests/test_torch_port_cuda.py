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


def test_fk_kernel_on_a_loaded_rig(cuda_problem):
    """FK of the rig written to .glb and loaded onto the card through K1:
    the plain version's states, and the in-memory rig's, at 2e-5."""
    from momentum_tpu_torch.io.gltf import _character_glb_bytes, load_character_glb

    char, _, _, x0 = cuda_problem
    loaded, motion, _ = load_character_glb(_character_glb_bytes(char, motion=x0[:64]))
    assert loaded.skeleton.joint_parent.device.type == "cuda" and motion.is_cuda
    local = fk.local_skel_states(loaded.skeleton, loaded.parameter_transform.apply(motion))
    before = fk_ops.launches
    out = fk_ops.fk_global(loaded.skeleton, local.contiguous())
    assert fk_ops.launches == before + 1
    torch.testing.assert_close(out, fk_ops.fk_global_plain(loaded.skeleton, local),
                               rtol=0, atol=2e-5)
    torch.testing.assert_close(out, char.skeleton_states(x0[:64]), rtol=0, atol=2e-5)


def test_fbx_load_inverse_bind_pose_through_k1(cuda_problem, tmp_path):
    """An FBX of the skinned test rig loaded onto the card: the inverse bind
    pose comes from FK through K1 (one launch in the load), equal to the
    CPU load's (the plain version) and the written rig's at 2e-5."""
    from momentum_tpu_torch.io import fbx, fbx_writer
    from momentum_tpu_torch.testing import fixtures

    char = fixtures.create_test_character(5, device="cuda")
    fbx_writer.save_fbx_model(str(tmp_path / "rig.fbx"), char)
    before = fk_ops.launches
    loaded = fbx.load_fbx(str(tmp_path / "rig.fbx"))
    assert fk_ops.launches >= before + 1
    assert loaded.inverse_bind_pose.is_cuda and loaded.skin_weights.index.is_cuda
    on_cpu = fbx.load_fbx(str(tmp_path / "rig.fbx"), device="cpu")
    torch.testing.assert_close(loaded.inverse_bind_pose.cpu(), on_cpu.inverse_bind_pose,
                               rtol=0, atol=2e-5)
    torch.testing.assert_close(loaded.inverse_bind_pose,
                               char.with_inverse_bind_pose().inverse_bind_pose, rtol=0, atol=2e-5)


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


KC = 32  # csrc/psd.cu kCols: right-hand-side columns a substitution block owns
# chip_smoke.py's hold of a matrix right-hand side (_hold_psd_matrix)
X_FWD_FACTOR, PSD_RELRES_TOL, PSD_X_TOL = 10.0, 1e-5, 1e-3


def _matrix_rhs(batch, n, k, seed):
    a, d, _ = _spd(n, batch, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    return a, d, torch.randn(batch, n, k, generator=g).cuda()


def _hold_matrix_rhs(a, d, b):
    """One launch of K2+K3's matrix form, held as chip_smoke.py holds it:
    the largest per-column relative residual and the forward error against
    the float64 solve each within X_FWD_FACTOR of the plain float32 solve's,
    at least PSD_RELRES_TOL and PSD_X_TOL."""
    before = psd.launches
    x = psd.damped_chol_solve(a, d, b)
    assert psd.launches == before + 1 and x.shape == b.shape
    x_plain = psd.damped_chol_solve_plain(a, d, b)
    x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
    ad = (a + torch.diag_embed(d)).double()

    def relres(sol):
        r = torch.linalg.norm(ad @ sol.double() - b.double(), dim=-2)
        return float((r / torch.linalg.norm(b.double(), dim=-2)).max())

    def fwd(sol):
        return float((sol.double() - x64).abs().max() / x64.abs().max())

    assert relres(x) <= max(PSD_RELRES_TOL, X_FWD_FACTOR * relres(x_plain))
    assert fwd(x) <= max(PSD_X_TOL, X_FWD_FACTOR * fwd(x_plain))


@pytest.mark.parametrize("batch, n, k", [(32, 23, 70), (32, 156, 470), (16, 156, 782),
                                         (10, 169, 508)])
def test_matrix_rhs_at_the_spike_shapes(cuda_problem, batch, n, k):
    """The factor and damped_chol_subst_kernel at the sequence paths' SPIKE
    shapes (configs 5 and 5c, 5f, a rank of 5fs, G): one launch a call, held
    by the smoke's rule."""
    _hold_matrix_rhs(*_matrix_rhs(batch, n, k, seed=n + k))


@pytest.mark.parametrize("k", [KC - 1, KC, KC + 1, 2 * KC + 1])
def test_matrix_rhs_tile_edges(cuda_problem, k):
    """Column tiles of KC: one ragged tile, one whole, a whole one and a
    one-column tile, two whole and a one-column tile; n = 40, a ragged
    last panel."""
    _hold_matrix_rhs(*_matrix_rhs(8, 40, k, seed=k))


@pytest.mark.parametrize("n", [225, 300, 1600])
@pytest.mark.parametrize("k", [3, 100])
def test_matrix_rhs_workspace_form(cuda_problem, n, k):
    """Past n = 224 the factor stays in the workspace it was factored in
    (rows of m + 1 floats, the substitution's scalar loads); past m = 1536
    the substitution's tile is 8 columns wide."""
    _hold_matrix_rhs(*_matrix_rhs(2 if n > 1000 else 4, n, k, seed=n * k))


@pytest.mark.parametrize("n, pivot", [(157, 100), (300, 40)])
def test_matrix_rhs_nan_on_failed_pivot(cuda_problem, n, pivot):
    """ROADMAP F1 in the matrix form: a pivot that fails (the fourth panel at
    n = 157, the second in the workspace form) gives all 40 columns (two
    tiles) of that system NaN, and its neighbours' columns stay finite, in
    kernel and plain version alike."""
    a, d, b = _matrix_rhs(5, n, 40, seed=pivot)
    a[3, pivot, pivot] = -1e6
    for x in (psd.damped_chol_solve(a, d, b), psd.damped_chol_solve_plain(a, d, b)):
        assert torch.isnan(x[3]).all()
        assert torch.isfinite(x[[0, 1, 2, 4]]).all()


def test_kernel_device_ms_sums_both_kernels_of_a_call(cuda_problem):
    """A matrix right-hand side launches the factor and the substitution:
    kernel_device_ms over psd.KERNELS, two a call, is the sum of the two
    kernels' own times (within the profiler's spread), more than either; a
    vector right-hand side launches the first alone."""
    from momentum_tpu_torch.testing.profile_workload import kernel_device_ms

    a, d, b = _matrix_rhs(32, 156, 470, seed=3)
    call = lambda: psd.damped_chol_solve(a, d, b)  # noqa: E731
    both = kernel_device_ms(call, psd.KERNELS, per_call=2)
    factor, subst = (kernel_device_ms(call, name) for name in psd.KERNELS)
    assert None not in (both, factor, subst)
    assert both > max(factor, subst)
    assert abs(both / (factor + subst) - 1) <= 0.2
    vec = b[..., 0].contiguous()
    alone = kernel_device_ms(lambda: psd.damped_chol_solve(a, d, vec), psd.KERNELS)
    assert kernel_device_ms(lambda: psd.damped_chol_solve(a, d, vec), psd.KERNELS[1]) is None
    assert alone is not None and alone > 0


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


@pytest.mark.parametrize("batch", [1, 2, 131, 133, 2048])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 156, 157, 169, 192, 224, 225, 300])
def test_damped_solve_kernel_panel_edges_and_batches(cuda_problem, n, batch):
    """The factor's panel edges: one panel and no lookahead (n ≤ 32), a
    ragged last panel (33, 63, 157, 169), whole panels (64, 192, 224); the
    paths' n (156, 157, 169); past the second form's shared memory (225)
    and the packed triangle's (300, the workspace form); at one system, two,
    and batches that end a round of blocks ragged (131, 133) or fill the card
    (2048): against the plain version by relative residual and by x."""
    a, damp, b = _spd(n, batch, seed=n + batch)
    before = psd.launches
    x = psd.damped_chol_solve(a, damp, b)
    assert psd.launches == before + 1
    ad = (a + torch.diag_embed(damp)).double()
    res = torch.linalg.norm((ad @ x.double()[..., None])[..., 0] - b.double(), dim=-1)
    assert float((res / torch.linalg.norm(b.double(), dim=-1)).max()) <= 1e-5
    x_plain = psd.damped_chol_solve_plain(a, damp, b)
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) <= 1e-3


@pytest.mark.parametrize("n", [1, 33, 157, 169, 224, 288])
def test_factor_only_form_hands_on_the_fused_forms_factor(cuda_problem, n):
    """The factor-only form's workspace, as damped_chol_subst_kernel reads it,
    is bit-equal to the factor the fused form builds (handed on beside its x
    by damped_chol_factor_launch), whose x is the solve's; one system's
    failed pivot (F1) leaves its flag down in both. The hand-on's format:
    zeros above the diagonal of the diagonal blocks, the transpose of the
    blocks below them above them."""
    a, damp, b = _spd(n, 6, seed=n)
    a[4, n // 2, n // 2] = -1e6
    before = psd.launches
    f_only, ok_only = psd.damped_chol_factor(a, damp)
    f_fused, ok_fused, x_fused = psd.damped_chol_factor(a, damp, b)
    assert psd.launches == before + 2
    assert ok_only.tolist() == ok_fused.tolist() == [True, True, True, True, False, True]
    assert torch.equal(f_only[ok_only], f_fused[ok_fused])
    x = psd.damped_chol_solve(a, damp, b)
    assert torch.equal(x_fused[ok_fused], x[ok_fused]) and torch.isnan(x_fused[4]).all()
    m = f_only.shape[-1]
    idx = torch.arange(m, device=a.device)
    blk = idx // 32
    factor = f_only[ok_only]
    assert (factor[:, (blk[:, None] == blk[None, :]) & (idx[None, :] > idx[:, None])] == 0).all()
    above = blk[:, None] < blk[None, :]
    assert torch.equal(factor[:, above], factor.transpose(-1, -2)[:, above])
    assert torch.isfinite(factor).all()


_F1_CHILD = """
import sys
import torch
from momentum_tpu_torch.ops import psd
g = torch.Generator().manual_seed(7)
bad = []
for n, pivot in ((157, 5), (157, 40), (157, 150), (288, 260), (300, 40), (300, 290)):
    j = torch.randn(5, n + 20, n, generator=g)
    a = (j.transpose(-1, -2) @ j).cuda()
    d = 0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5
    a[3, pivot, pivot] = -1e6
    for k in (1, 40):
        b = torch.randn(5, n, k, generator=g) if k > 1 else torch.randn(5, n, generator=g)
        x = psd.damped_chol_solve(a, d, b.cuda())
        torch.cuda.synchronize()
        if not (bool(torch.isnan(x[3]).all()) and bool(torch.isfinite(x[[0, 1, 2, 4]]).all())):
            bad.append((n, pivot, k))
print("failed:", bad)
sys.exit(1 if bad else 0)
"""


def test_failed_pivot_in_every_panel_under_a_timeout(cuda_problem):
    """ROADMAP F1 where the factor's warps part: a pivot that fails in panel 0,
    in panel 1 (which warp 0 factors under panel 0's trailing update) or in
    the ragged last panel, at n = 157, 288 (the largest packed triangle) and
    300 (the workspace form), with 1 and 40 right-hand sides: that system's x
    all NaN, its neighbours' finite. In a child process under a timeout, so
    that a barrier left waiting fails the test rather than hanging it."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(p for p in (str(root), os.environ.get("PYTHONPATH"))
                                          if p))
    proc = subprocess.run([sys.executable, "-c", _F1_CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
def scene_passes(cuda_device):
    """Config 7p's frame 0 on the card: the culled Phong pass at 1280 × 960,
    the skeleton's 50 cylinders and the 80-face sphere, as
    workloads.scene_passes builds them."""
    char, motion, cam = workloads.build_scene_clip(32, seed=0, device="cuda")
    return char, motion, cam, workloads.scene_passes(char, cam, motion)


@pytest.mark.parametrize("name,kernel", [("phong", "raster_planes_binned_kernel"),
                                         ("skeleton", "raster_planes_binned_kernel"),
                                         ("sphere", "raster_planes_kernel")])
def test_raster_kernels_on_scene_passes(scene_passes, name, kernel):
    """K4b on the Phong pass, whose back faces culling rewrote to the
    degenerate face (0, 0, 0) (killed by the planes, binned by vertex 0's
    pixel all the same), and on the skeleton's 3200 faces; K4a on the
    sphere: each equal to the plain version."""
    *_, passes = scene_passes
    sv, faces, w, h, kw = passes[name]
    out, launched = _kernel_vs_plain(sv, faces, w, h, kw)
    assert launched == kernel and bool((out["face"] >= 0).any())
    if name == "phong":
        assert int((faces == 0).all(1).sum()) > 100  # culled faces


def test_dense_and_windowed_rasterizers_on_the_card_match_the_cpu(scene_passes):
    """render.rasterize and rasterize_windowed on the card against the same
    functions on the CPU, on frame 0's 640 × 480 camera pass and on a random
    scene with big faces: equal face maps, depth and barycentrics to 1e-5."""
    from momentum_tpu_torch.rasterizer import render

    char, motion, cam, _ = scene_passes
    sv = render.screen_vertices(cam, workloads.clip_vertices(char, motion[0]))
    verts, faces, w, h, _ = _scene(5, 300, 200, 256, 96)
    for v, f, width, height in ((sv, char.mesh.faces, 640, 480),
                                (torch.as_tensor(verts, device="cuda"),
                                 torch.as_tensor(faces, device="cuda"), w, h)):
        for fn in (render.rasterize, render.rasterize_windowed):
            got = fn(v, f, width, height)
            want = fn(v.cpu(), f.cpu(), width, height)
            assert torch.equal(got["face"].cpu(), want["face"])
            assert bool((want["face"] >= 0).any())
            hit = want["face"] >= 0
            torch.testing.assert_close(got["depth"].cpu()[hit], want["depth"][hit], rtol=0,
                                       atol=1e-5)
            torch.testing.assert_close(got["bary"].cpu(), want["bary"], rtol=0, atol=1e-5)


def test_scene_frame_on_the_card_matches_the_cpu(scene_passes):
    """Frame 0 of config 7p's Phong scene on the card and on the CPU: the
    Phong pass's masks on all but max(3, 0.1%) of the covered pixels, the
    composited images' colours to 1e-3 on 99.9% of the pixels; K4b twice
    and K4a once."""
    char, motion, cam, _ = scene_passes
    cchar, cmotion, ccam = workloads.build_scene_clip(32, seed=0, device="cpu")
    frames = []
    for c, m, k in ((char, motion, cam), (cchar, cmotion, ccam)):
        states, verts, locs = workloads.scene_poses(c, m[:1])
        ground = workloads.scene_ground(k, verts[0])
        before = dict(raster.launches)
        frames.append(workloads.scene_frame(c, k, states[0], verts[0], locs[0], ground,
                                            "FRAME 0"))
        if c is char:
            assert raster.launches["raster_planes_binned_kernel"] == \
                before["raster_planes_binned_kernel"] + 2
            assert raster.launches["raster_planes_kernel"] == before["raster_planes_kernel"] + 1
    g, c = frames
    cov = int(c["phong"]["mask"].sum())
    assert cov > 0 and int((g["phong"]["mask"].cpu() != c["phong"]["mask"]).sum()) <= max(
        3, cov // 1000)
    assert (np.abs(g["image"] - c["image"]).max(-1) <= 1e-3).mean() >= 0.999


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


@pytest.fixture(scope="module")
def diff_ik_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return (workloads.build_diff_ik_problem(64, seed=0, device="cuda"),
            workloads.build_diff_ik_problem(64, seed=0, device="cpu"))


def _diff_ik_gradients(prob):
    """(θ*, ∂L/∂targets, ∂L/∂cweight, ∂L/∂x0, gradient rmse at θ*) of config
    D's loss Σ w·θ* through solve_ik_torch."""
    from momentum_tpu_torch.solver import gradient_rmse

    t, c, x0 = (v.clone().requires_grad_() for v in (prob.targets, prob.cweight, prob.x0))
    theta = workloads.solve_diff_ik(prob, t, c, x0)
    (theta * prob.w).sum().backward()
    fn = workloads.diff_ik_solver_fn(prob, {"targets": prob.targets, "cweight": prob.cweight})
    theta = theta.detach()
    return theta, t.grad, c.grad, x0.grad, gradient_rmse(fn, theta, prob.mask)


def test_diff_ik_gradient_on_the_card_matches_the_cpu(diff_ik_problems):
    """Config D at B = 64 (GN 20 and the IFT backward: the normal equations
    through K1, one K2+K3 solve, the energy's directional derivative through
    K1's jvp rule) on the card against the CPU's plain path: on the elements
    at a stationary point in both (gradient rmse ≤ 1e-3), 95% of the
    per-element gradients to the targets and the constraint weights within
    5e-2 relative L2, as chip_smoke.py holds the card against JAX CPU; x0's
    pass-through gradient exact."""
    card, cpu = diff_ik_problems
    before = (fk_ops.launches, psd.launches)
    got = _diff_ik_gradients(card)
    assert fk_ops.launches > before[0] and psd.launches > before[1]
    want = _diff_ik_gradients(cpu)
    stationary = ((got[4].cpu() <= 1e-3) & (want[4] <= 1e-3)).numpy()
    assert stationary.mean() >= 0.4
    for g_card, g_cpu in zip(got[1:3], want[1:3]):
        a, b = g_card.cpu().flatten(1).numpy(), g_cpu.flatten(1).numpy()
        rel = np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)
        assert np.mean(rel[stationary] < 5e-2) >= 0.95
    scale = card.char.parameter_transform.names.index("scale_global")
    x0_bar = got[3]
    assert torch.equal(x0_bar[:, scale], card.w[:, scale])
    assert float(x0_bar[:, [i for i in range(x0_bar.shape[1]) if i != scale]].abs().max()) == 0


def test_ift_backward_through_k1_matches_plain(diff_ik_problems):
    """The IFT backward at config D's warm starts (no iteration, so θ* =
    x0; regularization 10 keeps H + 10·I well conditioned), FK on K1 —
    launched for the normal equations' context and the directional
    derivative's primal, its tangent by K1's jvp rule — against the same
    with FK on the plain version: the gradients to the targets, the
    constraint weights and x0."""
    from momentum_tpu_torch.solver import SolverOptions, solve_ik_ift

    card, _ = diff_ik_problems

    def grads():
        t, c, x0 = (v.clone().requires_grad_() for v in (card.targets, card.cweight, card.x0))
        fn = workloads.diff_ik_solver_fn(card, {"targets": t, "cweight": c})
        theta = solve_ik_ift(fn, x0, card.mask, SolverOptions(max_iterations=0,
                                                              regularization=10.0))
        before = fk_ops.launches
        (theta * card.w).sum().backward()
        return t.grad, c.grad, x0.grad, fk_ops.launches - before

    *kernel, launches = grads()
    assert launches >= 2
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        *plain, _ = grads()
    finally:
        fk_ops._fk_global_kernel = real
    for a, b in zip(kernel, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


def test_cg_matvec_through_k1_matches_plain(diff_ik_problems):
    """CG's product Jᵀ(J v) at config D's warm starts: one torch.func.jvp
    and the VJP of the position rows, FK's primal through K1, against the
    same with FK on the plain version and against the analytic Jacobian's
    dense product."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    card, _ = diff_ik_problems
    fn = SkeletonSolverFunction(card.char,
                                (dataclasses.replace(card.ef0, target=card.targets),))
    v = torch.randn(card.x0.shape, generator=torch.Generator().manual_seed(3)).cuda()

    def matvec():
        _, vjp_fn = torch.func.vjp(fn.residual, card.x0)
        return vjp_fn(torch.func.jvp(fn.residual, (card.x0,), (v,))[1])[0]

    before = fk_ops.launches
    out = matvec()
    assert fk_ops.launches >= before + 2
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        out_plain = matvec()
    finally:
        fk_ops._fk_global_kernel = real
    scale = float(out_plain.abs().max())
    torch.testing.assert_close(out, out_plain, rtol=0, atol=1e-5 * scale)
    _, j = fn.residual_and_jacobian(card.x0)
    dense = (j.transpose(-1, -2) @ (j @ v[..., None]))[..., 0]
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("name", sorted(workloads.variant_recipe()))
def test_solver_variant_on_the_card_matches_the_cpu(diff_ik_problems, name):
    """Each solver variant on config D's position problem at B = 64 on the
    card against the CPU: the median final energy within 20%, as
    chip_smoke.py holds it against JAX CPU's; every element finite."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    results = []
    for prob in diff_ik_problems:
        _, res = workloads.solve_variant(prob, name)
        fn = SkeletonSolverFunction(prob.char,
                                    (dataclasses.replace(prob.ef0, target=prob.targets),))
        results.append(fn.error(res.params).cpu().numpy())
    e_card, e_cpu = results
    assert np.isfinite(e_card).all()
    assert abs(np.median(e_card) / np.median(e_cpu) - 1) <= 0.2


def test_vertex_extra_rows_on_the_card_match_the_cpu():
    """Config 4x's three forward-mode vertex modules at B = 16: rows and
    Jacobians (FK's primal through K1) on the card against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    probs = [workloads.build_vertex_extra_problem(16, device=d) for d in ("cuda", "cpu")]
    out = []
    for p in probs:
        mods = workloads.vertex_extra_modules(p, p.fit.targets, p.distance.target,
                                              p.camera.target)[1:]
        out.append([SkeletonSolverFunction(p.fit.char, (m,)).residual_and_jacobian(p.fit.x0)
                    for m in mods])
    for (rk, jk), (rc, jc) in zip(*out):
        torch.testing.assert_close(rk.cpu(), rc, rtol=0, atol=1e-4 * float(rc.abs().max()))
        torch.testing.assert_close(jk.cpu(), jc, rtol=0, atol=1e-4 * float(jc.abs().max()))


@pytest.fixture(scope="module")
def skinned_problems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return (workloads.build_skinned_ik_problem(64, seed=0, device="cuda"),
            workloads.build_skinned_ik_problem(64, seed=0, device="cpu"))


def test_skinned_ik_on_the_card_matches_the_cpu(skinned_problems):
    """Config SL at B = 64 (skinned locators, sliding triangles, limits; LM
    10) on the card, K1 and K2+K3 launched, against the CPU's plain path:
    the same skinned-locator tables, each module's median final energy
    within 20% (the IK rule, as chip_smoke.py holds it against JAX CPU's),
    the elements' total energies at a median relative difference under
    1e-3."""
    card, cpu = skinned_problems
    for a, b in ((card.char.skinned_locators.parents, cpu.char.skinned_locators.parents),
                 (card.modules[1][1].candidates, cpu.modules[1][1].candidates)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
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


def test_skinned_locator_rows_through_k1_match_plain(skinned_problems):
    """The forward-mode Jacobian of config SL's two skinned-locator modules
    (the posed mesh's tangents included) at B = 16, FK's primal through K1,
    against the same with FK on the plain version."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

    card, _ = skinned_problems
    position, triangle = (ef for _, ef in card.modules[:2])
    fn = SkeletonSolverFunction(card.char, (dataclasses.replace(
        position, target=position.target[:16]), triangle))
    x = card.x0[:16].contiguous()
    before = fk_ops.launches
    rows, jt = ad_jacobian(fn.residual, x)
    assert fk_ops.launches > before
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        rows_p, jt_p = ad_jacobian(fn.residual, x)
    finally:
        fk_ops._fk_global_kernel = real
    torch.testing.assert_close(rows, rows_p, rtol=0, atol=1e-5 * float(rows_p.abs().max()))
    torch.testing.assert_close(jt, jt_p, rtol=0, atol=1e-5 * float(jt_p.abs().max()))


def test_glove_sequence_on_the_card_matches_the_cpu():
    """Config G's track_sequence on a 130-frame clip (SPIKE's steps on the
    card) against the CPU's: the final error within 1e-2 relative and the
    marker and glove medians within 2%, as chip_smoke.py holds the card
    against JAX CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for device in ("cuda", "cpu"):
        clip = workloads.build_glove_clip(130, device=device)
        before = (fk_ops.launches, psd.launches)
        res = workloads.track_glove_sequence(clip)
        if device == "cuda":
            assert fk_ops.launches > before[0] and psd.launches > before[1]
        out.append(dict(error=float(res.errors[0]), **workloads.glove_figures(clip, res.motion)))
    card, cpu = out
    assert abs(card["error"] - cpu["error"]) <= 1e-2 * cpu["error"]
    for k in ("median_mm", "glove_position_median_mm", "glove_orientation_median_deg"):
        assert abs(card[k] - cpu[k]) <= 0.02 * cpu[k], (k, card, cpu)


@pytest.fixture(scope="module")
def sdf_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return workloads.build_sdf_collision_problem(workloads.SDF_BATCH, seed=0, device="cuda")


@pytest.mark.parametrize("label", ["obstacle", "ground", "handle"])
def test_mesh_to_sdf_on_the_card_matches_the_cpu(sdf_problem, label):
    """Config SC's three fields (the 1280-face obstacle by winding number and
    the ground slab by the closest face's normal at 64³, the handle at 32³)
    by mesh_to_sdf on the card against the same code on the CPU: values
    within 1e-5 of the grid's extent, signs equal on 99.9% of the voxels."""
    from momentum_tpu_torch.axel import mesh_to_sdf

    r = sdf_problem.recipe
    res = workloads.SDF_HAND_RESOLUTION if label == "handle" else workloads.SDF_RESOLUTION
    method = "normal" if label == "ground" else "winding"
    mesh = (r[f"{label}_vertices"], r[f"{label}_faces"])
    card = mesh_to_sdf(*mesh, res, sign_method=method, device="cuda")
    cpu = mesh_to_sdf(*mesh, res, sign_method=method, device="cpu")
    torch.testing.assert_close(card.origin.cpu(), cpu.origin, rtol=0, atol=1e-6)
    torch.testing.assert_close(card.spacing.cpu(), cpu.spacing, rtol=0, atol=1e-6)
    extent = float((cpu.spacing * (torch.tensor(res) - 1)).max())
    vc, vp = card.values.cpu(), cpu.values
    assert float((vc.abs() - vp.abs()).abs().max()) <= 1e-5 * extent
    assert float((torch.sign(vc) == torch.sign(vp)).float().mean()) >= 0.999


def test_sdf_collision_ik_on_the_card_matches_plain(sdf_problem):
    """Config SC at B = 2048 (LM 10) through K1 and K2+K3, against the same
    solve on the card with both kernels' plain versions: each module's
    median final energy within 20% (the IK rule), the elements' total
    energies at a median relative difference under 1e-3, nothing
    divergent."""
    before = (fk_ops.launches, psd.launches)
    res = workloads.solve_catalog(sdf_problem)
    assert fk_ops.launches > before[0] and psd.launches > before[1]
    real = fk_ops._fk_global_kernel, psd.damped_chol_solve
    fk_ops._fk_global_kernel, psd.damped_chol_solve = (fk_ops.fk_global_plain,
                                                       psd.damped_chol_solve_plain)
    try:
        before = (fk_ops.launches, psd.launches)
        res_plain = workloads.solve_catalog(sdf_problem)
        assert (fk_ops.launches, psd.launches) == before
    finally:
        fk_ops._fk_global_kernel, psd.damped_chol_solve = real
    e = {k: v.cpu().numpy() for k, v in workloads.catalog_energies(
        sdf_problem, res.params).items()}
    e_plain = {k: v.cpu().numpy() for k, v in workloads.catalog_energies(
        sdf_problem, res_plain.params).items()}
    floor = 1e-8 * float(np.median(e_plain["total"]))
    for k in e_plain:
        a, b = float(np.median(e[k])), float(np.median(e_plain[k]))
        assert abs(a - b) <= 0.2 * b + floor, (k, a, b)
    rel = np.abs(e["total"] - e_plain["total"]) / e_plain["total"]
    assert float(np.median(rel)) <= 1e-3
    assert bool(torch.isfinite(res.params).all())


def test_sdf_joint_attached_rows_through_k1_match_plain(sdf_problem):
    """The joint-attached VertexSdf's forward-mode Jacobian (the handle's
    grid on r_hand0) at B = 16, FK's primal through K1, against the same
    with FK on the plain version, to 1e-4 of the largest row and entry
    (chip_smoke.py's SDF_AD_K1_RTOL: the rows are differences of distances,
    so the float32 rounding of the posed vertices is ~1e-5 of them)."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

    joint = workloads.sdf_joint_problem(sdf_problem, 16)
    hand = joint.modules[1][1]
    assert not hand.has_analytic_jacobian
    fn = SkeletonSolverFunction(joint.char, (hand,))
    before = fk_ops.launches
    rows, jt = ad_jacobian(fn.residual, joint.x0)
    assert fk_ops.launches > before
    real = fk_ops._fk_global_kernel
    fk_ops._fk_global_kernel = fk_ops.fk_global_plain
    try:
        rows_p, jt_p = ad_jacobian(fn.residual, joint.x0)
    finally:
        fk_ops._fk_global_kernel = real
    torch.testing.assert_close(rows, rows_p, rtol=0, atol=1e-4 * float(rows_p.abs().max()))
    torch.testing.assert_close(jt, jt_p, rtol=0, atol=1e-4 * float(jt_p.abs().max()))


@pytest.fixture(scope="module")
def utility_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return workloads.build_utility_problem(workloads.UTILITY_BATCH, device="cuda")


def test_retarget_on_the_card_is_fk_consistent(utility_problem):
    """Config U's U1 at B = 2048: transform_pose of the truths by the config's
    move (a translation past π units, ROADMAP F25) through K1; FK of the
    result equals the moved poses within 1e-4 m and 1e-4 rad, their skinned
    vertices too; the 4×4 form equals the skel_state form; the result is
    the CPU's within 1e-4."""
    from momentum_tpu_torch import torch_interop
    from momentum_tpu_torch.math import skel_state as ss

    prob = utility_problem
    before = fk_ops.launches
    moved = workloads.retarget(prob, prob.truth)
    assert fk_ops.launches > before
    fig = workloads.retarget_figures(prob, prob.truth, moved)
    assert fig["max_position_error"] <= 1e-4 and fig["max_rotation_error"] <= 1e-4, fig
    assert fig["max_vertex_error"] <= 1e-4, fig
    head = prob.truth[:workloads.UTILITY_INTEROP]
    by_matrix = torch_interop.transform_pose(prob.char, head, ss.to_matrix(prob.xform))
    torch.testing.assert_close(by_matrix, moved[:head.shape[0]], rtol=0, atol=1e-4)
    cpu = workloads.build_utility_problem(64, device="cpu")
    torch.testing.assert_close(moved[:64].cpu(), workloads.retarget(cpu, cpu.truth), rtol=0,
                               atol=1e-4)


def test_simplified_ik_on_the_card_matches_plain(utility_problem):
    """Config U's U4 at B = 2048 (LM on the simplified rig, K1 at its 37
    joints, K2+K3 at (2048, 115)) against the same solve with both kernels'
    plain versions. After LM 3, where the energies (~1e-4) stand far above
    float32 roundoff: the medians within 1%, the elements' energies at a
    median relative difference under 5e-3 (tools/utility_spread.py on one
    H100: 0.25% and 1.9e-3 to 2.2e-3 at B = 256). After LM 10 (~4e-10, an
    iteration still cutting them by ~40%): the medians within 20%, the
    elements at a median relative difference under 0.2 (4.5e-2 to 7.8e-2;
    a solve one iteration short lands 0.53 to 0.61 off), nothing divergent.
    K1 at the kept joint count against its plain version."""
    prob = utility_problem.simplified
    skel = prob.char.skeleton
    local = fk.local_skel_states(skel, prob.char.parameter_transform.apply(prob.x0))
    torch.testing.assert_close(fk_ops.fk_global(skel, local.contiguous()),
                               fk_ops.fk_global_plain(skel, local), rtol=0, atol=2e-5)

    def total(iterations):
        res = workloads.solve_catalog(prob, iterations=iterations)
        return workloads.catalog_energies(prob, res.params)["total"].cpu().numpy().astype(
            np.float64)

    before = (fk_ops.launches, psd.launches)
    e = {it: total(it) for it in (3, 10)}
    assert fk_ops.launches > before[0] and psd.launches > before[1]
    real = fk_ops._fk_global_kernel, psd.damped_chol_solve
    fk_ops._fk_global_kernel, psd.damped_chol_solve = (fk_ops.fk_global_plain,
                                                       psd.damped_chol_solve_plain)
    try:
        e_plain = {it: total(it) for it in (3, 10)}
    finally:
        fk_ops._fk_global_kernel, psd.damped_chol_solve = real
    for it, (median_tol, element_tol) in ((3, (0.01, 5e-3)), (10, (0.2, 0.2))):
        got, want = e[it], e_plain[it]
        assert bool(np.isfinite(got).all())
        assert abs(np.median(got) - np.median(want)) <= median_tol * np.median(want)
        assert float(np.median(np.abs(got - want) / want)) <= element_tol


SHARDED_FRAMES = 160  # 80 frames a rank; the single-device solve takes SPIKE


def _sharded_sequence_rank(rank, world):
    """One rank of test_sharded_sequence_on_the_card: a 5f-shaped sequence
    through solve_sequence_sharded on cuda:0, the rank's launches counted."""
    from momentum_tpu_torch.sequence.sharded import solve_sequence_sharded
    from momentum_tpu_torch.solver import SolverOptions

    torch.cuda.set_device(0)
    prob = workloads.build_sequence_problem(SHARDED_FRAMES, fullbody=True, device="cuda")
    before = (fk_ops.launches, psd.launches)
    res = solve_sequence_sharded(prob.fn, prob.pf0, prob.u0,
                                 options=SolverOptions(max_iterations=4, min_iterations=4))
    return dict(error=float(res.error), iterations=res.iterations,
                finite=bool(torch.isfinite(res.per_frame).all()),
                launches=(fk_ops.launches - before[0], psd.launches - before[1]))


def test_sharded_sequence_on_the_card():
    """Two gloo ranks sharing the card solve config 5f's problem at F = 160
    by solve_sequence_sharded: each launches K1 and K2+K3, both return the
    same energy, within 1e-3 of the single-device solve's (the CPU tests'
    tolerance between the two), after as many iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from momentum_tpu_torch.sequence import solve_sequence
    from momentum_tpu_torch.solver import SolverOptions
    from momentum_tpu_torch.testing.distributed import Ranks

    with Ranks(2, _sharded_sequence_rank, timeout=300) as ranks:
        got = ranks.results()
    prob = workloads.build_sequence_problem(SHARDED_FRAMES, fullbody=True, device="cuda")
    ref = solve_sequence(prob.fn, prob.pf0, prob.u0,
                         SolverOptions(max_iterations=4, min_iterations=4))
    assert got[0]["error"] == got[1]["error"]
    for g in got:
        assert g["finite"] and g["iterations"] == ref.iterations
        assert g["launches"][0] > 0 and g["launches"][1] > 0
        assert abs(g["error"] / float(ref.error) - 1) <= 1e-3


def _syncs_and_sync_spans(call):
    """(the synchronizing calls that sync debug mode reports in call(), the
    `.sync` spans it emits) under a profiler of the host."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    warned = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    spans = sum(e.name().endswith(".sync") for e in prof.profiler.kineto_results.events())
    return warned, spans


def test_every_host_sync_is_a_sync_span(cuda_problem):
    """One small IK call (LM 5 + 6 on the worst 16 of 256) and one small take
    (128 frames through SPIKE, the full-body rig): each synchronizing call
    the card reports lies in a `.sync` span, one span a sync."""
    from momentum_tpu_torch.solver import SolverOptions

    char, ef0, targets, x0 = cuda_problem
    solve = workloads.make_solve_batch(char, ef0, 256)
    prob = workloads.build_sequence_problem(128, fullbody=True, device="cuda")
    take = workloads.make_sequence_solve(prob.fn, SolverOptions(max_iterations=3))
    for call in (lambda: solve(targets, x0), lambda: take(prob.pf0, prob.u0)):
        call()  # builds the kernels and warms the allocator
        torch.cuda.synchronize()
        warned, spans = _syncs_and_sync_spans(call)
        assert warned == spans > 0


@pytest.mark.parametrize("kind", ["gn", "gn_line_search", "gn_cg", "gd", "lm_fused"])
def test_every_host_sync_of_the_other_solvers_is_a_sync_span(cuda_problem, kind):
    """GN (by Cholesky, with its line search, matrix-free by CG), gradient
    descent and LM carrying its Jacobian, on 256 frames of the full-body
    rig: one `.sync` span a synchronizing call."""
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions
    from momentum_tpu_torch.solver.gauss_newton import (
        solve_gauss_newton, solve_gradient_descent, solve_levenberg_marquardt)

    char, ef0, targets, x0 = cuda_problem
    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    opts = SolverOptions(max_iterations=3, energy_from_residual=True)
    jac = {"jacobian_fn": fn.residual_and_jacobian}
    calls = {
        "gn": lambda: solve_gauss_newton(fn.residual, fn.error, x0, options=opts, **jac),
        "gn_line_search": lambda: solve_gauss_newton(
            fn.residual, fn.error, x0, options=dataclasses.replace(
                opts, do_line_search=True, line_search_steps=3, energy_from_residual=False),
            **jac),
        "gn_cg": lambda: solve_gauss_newton(
            fn.residual, fn.error, x0,
            options=dataclasses.replace(opts, linear_solver="cg", cg_iterations=8)),
        "gd": lambda: solve_gradient_descent(fn.residual, fn.error, x0, options=opts, **jac),
        "lm_fused": lambda: solve_levenberg_marquardt(
            fn.residual, fn.error, x0, options=dataclasses.replace(opts, carry_jacobian=True),
            **jac),
    }
    calls[kind]()
    torch.cuda.synchronize()
    warned, spans = _syncs_and_sync_spans(calls[kind])
    assert warned == spans > 0


def _k6_rig(name):
    """The CMU rig of the IK cell (portbench/rigs/cmu41.json) or the repo's
    full-body rig, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from momentum_tpu_torch.testing import fixtures
    from portbench.rig import load_rig, port_character

    if name == "cmu41":
        return port_character(load_rig("portbench/rigs/cmu41.json"), "cuda")
    return fixtures.create_fullbody_character(device="cuda")


K6_TOL = 1e-5  # of max|J|: the plain form's float32 factors, summed in another order


@pytest.mark.parametrize("rig,tiled", [("cmu41", False), ("fullbody", True)])
@pytest.mark.parametrize("loss", [None, (1.0, 2.0)], ids=["scale_C", "scale_BC"])
def test_point_jacobian_kernel_matches_plain(rig, tiled, loss):
    """K6 at B = 4096 against the merged PyTorch form: the CMU rig (C = 41,
    nJ = 23, P = 73) in one column tile, the full-body rig (C = 80,
    nJ = 51, P = 157) column-tiled; the L2 loss's (C,) row scale and a
    robust loss's (B, C) one. One launch a call."""
    from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
    from momentum_tpu_torch.ops import jacobian as jac_ops

    char = _k6_rig(rig)
    jc, world, parents, pt_mat, scale = workloads.point_jacobian_inputs(
        char, 4096, seed=5, loss=None if loss is None else GeneralizedLoss(*loss))
    assert scale.shape == ((parents.shape[0],) if loss is None else (4096, parents.shape[0]))
    nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt_mat.shape[1]
    assert (jac_ops.point_jacobian_tile(nj, c, p) < p) == tiled
    before = jac_ops.launches
    out = jac_ops.point_jacobian_model(jc, world, parents, pt_mat, scale=scale)
    assert jac_ops.launches == before + 1
    ref = jac_ops.point_jacobian_model_plain(jc, world, parents, pt_mat, scale=scale)
    assert out.shape == ref.shape == (4096, c, 3, p)
    torch.testing.assert_close(out, ref, rtol=0, atol=K6_TOL * float(ref.abs().max()))


@pytest.mark.parametrize("shapes", ["batch_2x3", "scale_broadcast", "points_broadcast",
                                    "single"])
def test_point_jacobian_kernel_leading_dims(shapes):
    """Leading dims that broadcast, as the plain form takes them: a (2, 3)
    batch; a (3, C) scale against it; points shared by one context's poses
    (the context (2, 3), the points (1, 3)); a single element without a
    batch dim."""
    from momentum_tpu_torch.ops import jacobian as jac_ops
    from momentum_tpu_torch.solver.analytic_jacobian import JacobianContext

    char = _k6_rig("cmu41")
    jc, world, parents, pt_mat, _ = workloads.point_jacobian_inputs(char, 6, seed=9)
    c = parents.shape[0]
    g = torch.Generator(device="cpu").manual_seed(3)
    scale = torch.rand(6, c, generator=g).cuda()

    def batched(t, lead):
        return t.reshape(lead + t.shape[1:])

    lead = (2, 3)
    ctx = JacobianContext(jc.anc_mask, *(batched(t, lead) for t in
                                         (jc.joint_pos, jc.trans_axis, jc.rot_axis)))
    pts, sc = batched(world, lead), batched(scale, lead)
    if shapes == "scale_broadcast":
        sc = sc[0]  # (3, C)
    elif shapes == "points_broadcast":
        pts = pts[:1]  # (1, 3, C, 3)
    elif shapes == "single":
        ctx = JacobianContext(jc.anc_mask, jc.joint_pos[0], jc.trans_axis[0], jc.rot_axis[0])
        pts, sc = world[0], scale[0]
    before = jac_ops.launches
    out = jac_ops.point_jacobian_model(ctx, pts, parents, pt_mat, scale=sc)
    assert jac_ops.launches == before + 1
    ref = jac_ops.point_jacobian_model_plain(ctx, pts, parents, pt_mat, scale=sc)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=K6_TOL * float(ref.abs().max()))


def test_position_jacobian_model_launches_k6_alone(monkeypatch):
    """On a CUDA float32 input PositionErrorFunction.jacobian_model launches
    K6 once a call and never the plain form; the solver function returns
    K6's J as it is; parameters that require grad launch K6 too, and the
    J carries the plain form's gradient."""
    from momentum_tpu_torch.errors import PositionErrorFunction
    from momentum_tpu_torch.ops import jacobian as jac_ops
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context

    char = _k6_rig("cmu41")
    x = 0.1 * torch.randn(64, char.num_model_parameters, device="cuda")
    ef = PositionErrorFunction.create(
        char.locators.parent.cpu().numpy(), char.locators.offset.cpu().numpy(),
        np.zeros((char.locators.num_locators, 3)), device="cuda")
    fn = SkeletonSolverFunction(char, (ef,))
    ctx = fn.context(x)
    jc = make_jacobian_context(char, ctx)
    pt_mat = char.parameter_transform.transform
    plain = jac_ops.point_jacobian_model_plain

    def refused(*args, **kwargs):
        raise AssertionError("the plain form ran on a CUDA float32 input")

    monkeypatch.setattr(jac_ops, "point_jacobian_model_plain", refused)
    before = jac_ops.launches
    rows, j = ef.jacobian_model(char, ctx, jc, pt_mat)
    assert jac_ops.launches == before + 1
    rows_fn, j_fn = fn.residual_and_jacobian(x)
    assert jac_ops.launches == before + 2
    torch.testing.assert_close(j_fn, j, rtol=0, atol=0)
    torch.testing.assert_close(rows_fn, rows, rtol=0, atol=0)
    xg = x.clone().requires_grad_()
    _, j_grad = fn.residual_and_jacobian(xg)
    assert jac_ops.launches == before + 3 and j_grad.requires_grad
    torch.testing.assert_close(j_grad.detach(), j, rtol=0,
                               atol=K6_TOL * float(j.abs().max()))
    monkeypatch.setattr(jac_ops, "point_jacobian_model_plain", plain)
    w = torch.randn_like(j)
    (got,) = torch.autograd.grad((j_grad * w).sum(), xg)
    monkeypatch.setattr(jac_ops, "kernel_takes", lambda *args: False)
    xp = x.clone().requires_grad_()
    _, j_plain = fn.residual_and_jacobian(xp)
    (want,) = torch.autograd.grad((j_plain * w).sum(), xp)
    assert jac_ops.launches == before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=K6_TOL * float(want.abs().max()))


@pytest.mark.parametrize("case", ["backward", "jvp", "vmap_element", "vmap_transform"])
def test_point_jacobian_kernel_derivatives(case):
    """K6 under autograd and torch.func on the CMU rig at B = 256: the
    forward launches the kernel (once, or once a slice of a vmapped
    transform), and the gradient, the forward-mode tangent and the vmapped
    J are the plain form's."""
    from momentum_tpu_torch.ops import jacobian as jac_ops

    char = _k6_rig("cmu41")
    jc, world, parents, pt_mat, scale = workloads.point_jacobian_inputs(char, 256, seed=7)
    g = torch.Generator(device="cpu").manual_seed(13)

    def randn(shape):
        return torch.randn(shape, generator=g).cuda()

    def through(plain):
        def jac(pos, pts, sc, pt):
            c = dataclasses.replace(jc, joint_pos=pos)
            if plain:
                return jac_ops.point_jacobian_model_plain(c, pts, parents, pt, scale=sc)
            return jac_ops.point_jacobian_model(c, pts, parents, pt, scale=sc)
        return jac

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=K6_TOL * float(b.abs().max()))

    args = (jc.joint_pos, world, scale, pt_mat)
    before = jac_ops.launches
    if case == "backward":
        w = randn(world.shape + (pt_mat.shape[1],))
        outs, grads = [], []
        for plain in (False, True):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            outs.append(through(plain)(*leaves))
            grads.append(torch.autograd.grad((outs[-1] * w).sum(), leaves))
        launched = 1
        close(outs[0].detach(), outs[1].detach())
        for a, b in zip(*grads):
            close(a, b)
    elif case == "jvp":
        tangents = tuple(randn(a.shape) for a in args)
        got = torch.func.jvp(through(False), args, tangents)
        want = torch.func.jvp(through(True), args, tangents)
        launched = 1
        close(got[0], want[0])
        close(got[1], want[1])
    else:
        v = 3
        if case == "vmap_element":
            pos = jc.joint_pos + 0.01 * randn((v,) + jc.joint_pos.shape)
            vargs, dims, launched = (pos, world, scale, pt_mat), (0, None, None, None), 1
        else:
            pt = pt_mat * torch.rand((v, 1, 1), generator=g).cuda()
            vargs, dims, launched = (jc.joint_pos, world, scale, pt), (None, None, None, 0), v
        got = torch.func.vmap(through(False), in_dims=dims)(*vargs)
        want = torch.stack([through(True)(*(a if d is None else a[k]
                                            for a, d in zip(vargs, dims))) for k in range(v)])
        close(got, want)
    assert jac_ops.launches == before + launched


# K6's projection form against its plain form, of max|J|: the same float32
# chain in another order (p_eye by R·p + t, the derivative's products), as K6
PROJECTION_TOL = 2e-6


def _projection_close(out, args, block=1024):
    """out against the plain form, `block` elements at a time (the plain
    form's (B, K, C, 2, P) intermediates at B = 16384 would not fit)."""
    from momentum_tpu_torch.ops import jacobian as jac_ops

    jc, world, parents, pt, rot, trans, params, scale = args
    worst = top = 0.0
    for i in range(0, world.shape[0], block):
        sl = slice(i, i + block)
        part = dataclasses.replace(jc, joint_pos=jc.joint_pos[sl], trans_axis=jc.trans_axis[sl],
                                   rot_axis=jc.rot_axis[sl])
        ref = jac_ops.projection_jacobian_model_plain(part, world[sl], parents, pt, rot, trans,
                                                      params, scale[sl])
        worst = max(worst, float((out[sl] - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    assert worst <= PROJECTION_TOL * top, (worst, top)


@pytest.mark.parametrize("rig,batch,cameras,tiled", [
    ("cmu41", 256, 31, False), ("cmu41", 256, 1, False), ("fullbody", 256, 5, True),
    ("cmu41", 16384, 31, False)], ids=["k31", "k1", "tiled", "cell_b16384"])
def test_projection_jacobian_kernel_matches_plain(rig, batch, cameras, tiled):
    """K6's projection form: K cameras' pixel rows of the rig's locators at
    (B = 256, C = 41, K = 31, P = 73), at K = 1, on the full-body rig
    (C = 80, P = 157) in several column tiles, and at the multi-view cell's
    B = 16384 (J 12.2 GB) against the plain form in blocks. One launch a
    call; the scales' zeros give rows of zeros."""
    from momentum_tpu_torch.ops import jacobian as jac_ops

    char = _k6_rig(rig)
    args = workloads.projection_jacobian_inputs(char, batch, cameras, seed=batch + cameras)
    jc, world, parents, pt, rot, trans, params, scale = args
    nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt.shape[1]
    assert (jac_ops.projection_jacobian_tile(nj, c, cameras, p) < p) == tiled
    before = jac_ops.projection_launches
    out = jac_ops.projection_jacobian_model(*args)
    assert jac_ops.projection_launches == before + 1
    assert out.shape == (batch, 2 * cameras * c, p)
    zero = (scale == 0).reshape(batch, cameras * c)
    assert bool((out.reshape(batch, cameras * c, 2, p)[zero] == 0).all())
    _projection_close(out, args)


def test_projection_modules_take_one_launch_an_evaluation(monkeypatch):
    """31 cameras' modules over one locator table, as the multi-view cell
    and the tracker build them: one launch of the projection form and no K6
    an evaluation of the solver function, the rows the modules' own in
    their order and J the plain form's."""
    from momentum_tpu_torch.camera import Camera, OpenCVIntrinsics, PinholeIntrinsics
    from momentum_tpu_torch.errors import CameraProjectionErrorFunction
    from momentum_tpu_torch.ops import jacobian as jac_ops
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    char = _k6_rig("cmu41")
    loc = char.locators
    n = loc.num_locators
    cams = []
    for k in range(31):
        az = 2 * np.pi * k / 31
        intr = (PinholeIntrinsics.create(1400.0, 1400.0, 960.0, 540.0, device="cuda") if k % 4 == 0
                else OpenCVIntrinsics.create(1400.0, 1400.0, 960.0, 540.0,
                                             k=(-0.2, 0.1, 0.01, 0.0, 0.0, 0.0),
                                             p=(5e-4, -5e-4), device="cuda"))
        cams.append(Camera.create(intr).look_at((2.75 * np.cos(az), 2.75 * np.sin(az), 1.8),
                                                (0.0, 0.0, 1.0), (0.0, 0.0, 1.0)))
    g = torch.Generator(device="cpu").manual_seed(31)
    x = (0.2 * torch.randn(512, char.num_model_parameters, generator=g)).cuda()
    x[:, 2] += 0.9
    first = CameraProjectionErrorFunction.create(cams[0], loc.parent.cpu().numpy(),
                                                 loc.offset.cpu().numpy(), np.zeros((n, 2)),
                                                 device="cuda")
    mods = tuple(dataclasses.replace(
        first, camera=c, target=(960 + 300 * torch.randn(512, n, 2, generator=g)).cuda(),
        cweight=(torch.rand(512, n, generator=g) > 0.1).float().cuda()) for c in cams)
    fn = SkeletonSolverFunction(char, mods)
    before, k6 = jac_ops.projection_launches, jac_ops.launches
    rows, j = fn.residual_and_jacobian(x)
    assert jac_ops.projection_launches == before + 1 and jac_ops.launches == k6
    ctx = fn.context(x)
    torch.testing.assert_close(rows, torch.cat([m.residual(char, ctx) for m in mods], -1),
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(rows, fn.residual(x), rtol=0, atol=0)
    monkeypatch.setattr(jac_ops, "kernel_takes", lambda *args: False)
    _, j_plain = fn.residual_and_jacobian(x)
    assert jac_ops.projection_launches == before + 1
    torch.testing.assert_close(j, j_plain, rtol=0,
                               atol=PROJECTION_TOL * float(j_plain.abs().max()))


def test_config_6k_keypoint_solves_match_jax_cpu():
    """Config 6k (config 6s's clip with four cameras' keypoints: pinhole, two
    OpenCV, fisheye) through chip_smoke's keypoint phase: the batched stage
    and the smoothed refine, whose analytic cameras now take the projection
    Jacobian, within chip_smoke's tolerances of JAX CPU's marker and
    reprojection errors (tools/jax_reference_6k.json)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    counts, numbers, _ = chip_smoke.phase_keypoints(torch.cuda.get_device_name())
    assert set(numbers) >= {"batched", "refine"}
