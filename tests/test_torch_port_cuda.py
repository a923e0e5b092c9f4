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
from momentum_tpu_torch.ops import fk as fk_ops, psd, raster
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
