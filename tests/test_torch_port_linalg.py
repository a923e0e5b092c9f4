"""Parity of the port's damped SPD solve (the plain path of kernel K2+K3)
with momentum_tpu on the CPU: against the JAX CPU solve and against the
Pallas panel kernels (ops/psd_pallas.py) in interpret mode, as
tests/test_psd_pallas.py runs them.

Solves are compared by relative residual ‖(A + D)x − b‖/‖b‖ ≤ 1e-4, not by
raw x: reassociation alone moves x of an ill-conditioned system (ROADMAP
F5). An indefinite system gives NaN in both packages (ROADMAP F1).

`_kernel_model` rehearses damped_chol_solve_kernel's blocked arithmetic
(csrc/psd.cu) on the CPU, and `_subst_model` damped_chol_subst_kernel's (the
matrix right-hand side after the factor), so that their index arithmetic is
pinned before the card runs them: nothing on the port's path calls them."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.math import linalg as jlinalg
from momentum_tpu.ops.psd_pallas import psd_solve_pallas
from momentum_tpu_torch.math import linalg as tlinalg
from momentum_tpu_torch.ops import psd
from test_torch_port_helpers import one_torch_thread  # noqa: F401

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
    """A (..., n, k) right-hand side is solved (ROADMAP F7); one whose rows
    do not match a's n, or with extra dimensions, is refused."""
    a, damp, b = _system(rng, 2, 8)
    with pytest.raises(ValueError):
        tlinalg.psd_solve(torch.as_tensor(a), torch.zeros(2, 9, 3))
    with pytest.raises(ValueError):
        tlinalg.psd_solve(torch.as_tensor(a), torch.zeros(2, 8, 3, 1))
    x = tlinalg.psd_solve(torch.as_tensor(a), torch.as_tensor(b)[..., None].expand(2, 8, 3))
    assert x.shape == (2, 8, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [225, 40])
@pytest.mark.parametrize("k", [None, 3], ids=["vector", "matrix"])
@pytest.mark.parametrize("damped", [True, False], ids=["damped_psd_solve", "psd_solve"])
def test_large_f64_and_matrix_solves_match_jax(rng, dtype, n, k, damped):
    """ROADMAP F7: n = 225 (past the kernel's shared memory), float64 and
    (B, n, k) right-hand sides solve as JAX's psd_solve solves them, by
    relative residual ≤ 1e-4 per column (ROADMAP F5); x agrees to 1e-4 of
    max|x|. JAX runs in float32 here."""
    a, damp, b = _system(rng, 4, n)
    if k is not None:
        b = np.stack([b, 2 * b + 1, -b], axis=-1)[..., :k]
    if not damped:
        a = a + np.einsum("bi,ij->bij", damp, np.eye(n)).astype(np.float32)
        damp = np.zeros_like(damp)
    a, damp, b = (v.astype(dtype) for v in (a, damp, b))
    ta, td, tb = (torch.as_tensor(v) for v in (a, damp, b))
    x_t = (tlinalg.damped_psd_solve(ta, td, tb) if damped else tlinalg.psd_solve(ta, tb)).numpy()
    assert x_t.shape == b.shape and x_t.dtype == dtype
    a_j = a + np.einsum("bi,ij->bij", damp, np.eye(n))
    x_j = np.asarray(jlinalg.psd_solve(jnp.asarray(a_j, jnp.float32), jnp.asarray(b, jnp.float32)))
    cols = (lambda v: v[..., None]) if k is None else (lambda v: v)
    for x in (x_t, x_j):
        for c in range(cols(b).shape[-1]):
            assert np.max(_relres(a, damp, cols(b)[..., c], cols(x)[..., c])) <= RELRES_TOL
    scale = np.max(np.abs(x_j))
    np.testing.assert_allclose(x_t / scale, x_j / scale, atol=1e-4)


def test_domain_rule_sends_cpu_systems_to_the_plain_solve(rng):
    """ROADMAP F7: `kernel_takes` is false for CPU tensors, whatever their
    dtype, n or right-hand side, decided without building the kernel; a
    matrix right-hand side solves there through the plain version."""
    a, damp, b = (torch.as_tensor(v) for v in _system(rng, 2, 16))
    for aa, bb in ((a, b), (a.double(), b.double()), (a, b[..., None])):
        assert not psd.kernel_takes(aa, bb)
    bm = torch.stack([b, -b], dim=-1)
    x = psd.damped_chol_solve(a, damp, bm)
    assert x.shape == bm.shape and psd.launches == 0
    np.testing.assert_array_equal(x[..., 1].numpy(), -x[..., 0].numpy())


def test_cpu_wrapper_takes_the_plain_path(rng):
    a, damp, b = (torch.as_tensor(v) for v in _system(rng, 4, 20))
    before = psd.launches
    x = psd.damped_chol_solve(a, damp, b)
    np.testing.assert_array_equal(x.numpy(), psd.damped_chol_solve_plain(a, damp, b).numpy())
    assert psd.launches == before == 0


PANEL = 32  # csrc/psd.cu kPanel


def _factor_model(a, damp):
    """damped_chol_solve_kernel's factor in float32 torch, batched: the system
    padded to m = ⌈n/32⌉·32 with identity rows and zero damping; per 32-wide
    panel the diagonal block's factor (column by column, pivots through
    rsqrt), its inverse Linv by forward substitution row by row,
    L21 = A21·Linvᵀ and the trailing update. Returns the (B, m, m) factor as
    the kernel leaves it (Linv on the diagonal blocks, zeros above their
    diagonal, L21 below them; above them what the panels left) and the F1
    flag: no pivot that is not > 0."""
    bsz, n = damp.shape
    m = -(-n // PANEL) * PANEL
    A = torch.zeros(bsz, m, m)
    A[:, :n, :n] = a + torch.diag_embed(damp)
    A[:, range(n, m), range(n, m)] = 1.0
    ok = torch.ones(bsz, dtype=torch.bool)
    eye = torch.eye(PANEL)
    for r0 in range(0, m, PANEL):
        t0 = r0 + PANEL
        blk = A[:, r0:t0, r0:t0].clone()
        low = torch.zeros(bsz, PANEL, PANEL)
        dinv = torch.zeros(bsz, PANEL)
        for k in range(PANEL):
            d = blk[:, k, k]
            ok &= d > 0
            dinv[:, k] = torch.rsqrt(d)
            col = blk[:, k:, k] * dinv[:, k, None]
            low[:, k:, k] = col
            blk[:, k + 1:, k + 1:] -= col[:, 1:, None] * col[:, None, 1:]
        linv = torch.zeros(bsz, PANEL, PANEL)
        for r in range(PANEL):
            s = eye[r] - (low[:, r, :r, None] * linv[:, :r, :]).sum(dim=1)
            linv[:, r] = s * dinv[:, r, None]
        A[:, r0:t0, r0:t0] = linv  # L11 is never read again
        l21 = A[:, t0:, r0:t0] @ linv.transpose(-1, -2)
        A[:, t0:, r0:t0] = l21
        A[:, t0:, t0:] -= l21 @ l21.transpose(-1, -2)
    return A, ok


def _kernel_model(a, damp, b):
    """damped_chol_solve_kernel's arithmetic for a vector right-hand side:
    `_factor_model`, the right-hand side padded with zeros, then the Linv
    substitutions. A pivot that is not > 0 gives an all-NaN x (ROADMAP F1)."""
    bsz, n = b.shape
    A, ok = _factor_model(a, damp)
    m = A.shape[-1]
    y = torch.zeros(bsz, m)
    y[:, :n] = b
    for r0 in range(0, m, PANEL):  # y_k = Linv_k·(b_k − Σ_{j<k} L_kj y_j)
        t0 = r0 + PANEL
        y[:, r0:t0] = (A[:, r0:t0, r0:t0] @ y[:, r0:t0, None])[..., 0]
        y[:, t0:] -= (A[:, t0:, r0:t0] @ y[:, r0:t0, None])[..., 0]
    for r0 in range(m - PANEL, -1, -PANEL):  # x_k = Linv_kᵀ·(y_k − Σ_{j>k} L_jkᵀ x_j)
        t0 = r0 + PANEL
        y[:, r0:t0] = (A[:, r0:t0, r0:t0].transpose(-1, -2) @ y[:, r0:t0, None])[..., 0]
        y[:, :r0] -= (A[:, r0:t0, :r0].transpose(-1, -2) @ y[:, r0:t0, None])[..., 0]
    assert (y[:, n:][ok] == 0).all()  # the padded unknowns are exactly 0
    return torch.where(ok[:, None], y[:, :n], torch.nan)


KC = 32  # csrc/psd.cu kCols: right-hand-side columns a substitution block owns


def _symmetric_factor(A):
    """The factor as damped_chol_solve_kernel<·, kFactorOnly> hands it on:
    below and on the diagonal blocks as factored, above them its transpose."""
    m = A.shape[-1]
    panel = torch.arange(m) // PANEL
    below = panel[:, None] >= panel[None, :]
    return torch.where(below, A, A.transpose(-1, -2))


def _subst_model(F, ok, b, kc=KC):
    """damped_chol_subst_kernel's arithmetic in float32 torch: for each tile
    of kc columns of b (B, n, k), the last one ragged, the (m, kc) tile with
    zero padding; forward per panel Y = Linv·T[r0:t0] and the right-looking
    update T[t0:] −= F[r0:t0, t0:]ᵀ·Y; back X = Linvᵀ·T[r0:t0] and
    T[:r0] −= F[r0:t0, :r0]ᵀ·X. Both updates read the panel's rows of the
    symmetric factor F. A system whose flag is down gets all-NaN columns
    (ROADMAP F1)."""
    bsz, n, k = b.shape
    m = F.shape[-1]
    x = torch.empty(bsz, n, k)
    for c0 in range(0, k, kc):
        cols = min(kc, k - c0)
        T = torch.zeros(bsz, m, kc)
        T[:, :n, :cols] = b[..., c0:c0 + cols]
        for r0 in range(0, m, PANEL):  # L y = b
            t0 = r0 + PANEL
            T[:, r0:t0] = F[:, r0:t0, r0:t0] @ T[:, r0:t0]
            T[:, t0:] -= F[:, r0:t0, t0:].transpose(-1, -2) @ T[:, r0:t0]
        for r0 in range(m - PANEL, -1, -PANEL):  # Lᵀ x = y
            t0 = r0 + PANEL
            T[:, r0:t0] = F[:, r0:t0, r0:t0].transpose(-1, -2) @ T[:, r0:t0]
            T[:, :r0] -= F[:, r0:t0, :r0].transpose(-1, -2) @ T[:, r0:t0]
        assert (T[:, n:][ok] == 0).all() and (T[:, :, cols:][ok] == 0).all()
        x[..., c0:c0 + cols] = T[:, :n, :cols]
    return torch.where(ok[:, None, None], x, torch.nan)


def _matrix_system(rng, b_sz, n, k):
    a, damp, b = _system(rng, b_sz, n)
    cols = rng.normal(size=(b_sz, n, k)).astype(np.float32)
    return a, damp, cols


@pytest.mark.parametrize("n", [157, 33, 1, 32, 64, 169, 224])
def test_kernel_model_matches_pallas_and_plain(rng, n):
    """At the rig's n, a ragged last panel of one row, one unknown, one panel
    with no lookahead (32), two panels (64), six with a ragged last (169,
    config G's) and the largest n of the second form's shared memory (224):
    the blocked arithmetic solves as well as JAX's panel kernels (interpret
    mode) and the plain version."""
    a, damp, b = _system(rng, 32, n)
    x_m = _kernel_model(*(torch.as_tensor(v) for v in (a, damp, b))).numpy()
    x_p = np.asarray(psd_solve_pallas(jnp.asarray(a), jnp.asarray(b),
                                      damp_diag=jnp.asarray(damp), interpret=True))
    x_t = psd.damped_chol_solve_plain(*(torch.as_tensor(v) for v in (a, damp, b))).numpy()
    for x in (x_m, x_p, x_t):
        assert np.max(_relres(a, damp, b, x)) <= RELRES_TOL
    scale = np.max(np.abs(x_t))
    np.testing.assert_allclose(x_m / scale, x_t / scale, atol=1e-4)


@pytest.mark.parametrize("pivot", [70, 150, 40])
def test_kernel_model_nan_on_failed_pivot(rng, pivot):
    """ROADMAP F1 in the blocked order: a pivot that fails in the third panel
    (row 70), in the ragged last one (row 150 of 157) or in the second (row
    40, which the kernel's lookahead factors under the first panel's trailing
    update) gives an all-NaN x for that system alone, as in the plain
    version."""
    a, damp, b = (torch.as_tensor(v) for v in _system(rng, 4, 157))
    a[2, pivot, pivot] = -1e3
    for x in (_kernel_model(a, damp, b), psd.damped_chol_solve_plain(a, damp, b)):
        assert torch.isnan(x[2]).all()
        assert torch.isfinite(x[[0, 1, 3]]).all()


@pytest.mark.parametrize("b_sz, n, k", [(32, 157, 33), (32, 23, 70), (3, 33, 2)],
                         ids=["n157_k33", "n23_k70", "n33_k2"])
def test_subst_model_matches_pallas_and_plain(rng, b_sz, n, k):
    """The matrix right-hand side's two kernels: at the rig's n with 33
    columns (a second, one-column tile), config 5's SPIKE shape (three tiles,
    the last ragged) and a ragged panel with two columns. Held against JAX's
    psd_solve_pallas with a (B, n, k) right-hand side (K2 in interpret mode,
    then _solve_panels) and against the plain version, by relative residual
    per column and to 1e-4 of max|x|. JAX's panel kernel takes whole groups
    of 32 systems: a smaller batch goes to it repeated to 32."""
    a, damp, b = _matrix_system(rng, b_sz, n, k)
    F, ok = _factor_model(torch.as_tensor(a), torch.as_tensor(damp))
    assert ok.all()
    x_m = _subst_model(_symmetric_factor(F), ok, torch.as_tensor(b)).numpy()
    whole = [np.resize(v, (32,) + v.shape[1:]) for v in (a, damp, b)]
    x_p = np.asarray(psd_solve_pallas(jnp.asarray(whole[0]), jnp.asarray(whole[2]),
                                      damp_diag=jnp.asarray(whole[1]), interpret=True))[:b_sz]
    x_t = psd.damped_chol_solve_plain(*(torch.as_tensor(v) for v in (a, damp, b))).numpy()
    for x in (x_m, x_p, x_t):
        assert x.shape == b.shape
        for c in range(k):
            assert np.max(_relres(a, damp, b[..., c], x[..., c])) <= RELRES_TOL
    scale = np.max(np.abs(x_t))
    np.testing.assert_allclose(x_m / scale, x_t / scale, atol=1e-4)
    np.testing.assert_allclose(x_m / scale, x_p / scale, atol=1e-4)


def test_subst_model_nan_on_failed_pivot(rng):
    """ROADMAP F1 in the matrix form: a pivot that fails in the fourth panel
    (row 100 of 157) gives every one of that system's 40 columns (two tiles)
    NaN, and no other system's, as in the plain version."""
    a, damp, b = (torch.as_tensor(v) for v in _matrix_system(rng, 4, 157, 40))
    a[1, 100, 100] = -1e3
    F, ok = _factor_model(a, damp)
    assert ok.tolist() == [True, False, True, True]
    for x in (_subst_model(_symmetric_factor(F), ok, b), psd.damped_chol_solve_plain(a, damp, b)):
        assert torch.isnan(x[1]).all()
        assert torch.isfinite(x[[0, 2, 3]]).all()


# damped_chol_solve_kernel's shared-memory layout and the order in which its
# warps share the factor's work (csrc/psd.cu), mirrored so that their index
# arithmetic is pinned on the CPU.
LDB = 36  # kLdb: floats a row of a packed 32 × 32 block
BLOCK = PANEL * LDB  # kBlock
MAX_SHARED_N = 288  # kMaxSharedN
MAX_SMEM = 232448  # kMaxSmem: bytes of shared memory a block can have
SM_SMEM = 233472  # bytes of shared memory an H100 SM has for its blocks
WARPS = 8


def _packed(i, j):
    """Mat<true>::at: the float offset of entry (i, j) of the lower block
    triangle (j < 32·⌊i/32⌋ + 32) in shared memory."""
    bi = i // PANEL
    return (bi * (bi + 1) // 2 + j // PANEL) * BLOCK + (i % PANEL) * LDB + j % PANEL


def _smem_bytes(n, factor_only):
    """smem_bytes: the packed triangle and, for the fused form, m floats of
    right-hand side, up to MAX_SHARED_N."""
    nb = -(-n // PANEL)
    rhs = 0 if factor_only else nb * PANEL
    return 4 * (nb * (nb + 1) // 2 * BLOCK + rhs if n <= MAX_SHARED_N else rhs)


def _triangle_block(q):
    """Block (r, c) of the q-th entry of a lower block triangle by rows, as the
    kernel decodes it: r = ⌊(√(8q + 1) − 1)/2⌋ in float32."""
    f = np.float32
    r = int((np.sqrt(f(8) * f(q) + f(1), dtype=f) - f(1)) * f(0.5))
    return r, q - r * (r + 1) // 2


def _panel_units(nb, p):
    """The units (I, J, half) of panel p's trailing update that each warp
    takes: the next diagonal block's halves to warps 0 and 1, the other
    blocks' halves round-robin to warps 2–7."""
    units = {w: [] for w in range(WARPS)}
    t = p + 1
    units[0].append((t, t, 0))
    units[1].append((t, t, 1))
    rows = nb - 1 - p
    for u in range(rows * (rows + 1) - 2):
        r, c = _triangle_block(1 + (u >> 1))
        units[2 + u % (WARPS - 2)].append((t + r, t + c, u & 1))
    return units


@pytest.mark.parametrize("nb", range(2, MAX_SHARED_N // PANEL + 1))
def test_factor_units_cover_each_trailing_update_once(nb):
    """For every panel of a system of nb panels (up to n = 288), the units the
    warps take cover each half of each block of the trailing lower block
    triangle once, and warps 2–7 take equal shares to one unit."""
    for p in range(nb - 1):
        units = _panel_units(nb, p)
        taken = [u for w in range(WARPS) for u in units[w]]
        want = [(i, j, h) for j in range(p + 1, nb) for i in range(j, nb) for h in (0, 1)]
        assert sorted(taken) == sorted(want)
        shares = [len(units[w]) for w in range(2, WARPS)]
        assert max(shares) - min(shares) <= 1


def test_triangle_decode_is_exact():
    """The float32 square root decodes every entry of triangles up to the
    workspace form's 128 block rows (the factor-only hand-on's blocks)."""
    q = 0
    for r in range(128):
        for c in range(r + 1):
            assert _triangle_block(q) == (r, c)
            q += 1


@pytest.mark.parametrize("n", [1, 31, 32, 33, 157, 160, 169, 192, 224, 288])
def test_packed_layout(n):
    """The packed lower block triangle: every entry at its own offset inside
    the blocks, each block row 16-byte aligned; three systems of n ≤ 160 fit
    an SM's shared memory, and 288 is the largest n that fits a block's."""
    m = -(-n // PANEL) * PANEL
    nb = m // PANEL
    offsets = [_packed(i, j) for i in range(m) for j in range((i // PANEL + 1) * PANEL)]
    assert len(set(offsets)) == len(offsets)
    assert min(offsets) >= 0 and max(offsets) < nb * (nb + 1) // 2 * BLOCK
    assert all(_packed(i, j) % 4 == 0 for i in range(m) for j in range(0, i + 1, PANEL))
    for factor_only in (False, True):
        assert _smem_bytes(n, factor_only) <= MAX_SMEM
    if n <= 160:
        assert 3 * (_smem_bytes(n, False) + 1024 + 16) <= SM_SMEM
    assert 4 * (10 * 11 // 2 * BLOCK) > MAX_SMEM  # m = 320 does not fit


def _chunks_conflict_free(offsets):
    """Whether one 16-byte shared-memory load by the 32 lanes at these float
    offsets is served in one pass per phase of 8 lanes: within each phase,
    distinct 16-byte chunks lie in distinct groups of 4 banks."""
    for phase in range(4):
        chunks = {o // 4 for o in offsets[8 * phase:8 * phase + 8]}
        if len({c % 8 for c in chunks}) != len(chunks):
            return False
    return True


def test_factor_tile_loads_are_conflict_free():
    """The 16-byte loads of steps (a), (b) and (c) in the packed layout: (b)
    lane (rt, ct) reads rows i0 + rt + 4q of A21 and r0 + ct + 8q of Linv,
    (c) lane (rg, cg) rows i0 + rg + 8q and jc + cg + 4q of L21, (a) lane l
    its row l of the diagonal block; at every k-quad and q, in every block
    row of a system of n = 288."""
    lanes = range(32)
    for p in range(MAX_SHARED_N // PANEL):
        r0 = PANEL * p
        for i0 in range(r0 + PANEL, MAX_SHARED_N, 16):
            for q in range(4):
                for k in range(0, PANEL, 4):
                    assert _chunks_conflict_free([_packed(i0 + l // 8 + 4 * q, r0 + k) for l in lanes])
                    assert _chunks_conflict_free([_packed(r0 + l % 8 + 8 * q, r0 + k) for l in lanes])
        for i0 in range(r0, MAX_SHARED_N, PANEL):
            for jc in range(r0, i0 + 1, 16):
                for q in range(4):
                    for k in range(0, PANEL, 4):
                        assert _chunks_conflict_free(
                            [_packed(i0 + l // 4 + 8 * q, r0 + k) for l in lanes])
                        assert _chunks_conflict_free(
                            [_packed(jc + l % 4 + 4 * q, r0 + k) for l in lanes])
        for t in range(0, PANEL, 4):
            assert _chunks_conflict_free([_packed(r0 + l, r0 + t) for l in lanes])


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 40, 157, 169, 224, 288])
def test_each_diagonal_entry_damped_once_by_its_copier(n):
    """The load: row i goes to warp i mod 8 below row 32 and to warp
    2 + (i − 32) mod 6 past it, column j to lane j mod 32; the damping of
    (i, i) is added by the thread the kernel's predicates pick, which must be
    the one that copied the entry, and by no other."""
    n0 = min(n, PANEL)
    copier = {i: ((i % WARPS) if i < PANEL else 2 + (i - PANEL) % (WARPS - 2), i % 32)
              for i in range(n)}
    adders = {}
    for warp in range(WARPS):
        for lane in range(32):
            if lane & 7 == warp and lane < n0:  # after the first group is in
                adders.setdefault(lane, []).append((warp, lane))
            if warp >= 2:
                for c in range(1, MAX_SHARED_N // PANEL):
                    i = lane + PANEL * c
                    if i < n and (i - PANEL) % (WARPS - 2) == warp - 2:
                        adders.setdefault(i, []).append((warp, lane))
    assert adders == {i: [copier[i]] for i in range(n)}
