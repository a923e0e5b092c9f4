"""Structured linear algebra of the sequence solve, after
momentum_tpu/sequence/block_tridiag.py: the block-banded normal equations
are solved directly (the reference's SequenceCholeskySolverT,
sequence_cholesky_solver.h:20-60, forms banded normal equations too).

  * block_tridiag_solve: the dispatch, as the JAX package's by default:
    SPIKE partitioning for F ≥ 128 frames (K batched local Thomas scans and
    a small interface system), the sequential Thomas scan below it.
  * banded_to_tridiag: aggregates a half-bandwidth-q block-banded system
    into a block-tridiagonal one of (q·p)-sized superblocks.
  * schur_arrowhead_solve: eliminates the per-frame blocks against the
    shared "universal" parameters (the arrowhead,
    sequence_solver_function.h:31-131).

Every SPD solve goes through math/linalg.py::psd_solve: CUDA float32
systems launch damped_chol_solve_kernel (K2+K3) with their matrix
right-hand sides, float64 and CPU tensors take the plain Cholesky. The
SPIKE interface system is a general LU (torch.linalg.solve_ex), outside any
kernel in JAX too. The JAX scans are Python loops over tensors; each loop
lies inside one span (utils/profiling.py): `sequence.spike_local` (the
chunks' systems and their batched Thomas scans), `sequence.spike_interface`
(the interface LU and each chunk's rows), `sequence.schur` (the arrowhead
step), `sequence.thomas` (a scan outside SPIKE) and `sequence.superblocks`.
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.math.linalg import psd_solve
from momentum_tpu_torch.utils.profiling import profile_scope, spanned

__all__ = ["block_tridiag_solve", "block_tridiag_solve_thomas",
           "block_tridiag_solve_partitioned", "banded_to_tridiag", "schur_arrowhead_solve"]

# the JAX package's defaults (its MOMENTUM_TPU_SPIKE_* knobs are not ported):
# SPIKE from 128 frames, at most 64 parts of at least 32 frames each
SPIKE_MIN_FRAMES = 128
SPIKE_PARTS = 64
SPIKE_CHUNK = 32


def block_tridiag_solve(diag: torch.Tensor, upper: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Solve a symmetric positive-definite block-tridiagonal system.

    diag (F, p, p) the diagonal blocks A_f; upper (F-1, p, p) the blocks
    B_f = H[f, f+1] (so H[f+1, f] = B_fᵀ); rhs (F, p, k). Returns x (F, p, k).
    SPIKE with min(64, max(2, F // 32)) parts for F ≥ 128, else Thomas."""
    f = diag.shape[0]
    if f >= SPIKE_MIN_FRAMES:
        parts = min(SPIKE_PARTS, max(2, f // SPIKE_CHUNK))
        return block_tridiag_solve_partitioned(diag, upper, rhs, parts)
    return block_tridiag_solve_thomas(diag, upper, rhs)


@spanned("sequence.thomas")
def block_tridiag_solve_thomas(diag: torch.Tensor, upper: torch.Tensor,
                               rhs: torch.Tensor) -> torch.Tensor:
    """Block Thomas: forward Schur elimination, then back substitution,
    frame by frame (each step dense p×p work)."""
    return _thomas(diag, upper, rhs)


def _block_tridiag_solve_thomas_batched(diag, upper, rhs):
    """Block Thomas over K independent chains: diag (K, F, p, p), upper
    (K, F-1, p, p), rhs (K, F, p, k) -> x (K, F, p, k). Each step's
    factorization is one batched (K, p, p) psd_solve with a matrix
    right-hand side, so the SPIKE locals ride K2+K3 as in JAX (:127)."""
    return _thomas(diag.movedim(1, 0), upper.movedim(1, 0), rhs.movedim(1, 0)).movedim(0, 1)


def _thomas(diag, upper, rhs):
    """The Thomas recursion over the leading (frame) axis of diag (F, ..., p, p),
    upper (F-1, ..., p, p), rhs (F, ..., p, k).

    forward:  S_0 = A_0, y_0 = b_0;
              S_f = A_f − B_{f-1}ᵀ S_{f-1}⁻¹ B_{f-1},  y_f = b_f − B_{f-1}ᵀ S_{f-1}⁻¹ y_{f-1}
    backward: x_{F-1} = S⁻¹ y;  x_f = S_f⁻¹ (y_f − B_f x_{f+1})"""
    f_total = diag.shape[0]
    if f_total == 1:
        return psd_solve(diag[0], rhs[0])[None]
    p = diag.shape[-1]
    s_all, y_all = [diag[0]], [rhs[0]]
    for f in range(1, f_total):
        b_prev = upper[f - 1]
        w = psd_solve(s_all[-1], torch.cat([b_prev, y_all[-1]], dim=-1))
        btp = b_prev.transpose(-1, -2)
        s_all.append(diag[f] - btp @ w[..., :p])
        y_all.append(rhs[f] - btp @ w[..., p:])
    xs = [psd_solve(s_all[-1], y_all[-1])]
    for f in range(f_total - 2, -1, -1):
        xs.append(psd_solve(s_all[f], y_all[f] - upper[f] @ xs[-1]))
    return torch.stack(xs[::-1])


def _lu_solve(a, b):
    """x with a x = b by LU with partial pivoting: jnp.linalg.solve's
    semantics (a singular a gives non-finite x, no error), so the host does
    not wait for the device's error check."""
    return torch.linalg.solve_ex(a, b)[0]


def _block_tridiag_solve_lu(diag, lower, upper, rhs):
    """General (nonsymmetric) block-tridiagonal LU-Thomas solve: diag (G, n, n),
    lower (G-1, n, n) = H[s, s-1], upper (G-1, n, n) = H[s, s+1], rhs
    (G, n, k). Small G: the SPIKE interface system."""
    g_count = diag.shape[0]
    if g_count == 1:
        return _lu_solve(diag[0], rhs[0])[None]
    n = diag.shape[-1]
    s_all, y_all = [diag[0]], [rhs[0]]
    for s in range(1, g_count):
        w = _lu_solve(s_all[-1], torch.cat([upper[s - 1], y_all[-1]], dim=-1))
        s_all.append(diag[s] - lower[s - 1] @ w[:, :n])
        y_all.append(rhs[s] - lower[s - 1] @ w[:, n:])
    xs = [_lu_solve(s_all[-1], y_all[-1])]
    for s in range(g_count - 2, -1, -1):
        xs.append(_lu_solve(s_all[s], y_all[s] - upper[s] @ xs[-1]))
    return torch.stack(xs[::-1])


def block_tridiag_solve_partitioned(diag: torch.Tensor, upper: torch.Tensor,
                                    rhs: torch.Tensor, partitions: int = 8) -> torch.Tensor:
    """SPIKE-partitioned solve of the SPD block-tridiagonal system.

    The F frames split into K chunks of M; each chunk runs the Thomas scan
    locally, all K batched, against [rhs | left spike | right spike]; a
    small nonsymmetric interface system over the 2K chunk-boundary unknowns
    couples them. Chunk s's rows are x = g − V·x_{s-1,last} − W·x_{s+1,first}
    with g = T_s⁻¹ b, V = T_s⁻¹(e_0 ⊗ C_leftᵀ), W = T_s⁻¹(e_{M-1} ⊗ C_right)
    (C_left = upper[sM−1], C_right = upper[(s+1)M−1])."""
    f = diag.shape[0]
    kp = int(partitions)
    if kp <= 1 or f < 2 * kp:
        return block_tridiag_solve_thomas(diag, upper, rhs)
    with profile_scope("sequence.spike_local"):
        dd, uu, big = _spike_local_systems(diag, upper, rhs, kp)
        sol = _block_tridiag_solve_thomas_batched(dd, uu, big)
    return _spike_interface_solve(sol, rhs.shape[-1])[:f]


def _spike_local_systems(diag, upper, rhs, kp):
    """The K = kp chunks' systems (diag (K, M, p, p), upper (K, M-1, p, p),
    [rhs | left spike | right spike] (K, M, p, k + 2p)), F padded to K·M
    with identity blocks."""
    f, p, k = diag.shape[0], diag.shape[-1], rhs.shape[-1]
    m = -(-f // kp)  # chunk length
    pad = kp * m - f
    if pad:
        eye = torch.eye(p, dtype=diag.dtype, device=diag.device).expand(pad, p, p)
        diag = torch.cat([diag, eye])
        rhs = torch.cat([rhs, rhs.new_zeros((pad, p, k))])
    up_pad = torch.cat([upper, diag.new_zeros((pad + 1, p, p))])
    uu_full = up_pad.reshape(kp, m, p, p)
    c_right = uu_full[:, m - 1]  # (K, p, p); the last is zero
    c_left = torch.cat([diag.new_zeros((1, p, p)), c_right[:-1]])
    big = rhs.new_zeros((kp, m, p, k + 2 * p))
    big[..., :k] = rhs.reshape(kp, m, p, k)
    big[:, 0, :, k:k + p] = c_left.transpose(-1, -2)
    big[:, m - 1, :, k + p:] = c_right
    return diag.reshape(kp, m, p, p), uu_full[:, :m - 1], big


@spanned("sequence.spike_interface")
def _spike_interface_solve(sol, k):
    """x (K·M, p, k) from the local solutions sol (K, M, p, k + 2p) =
    [g | V | W]: the interface system over z_s = [x_{s,first}; x_{s,last}]
    (2p each) by LU, then each chunk's rows."""
    kp, m, p = sol.shape[:3]
    g = sol[..., :k]  # (K, M, p, k)
    v = sol[..., k:k + p]  # left spikes
    w = sol[..., k + p:]  # right spikes
    two_p = 2 * p
    d_int = torch.eye(two_p, dtype=sol.dtype, device=sol.device).expand(kp, two_p, two_p)
    lower = sol.new_zeros((kp - 1, two_p, two_p))
    upper_i = sol.new_zeros((kp - 1, two_p, two_p))
    # L_s couples z_{s-1} through the columns of x_{s-1,last} (second half)
    lower[:, :p, p:] = v[1:, 0]
    lower[:, p:, p:] = v[1:, m - 1]
    # U_s couples z_{s+1} through the columns of x_{s+1,first} (first half)
    upper_i[:, :p, :p] = w[:-1, 0]
    upper_i[:, p:, :p] = w[:-1, m - 1]
    rhs_int = torch.cat([g[:, 0], g[:, m - 1]], dim=1)  # (K, 2p, k)

    z = _block_tridiag_solve_lu(d_int, lower, upper_i, rhs_int)  # (K, 2p, k)
    xf, xl = z[:, :p], z[:, p:]  # x_{s,first}, x_{s,last}
    xl_prev = torch.cat([z.new_zeros((1, p, k)), xl[:-1]])
    xf_next = torch.cat([xf[1:], z.new_zeros((1, p, k))])
    x = (g - torch.einsum("smpq,sqk->smpk", v, xl_prev)
         - torch.einsum("smpq,sqk->smpk", w, xf_next))
    return x.reshape(kp * m, p, k)


@spanned("sequence.superblocks")
def banded_to_tridiag(diag: torch.Tensor, offs: list):
    """Aggregate a half-bandwidth-q block-banded SPD system into a
    block-tridiagonal system of (q·p)-sized superblocks.

    diag (F, p, p); offs[k-1] (F-k, p, p) = H[f, f+k] for k = 1..q. F must
    be a multiple of q (the caller pads with identity diagonal blocks and
    zero right-hand sides). Returns (super_diag (G, qp, qp), super_upper
    (G-1, qp, qp)) with G = F // q."""
    q = len(offs)
    f_total, p, _ = diag.shape
    if f_total % q:
        raise ValueError("pad the frame count to a multiple of the bandwidth")
    g = f_total // q
    qp = q * p
    # block (i, j) of superframe s is H[s*q+i, s*q+j]
    sup_diag = diag.new_zeros((g, qp, qp))
    for i in range(q):
        sup_diag[:, i * p:(i + 1) * p, i * p:(i + 1) * p] = diag[i::q][:g]
    for k in range(1, q):
        blocks = offs[k - 1]
        for i in range(q - k):
            j = i + k
            b = blocks[i::q][:g]
            sup_diag[:, i * p:(i + 1) * p, j * p:(j + 1) * p] = b
            sup_diag[:, j * p:(j + 1) * p, i * p:(i + 1) * p] = b.transpose(-1, -2)
    # coupling superblock (s, s+1): H[s*q+i, (s+1)*q+j] is nonzero when
    # j ≤ i, at offset k = q - i + j
    sup_upper = diag.new_zeros((max(g - 1, 0), qp, qp))
    for i in range(q):
        for j in range(q):
            k = q - i + j
            if 1 <= k <= q:
                sup_upper[:, i * p:(i + 1) * p, j * p:(j + 1) * p] = offs[k - 1][i::q][:g - 1]
    return sup_diag, sup_upper


@spanned("sequence.schur")
def schur_arrowhead_solve(diag: torch.Tensor, upper: torch.Tensor, u_coupling: torch.Tensor,
                          u_block: torch.Tensor, rhs_f: torch.Tensor, rhs_u: torch.Tensor):
    """Solve [[T, U], [Uᵀ, S]] [x_f; x_u] = [b_f; b_u] with T block-tridiagonal:
    diag (F, p, p), upper (F-1, p, p), u_coupling U (F, p, nu), u_block S
    (nu, nu), rhs_f (F, p), rhs_u (nu,).

    x_u = (S − Uᵀ T⁻¹ U)⁻¹ (b_u − Uᵀ T⁻¹ b_f), then x_f = T⁻¹ (b_f − U x_u):
    one banded solve with nu + 1 right-hand sides and one dense nu × nu
    solve (the reference serializes the common columns' QR updates,
    online_householder_qr.h:369-410)."""
    nu = u_coupling.shape[-1]
    rhs = torch.cat([u_coupling, rhs_f[..., None]], dim=-1)  # (F, p, nu+1)
    sol = block_tridiag_solve(diag, upper, rhs)
    t_inv_u = sol[..., :nu]  # (F, p, nu)
    t_inv_b = sol[..., nu]  # (F, p)
    ut_tinv_u = torch.einsum("fpu,fpv->uv", u_coupling, t_inv_u)
    ut_tinv_b = torch.einsum("fpu,fp->u", u_coupling, t_inv_b)
    x_u = psd_solve(u_block - ut_tinv_u, rhs_u - ut_tinv_b)
    x_f = t_inv_b - torch.einsum("fpu,u->fp", t_inv_u, x_u)
    return x_f, x_u
