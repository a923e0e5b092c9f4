"""The sequence solve with its frames split over the ranks of a
`torch.distributed` group, after momentum_tpu/sequence/sharded.py (the
reference solves long takes on one machine with a banded QR, SURVEY.md
§2.9 / §5; JAX shards the frames over chips with shard_map).

Every rank passes the whole problem, as JAX's shard_map receives global
arrays; rank s owns frames [s·L, (s+1)·L). Jacobian assembly is parallel
over frames, the temporal band is solved by substructuring (block SPIKE),
and the shared universal parameters ride an all-reduce. The frame count
pads to a multiple of S·q with frames whose rows are masked to zero
(their tables repeat the last frame's, so they stay finite).

Assembly is owner-computes: a window is evaluated once, by the rank owning
its start frame, against a q-frame right halo (the next rank's first
frames, one cyclic shift). Its contributions to the next rank's frames
(the tail) are shipped right with a second shift and added into that
rank's head blocks. The shifts wrap around as JAX's ppermute does; what the
wrap brings is zeroed by the window mask (a window reaching past the last
real frame counts nothing) and by dropping the edge coupling into the
first rank and out of the last (JAX's not_first / not_last).

Per GN iteration:
  1. per rank: per-frame and window Jacobians → banded blocks of L + q
     frames, the tail shipped right;
  2. L frames aggregated into G = L/q superframes (qp-sized blocks); the
     coupling across a rank edge becomes one (qp, qp) superblock;
  3. local solves T_s⁻¹ [rhs | U_s | e_0·B_leftᵀ | e_{G-1}·B_edge] by
     block_tridiag_solve (K2+K3 on the card);
  4. the reduced SPIKE interface system in z = (x_{s,0}, x_{s,G-1} ∀s,
     x_u), of size 2·S·qp + nu, assembled from one all_gather, solved by
     LU on every rank from the same bytes, then local back-substitution.

The loop stops on `done`, computed from the all-reduced energy, which is
the same on every rank, so every rank issues the same collectives. As in
JAX, the sharded solve takes neither the line search nor the float64
normal equations. Spans (utils/profiling.py): `sharded.solve`,
`sharded.iteration`, and a `.sync` span on each of the solver's host syncs:
the test "done" (`sharded.sync`) and the tables and values copied from the
host (`sharded.index.sync`, `sharded.init.sync`, `sharded.result.sync`).
The collectives' own copies (parallel/collectives.py, through the host on
gloo) are not marked.
"""

from __future__ import annotations

import dataclasses

import torch

from momentum_tpu_torch.parallel import collectives as C
from momentum_tpu_torch.sequence.block_tridiag import (
    _lu_solve, banded_to_tridiag, block_tridiag_solve)
from momentum_tpu_torch.sequence.solver import (
    _EQUILIBRATED_DIAG_FLOOR, _EQUILIBRATED_JITTER, _EQUILIBRATED_JITTER_U,
    SequenceSolveResult, make_frame_jacobian, window_jacobian)
from momentum_tpu_torch.sequence.solver_function import SequenceSolverFunction
from momentum_tpu_torch.solver.gauss_newton import SolverOptions, _converged
from momentum_tpu_torch.utils.profiling import host_sync, profile_scope, spanned

__all__ = ["solve_sequence_sharded"]


def _bandwidth(fn: SequenceSolverFunction) -> int:
    """Half-bandwidth q = max window − 1 (sequence_solver.cpp:54-57)."""
    q = 1
    for sef in fn.sequence_errors:
        q = max(q, sef.window - 1)
    return q


def _shift_left(x, group):
    """Receive from the RIGHT neighbour (rank s gets rank s+1's tensors)."""
    return C.shift(x, 1, group)


def _shift_right(x, group):
    """Receive from the LEFT neighbour (rank s gets rank s-1's tensors)."""
    return C.shift(x, -1, group)


def _take_frames(modules: tuple, f_real: int, index: torch.Tensor) -> tuple:
    """The per-frame modules with each floating-point tensor field whose
    leading dim is f_real replaced by its rows `index`: the tables that the
    port's stack_frames stacks (per-constraint float tables, top-level
    fields). Index tables and nested objects are shared by the frames."""
    def take(t):
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.ndim >= 1
                and t.shape[0] == f_real):
            return t.index_select(0, host_sync("sharded.index", index.to, t.device))
        return t

    return tuple(dataclasses.replace(ef, **{f.name: take(getattr(ef, f.name))
                                            for f in dataclasses.fields(ef) if f.init})
                 for ef in modules)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """This rank's part of the problem: the local function (L frames of
    the padded count), the global index of its first frame, the real frame
    count, the bandwidth and the group."""

    fn: SequenceSolverFunction
    start: int
    f_real: int
    q: int
    group: object

    def frame_valid(self, device) -> torch.Tensor:
        """(L,) whether each local frame is a real one."""
        g = self.start + torch.arange(self.fn.num_frames, device=device)
        return g < self.f_real

    def window_valid(self, w: int, device) -> torch.Tensor:
        """(L,) whether the window of w frames starting at each local frame
        ends on a real frame."""
        g = self.start + torch.arange(self.fn.num_frames, device=device)
        return g <= self.f_real - w


def _masked(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """t (L, ...) with the rows of invalid frames zeroed."""
    return torch.where(valid.reshape((-1,) + (1,) * (t.ndim - 1)), t, 0.0)


def _local_normal_equations(shard: _Shard, pf_local: torch.Tensor, u: torch.Tensor):
    """Owner-computes banded assembly with a q-frame right halo.

    pf_local (L, p). Returns (diag (L, p, p), offs [d = 1..q: (L-d, p, p)],
    edge (qp, qp) coupling the last local superframe to the next rank's
    first, uc (L, p, nu), ublock (nu, nu), rhs (L, p), rhs_u (nu,))."""
    fn, q, group = shard.fn, shard.q, shard.group
    l_frames, p = pf_local.shape
    dev = pf_local.device

    # ---- per-frame modules, parallel over frames ----
    valid = shard.frame_valid(dev)
    rows, j_pf, j_u = (_masked(t, valid) for t in make_frame_jacobian(fn)(pf_local, u))
    le = l_frames + q  # local frames and the halo
    j_pf_t = j_pf.transpose(-1, -2)
    diag = torch.cat([j_pf_t @ j_pf, j_pf.new_zeros((q, p, p))])
    uc = torch.cat([j_pf_t @ j_u, j_u.new_zeros((q, p, j_u.shape[-1]))])
    rhs = torch.cat([(j_pf_t @ rows[..., None])[..., 0], rows.new_zeros((q, p))])
    offs = [diag.new_zeros((le, p, p)) for _ in range(q)]
    ublock = j_u.flatten(0, 1).T @ j_u.flatten(0, 1)
    rhs_u = j_u.flatten(0, 1).T @ rows.flatten()

    # ---- sequence modules: the windows starting at local frames ----
    if fn.sequence_errors:
        halo, = _shift_left([pf_local[:q]], group)  # the next rank's head
        pf_ext = torch.cat([pf_local, halo])  # (L + q, p)
        for sef in fn.sequence_errors:
            w = sef.window
            fn_w = dataclasses.replace(fn, num_frames=l_frames + w - 1)
            ok = shard.window_valid(w, dev)
            s_rows, s_jw, s_ju = (_masked(t, ok) for t in
                                  window_jacobian(fn_w, sef, pf_ext[:l_frames + w - 1], u))
            for k in range(w):
                jk_t = s_jw[:, :, k, :].transpose(-1, -2)  # (L, p, R)
                diag[k:k + l_frames] += jk_t @ s_jw[:, :, k, :]
                rhs[k:k + l_frames] += (jk_t @ s_rows[..., None])[..., 0]
                uc[k:k + l_frames] += jk_t @ s_ju
                for d in range(1, w - k):
                    offs[d - 1][k:k + l_frames] += jk_t @ s_jw[:, :, k + d, :]
            ublock = ublock + s_ju.flatten(0, 1).T @ s_ju.flatten(0, 1)
            rhs_u = rhs_u + s_ju.flatten(0, 1).T @ s_rows.flatten()

        # ---- ship the tail (contributions to the next rank's frames) ----
        tail = [diag[l_frames:], rhs[l_frames:], uc[l_frames:],
                torch.stack([o[l_frames:] for o in offs])]
        r_diag, r_rhs, r_uc, r_offs = _shift_right(tail, group)
        diag[:q] += r_diag
        rhs[:q] += r_rhs
        uc[:q] += r_uc
        for d, o in enumerate(offs):
            o[:q] += r_offs[d]

    # ---- split the in-rank band from the rank-edge superblock ----
    qp = q * p
    edge = diag.new_zeros((qp, qp))
    for d in range(1, q + 1):
        for i in range(q - d, q):  # frame L - q + i couples into the halo
            f = l_frames - q + i
            j = i + d - q  # the superframe-local index of frame f + d
            if 0 <= j < q and 0 <= f < l_frames:
                edge[i * p:(i + 1) * p, j * p:(j + 1) * p] += offs[d - 1][f]
    return (diag[:l_frames], [offs[d - 1][:l_frames - d] for d in range(1, q + 1)],
            edge, uc[:l_frames], ublock, rhs[:l_frames], rhs_u)


def _sharded_step(shard: _Shard, pf_local: torch.Tensor, u: torch.Tensor,
                  opts: SolverOptions):
    """One GN step: assembly and the superblock SPIKE solve → (d_pf_local, d_u)."""
    q, group = shard.q, shard.group
    l_frames, p = pf_local.shape
    nu = u.shape[-1]
    s_count, s_idx = C.world(group), C.rank(group)
    qp = q * p
    g_blocks = l_frames // q  # superframes per rank
    eye_p = torch.eye(p, dtype=pf_local.dtype, device=pf_local.device)

    diag, offs, b_edge, uc, ublock, rhs, rhs_u = _local_normal_equations(shard, pf_local, u)
    diag = diag + opts.regularization * eye_p

    # the single-device solve's guards at its scale: the global per-DoF
    # Jacobi scale (the max of the ranks' maxima is the single-device max),
    # the roundoff jitter and the per-frame pivot floor; the edge
    # superblock scales locally
    dloc = torch.diagonal(diag, dim1=-2, dim2=-1)  # (L, p)
    s_g = torch.rsqrt(torch.clamp(C.all_reduce_max(dloc.max(dim=0).values, group), min=1e-30))
    diag = diag * s_g[None, :, None] * s_g[None, None, :]
    dsc = torch.diagonal(diag, dim1=-2, dim2=-1)  # ≤ 1
    lift = torch.clamp(_EQUILIBRATED_DIAG_FLOOR - dsc, min=0.0) + _EQUILIBRATED_JITTER
    diag = diag + lift[..., None] * eye_p
    offs = [o * s_g[None, :, None] * s_g[None, None, :] for o in offs]
    s_qp = s_g.repeat(q)
    b_edge = b_edge * s_qp[:, None] * s_qp[None, :]
    eye_u = torch.eye(nu, dtype=pf_local.dtype, device=pf_local.device)
    ublock_sum = C.all_reduce_sum(ublock, group) + opts.regularization * eye_u
    s_u = torch.rsqrt(torch.clamp(torch.diagonal(ublock_sum), min=1e-30))
    ublock_sum = ublock_sum * s_u[:, None] * s_u[None, :] + _EQUILIBRATED_JITTER_U * eye_u
    uc = uc * s_g[None, :, None] * s_u[None, None, :]
    rhs = rhs * s_g[None, :]
    rhs_u = rhs_u * s_u

    # the in-rank band → a block tridiagonal of qp-blocks
    sd, su = (diag, offs[0]) if q == 1 else banded_to_tridiag(diag, offs)
    uc_s = uc.reshape(g_blocks, qp, nu)
    rhs_s = rhs.reshape(g_blocks, qp)

    # the edge coupling from the left neighbour; the wrap-around is zeroed
    b_left, = _shift_right([b_edge], group)
    if s_idx == 0:
        b_left = torch.zeros_like(b_left)
    if s_idx == s_count - 1:
        b_edge = torch.zeros_like(b_edge)

    # local solves: T⁻¹ [rhs | U | e0·B_leftᵀ | e_{G-1}·B_edge]
    big_rhs = rhs_s.new_zeros((g_blocks, qp, 1 + nu + 2 * qp))
    big_rhs[:, :, 0] = rhs_s
    big_rhs[:, :, 1:1 + nu] = uc_s
    big_rhs[0, :, 1 + nu:1 + nu + qp] = b_left.T
    big_rhs[g_blocks - 1, :, 1 + nu + qp:] = b_edge
    sol = block_tridiag_solve(sd, su, big_rhs)
    g = sol[:, :, 0]  # T⁻¹ rhs (G, qp)
    tiu = sol[:, :, 1:1 + nu]  # T⁻¹ U (G, qp, nu)
    v_spike = sol[:, :, 1 + nu:1 + nu + qp]  # T⁻¹ e0 B_leftᵀ
    w_spike = sol[:, :, 1 + nu + qp:]  # T⁻¹ e_{G-1} B_edge

    # the reduced system's rows for x_{s,0} and x_{s,G-1}:
    #   x_{s,0}   + V[0]   x_{s-1,G-1} + W[0]   x_{s+1,0} + TiU[0]   x_u = g[0]
    #   x_{s,G-1} + V[G-1] x_{s-1,G-1} + W[G-1] x_{s+1,0} + TiU[G-1] x_u = g[G-1]
    # and the universal row: Σ_s [Uᵀg − UᵀV x_{s-1,G-1} − UᵀW x_{s+1,0}
    #   − UᵀTiU x_u] + S x_u = b_u
    ut_g = torch.einsum("fpu,fp->u", uc_s, g)
    ut_v = torch.einsum("fpu,fpq->uq", uc_s, v_spike)
    ut_w = torch.einsum("fpu,fpq->uq", uc_s, w_spike)
    ut_tiu = torch.einsum("fpu,fpv->uv", uc_s, tiu)
    (g0_all, gl_all, v0_all, vl_all, w0_all, wl_all, tiu0_all, tiul_all,
     utg_all, utv_all, utw_all, uttiu_all) = C.all_gather(
        [g[0], g[-1], v_spike[0], v_spike[-1], w_spike[0], w_spike[-1], tiu[0], tiu[-1],
         ut_g, ut_v, ut_w, ut_tiu], group)
    rhs_u_sum = C.all_reduce_sum(rhs_u, group)

    # the replicated reduced system in z = [x_{0,0}, x_{0,G-1}, ...,
    # x_{S-1,0}, x_{S-1,G-1}, x_u], the same bytes on every rank
    u_row = 2 * s_count * qp
    a_red = g.new_zeros((u_row + nu, u_row + nu))
    b_red = g.new_zeros((u_row + nu,))
    eye_qp = torch.eye(qp, dtype=g.dtype, device=g.device)
    for s in range(s_count):
        first_r, last_l = 2 * ((s + 1) % s_count) * qp, (2 * ((s - 1) % s_count) + 1) * qp
        for r, v, w, t, gs in ((2 * s * qp, v0_all, w0_all, tiu0_all, g0_all),
                               ((2 * s + 1) * qp, vl_all, wl_all, tiul_all, gl_all)):
            a_red[r:r + qp, r:r + qp] += eye_qp
            a_red[r:r + qp, last_l:last_l + qp] += v[s]
            a_red[r:r + qp, first_r:first_r + qp] += w[s]
            a_red[r:r + qp, u_row:] += t[s]
            b_red[r:r + qp] = gs[s]
        a_red[u_row:, last_l:last_l + qp] -= utv_all[s]
        a_red[u_row:, first_r:first_r + qp] -= utw_all[s]
    a_red[u_row:, u_row:] += ublock_sum - uttiu_all.sum(dim=0)
    b_red[u_row:] = rhs_u_sum - utg_all.sum(dim=0)

    z = _lu_solve(a_red, b_red)
    d_u = z[u_row:]

    # local back-substitution
    x_left = z[(2 * ((s_idx - 1) % s_count) + 1) * qp:][:qp]  # x_{s-1, G-1}
    x_right = z[2 * ((s_idx + 1) % s_count) * qp:][:qp]  # x_{s+1, 0}
    d_pf = g - v_spike @ x_left - w_spike @ x_right - tiu @ d_u
    # undo the equilibration: the solved unknowns are D^-1/2-scaled
    return d_pf.reshape(l_frames, p) * s_g[None, :], d_u * s_u


def _sharded_error(shard: _Shard, pf_local: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The total energy, each window counted by the rank owning its start
    frame; all-reduced, so the same on every rank."""
    fn, q = shard.fn, shard.q
    l_frames = pf_local.shape[0]
    dev = pf_local.device
    per_frame = fn.frame_error(fn.join(pf_local, u), fn.per_frame_errors)
    total = torch.sum(_masked(per_frame, shard.frame_valid(dev)))
    if fn.sequence_errors:
        halo, = _shift_left([pf_local[:q]], shard.group)
        fn_ext = dataclasses.replace(fn, num_frames=l_frames + q)
        ctxs = fn_ext.frame_contexts(fn_ext.join(torch.cat([pf_local, halo]), u))
        for sef in fn.sequence_errors:
            errs = sef.error(fn.character, fn_ext._window_contexts(ctxs, sef.window))
            total = total + torch.sum(_masked(errs[:l_frames],
                                              shard.window_valid(sef.window, dev)))
    return C.all_reduce_sum(total, shard.group)


@spanned("sharded.solve")
def solve_sequence_sharded(fn: SequenceSolverFunction, pf0: torch.Tensor, u0: torch.Tensor,
                           group=None,
                           options: SolverOptions = SolverOptions()) -> SequenceSolveResult:
    """Gauss-Newton over the multi-frame objective with the frames split
    over the ranks of `group` (None: the default group, which must be
    initialized). Every rank passes the whole problem and gets the whole
    result: the per-frame parameters gathered from every rank. The result
    matches solve_sequence's. Any frame count and window: the frames pad
    to a multiple of S·q, windows over 2 aggregate into superframes."""
    C.require_initialized("solve_sequence_sharded")
    opts = options
    f_real = fn.num_frames
    s_count, s_idx = C.world(group), C.rank(group)
    q = _bandwidth(fn)
    chunk = s_count * q
    l_frames = -(-f_real // chunk) * chunk // s_count
    start = s_idx * l_frames
    dev = pf0.device
    # this rank's frames; the padding repeats the last real frame's tables
    # and starts at zero parameters, as JAX's
    index = torch.clamp(torch.arange(start, start + l_frames), max=f_real - 1)
    real = host_sync("sharded.index", (start + torch.arange(l_frames) < f_real).to, dev)
    fn_local = dataclasses.replace(
        fn, per_frame_errors=_take_frames(fn.per_frame_errors, f_real, index),
        num_frames=l_frames)
    shard = _Shard(fn_local, start, f_real, q, group)
    pf = torch.where(real[:, None],
                     pf0.index_select(0, host_sync("sharded.index", index.to, dev)), 0.0)
    u = u0

    last_err = host_sync("sharded.init", torch.tensor, torch.finfo(torch.float32).max,
                         dtype=pf0.dtype, device=dev)
    it, done = 0, False
    while it < opts.max_iterations and not done:
        with profile_scope("sharded.iteration"):
            d_pf, d_u = _sharded_step(shard, pf, u, opts)
            err = _sharded_error(shard, pf, u)
            done = host_sync("sharded", bool, (it + 1 >= opts.min_iterations)
                             & _converged(last_err, err, opts.threshold))
            pf, u, last_err = pf - d_pf, u - d_u, err
            it += 1
    per_frame, = C.all_gather([pf], group)
    return SequenceSolveResult(per_frame.flatten(0, 1)[:f_real], u, last_err, it,
                               host_sync("sharded.result", torch.tensor, done, device=dev))
