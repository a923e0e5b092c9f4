// K2+K3 — damped_chol_solve_kernel (with damped_chol_subst_kernel for k > 1):
// batched damped Cholesky solve for Hopper (sm_90a). Solves (a + diag(damp))
// x = b for B symmetric positive-definite (n, n) systems, 1 ≤ n ≤ 4096, with
// k ≥ 1 right-hand sides each.
//
// One kernel replaces two TPU kernels of momentum_tpu/ops/psd_pallas.py:
//   K2 _panel_kernel (:53, launched by _panel_cholinv_call :104): Cholesky and
//      triangular inverse Linv of each diagonal panel, with L21 = A21·Linvᵀ and
//      the trailing update left to XLA products between panels;
//   K3 _subst_kernel (:120, launched by _subst_call :186): the blocked forward
//      and back substitution, as matrix-vector products with the Linv blocks.
// On the H100 one system fits in one block's shared memory, so the block runs
// K2's panel algorithm and K3's substitutions in one pass, without writing the
// factor to device memory. K5a (ops/chol_pallas.py::_kernel :55) reaches this
// kernel too, through ops/chol.py::chol_solve.
//
// What bounds it on the H100: it reads B·n²·4 bytes (206 MB with damp, b and
// x at B = 2048, n = 157: 61 µs at 3.35 TB/s) and does B·n³/3 flops (2.6
// GFLOP: 39 µs of the card's 67 TFLOP/s f32). Neither is near: a block's
// dependent steps set the time. The first form of this kernel (a right-looking
// rank-1 factor, one thread per row) took 2.48 ms at B = 2048, n = 157 on an
// H100 at 700 W; the second (one block of 256 threads a system, 32-wide
// panels, 104 KB of shared memory, two blocks an SM) 0.45 ms, 45 µs for one
// system alone, of which warp 0's diagonal step, run while the other seven
// warps waited, took about half.
//
// Design: one block of 256 threads per system, 32-wide panels.
//   Layout. Shared memory holds only the lower block triangle of the damped
//   matrix, padded to m = ⌈n/32⌉·32, as P(P+1)/2 packed 32 × 32 blocks (P =
//   m/32) of rows of kLdb = 36 floats: 16-byte rows, and the float4s of 8
//   consecutive rows fall in distinct banks. 69 KB at n = 157, so three
//   systems share an SM (the fused form's register budget, 80 a thread,
//   allows it); up to n = 288 in 227 KB. The padding is identity, with zero
//   damping and a zero right-hand side, so the padded unknowns are 0 and
//   are not written back.
//   Load. Each row's lower block triangle by cp.async, 4 bytes a lane (the
//   rows of n = 157 floats are not 16-byte aligned), a warp a row: all warps
//   bring in block (0, 0)'s rows, then warps 0 and 1 factor it, (a) below,
//   while warps 2–7 bring in the rest. The thread that copies a diagonal
//   entry adds its damping once the copy is in.
//   Per 32-wide panel, K2's algorithm with lookahead: at panel r0,
//   (b) L21 = A21·Linvᵀ, a warp 16 whole rows, each lane a 4 × 4 register
//       tile of them (rows 4 apart, columns 8 apart, so every 16-byte load
//       of a k-quad is conflict-free), in place after a warp barrier;
//   (c) the trailing update L22 −= L21·L21ᵀ in units of 32 rows × 16 columns
//       of a block, 4 × 4 register tiles a lane fed by 16-byte loads;
//   (a) of the next panel: its diagonal block's factor and inverse Linv.
//   Warps 0 and 1 take the chain: the L21 rows of the next diagonal block (16
//   each), that block's update (a half each), then its (a); warps 2–7 take
//   the L21 rows below and, once all of L21 is in (named barrier 3), the
//   other units of (c) in a fixed round-robin order, so that (c) runs under
//   the next panel's (a). Named barriers 1 and 2 pair warps 0 and 1; one
//   block barrier closes the panel, against three before.
//   (a) by two warps: warp 0 factors the block in registers, lane l holding
//       row l; the pivot reaches the lanes by a shuffle, column kk of L goes
//       to row kk of the block (Lᵀ), whence the rank-1 update reads it by
//       16-byte broadcasts. Warp 1 forms Linv, one column a lane, right-
//       looking from Lᵀ four columns behind (named barriers 4–11 hand them
//       on): li[k] = s[k]·dinv[k], then s[r] −= L[r][k]·li[k] for r > k. Its
//       chain is 32 multiply-adds long, where the column-by-column
//       substitution it replaces was 496 and ran after the factor on warp 0.
//   Every entry still takes panel 0's update, then panel 1's, each the same
//   32-term sum in the same order, and Linv's entries the same terms as the
//   column-by-column substitution: the factor and x are bit-identical to the
//   second form's.
//   Substitutions, K3's algorithm: y_k = Linv_k·(b_k − Σ_{j<k} L_kj y_j) and
//   x_k = Linv_kᵀ·(y_k − Σ_{j>k} L_jkᵀ x_j), each a 32-wide matrix-vector
//   product by warp 0 and a block-wide update of the remaining right-hand
//   side: no 32-step dependent chain.
// Plain FP32 FMA throughout: the systems reach κ ≈ 1e7–1e8 (ROADMAP F5), and
// the time is latency, not flops. Measured on an H100 (700 W;
// tools/kernel_ab.py, 26e885b's form in turns, x bit-identical): 0.2791 ms
// at B = 2048, n = 157 (22% of the bound; 0.4438 before, library 2.1924),
// 0.0313 at B = 128 (0.0458), the factor-only form 0.0259 at (32, 156)
// (0.0464, library cholesky_ex 0.1384) and 0.0341 at (10, 169) (0.0608). One
// system alone (tools/psd_clocks.py) spends ~7.5k cycles of ~53k loading
// (block (0, 0) in by ~3.3k), then ~8k a panel: 16 rows of L21 and half a
// diagonal block on each of warps 0 and 1 (~2.5k each), the factor (~3.5k,
// up to 5k beside the trailing units), the inverse's last 4 columns (~0.2k).
//
// Larger systems (ROADMAP F7). JAX's TPU kernel takes every n ≥ 64
// (psd_pallas.py:41), so this kernel takes them as well. Past n = 288 the
// packed triangle does not fit in 227 KB of shared memory: the same code then
// keeps the matrix in a device workspace of dense rows of m + 4 floats a
// system, which the launch takes from a stream-ordered pool and gives back
// after the kernel; shared memory holds the right-hand side. The block's own
// global loads and stores of its system stay in order across the same
// barriers.
//
// More right-hand sides (k > 1). JAX factors a matrix right-hand side's
// system with K2 too (psd_pallas.py:301-311) and substitutes it by blocked
// products (_solve_panels :262-282), so the launch runs two kernels in stream
// order:
//   damped_chol_solve_kernel<·, kFactorOnly = true>, the factor above, one
//     block a system, which leaves the factor and its F1 flag in a workspace
//     of B·m·(m + 4) floats and B ints (3.3 MB at B = 32, n = 156: it stays in
//     the 50 MB L2). The factor is stored symmetric: below and on the diagonal
//     blocks as factored (Linv on the diagonal blocks, zeros above their
//     diagonal, L21 below), above them its transpose, so both substitutions
//     read a panel's 32 rows of it, contiguous and 16-byte aligned (rows of m
//     floats out of shared memory, m + 4 in the workspace form);
//   damped_chol_subst_kernel<KC>, one block for KC = 32 columns of one
//     system's right-hand side: 480 blocks at (32, 156, 470), against 32
//     blocks of one system each in the form this replaced. The block loads its
//     m × KC tile of b into shared memory, a warp a row, and walks the panels
//     as JAX's _solve_panels does, right-looking: forward, Y = Linv·B_j, then
//     B[t0:] −= L21·Y; back, X = Linvᵀ·B_j, then B[:r0] −= L21ᵀ·X. The updates
//     are FP32 register-tile products (4 × 4 a lane) fed by 16-byte loads of
//     the factor's rows through the read-only cache and 16-byte broadcasts of
//     Y, so each factor entry read serves four columns and each Y entry four
//     rows. Two block barriers a panel, against ~22 a column before. x is
//     stored by rows, a warp a row.
// What bounds it: B·(n³/3 + 2n²k) flops at 67 TFLOP/s, 0.0115 ms at (32, 156,
// 470). On an H100 (700 W; tools/kernel_ab.py) the substitution takes 0.060
// ms there: 2 blocks an SM (no spills at 128 registers), so 480 blocks run in
// two rounds of one block's latency, ten panel steps each, ~0.011 ms of it
// loading b and storing x. KC = 32 against 64, and 2 blocks an SM against 4,
// are the sweep of tools/kernel_ab.py (PSD_PROBES): 64 is 7–8% faster at k =
// 470 and 782 and 8% slower at (10, 169, 508), 4 blocks 3–7% faster at n =
// 156 and 6% slower there; the paths' launches weigh the three alike. The
// workspaces come from a pool of the library's own (workspace_pool below).
// Past m = 1536 the tile takes KC = 8 to fit. With k = 1 the fused kernel
// above runs: a vector right-hand side is substituted in the factor's block.
//
// Failure (ROADMAP F1): a pivot that is not > 0 (negative, zero or NaN) stops
// the factorization and the system's x is all NaN — the behaviour of the JAX
// CPU path (lax.linalg.cholesky) and of torch.linalg.cholesky_ex's `info`, not
// the TPU kernels' pivot clamp. Warp 0 decides, under step (c) of the panel
// before; the block reads the flag after the block barrier that closes the
// panel, which every thread reaches, so the decision is uniform and no named
// barrier is left waiting.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kPanel = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdb = kPanel + 4;       // floats a row of a packed 32 × 32 block
constexpr int kBlock = kPanel * kLdb;  // floats a packed block
constexpr int kMaxSharedN = 288;  // P(P + 1)/2 packed blocks + m floats fit in 227 KB
// register budgets of the factor's two forms (tools/kernel_ab.py): the fused
// form's batches fill the card, three blocks an SM (n ≤ 160: 69 KB a block)
// run them in fewer rounds; the factor-only form's SPIKE steps hold ≤ 32
// systems, one round, whose latency is shorter with 128 registers a thread
constexpr int kFusedBlocksPerSm = 3;
constexpr int kFactorOnlyBlocksPerSm = 2;
constexpr int kMaxN = 4096;       // one block a system: the time grows as n³
constexpr int kLoadUnroll = 8;  // loads a thread keeps in flight
constexpr int kCols = 32;        // KC: right-hand-side columns a substitution block owns
constexpr int kColsNarrow = 8;   // KC where kCols' tile does not fit (m > 1536)
constexpr int kSubstBlocksPerSm = 2;  // register budget: 128 a thread, no spills
constexpr int kMaxDevices = 64;
// bytes the workspace pool keeps mapped across synchronizations
constexpr uint64_t kPoolKeepBytes = 256ull << 20;
constexpr int kMaxSmem = 232448; // bytes of shared memory a block can have
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int padded(int n) { return (n + kPanel - 1) / kPanel * kPanel; }

// The matrix a factor block works on: in shared memory the lower block
// triangle, packed (kPacked: block (I, J), I ≥ J, at I(I+1)/2 + J, rows of
// kLdb floats); in the device workspace dense rows of ld floats. Inside one
// 32 × 32 block, rows are rs() floats apart and 16-byte aligned.
template <bool kPacked>
struct Mat {
  float* base;
  int ld;
  __device__ __forceinline__ float* at(int i, int j) const {
    if constexpr (kPacked) {
      const int bi = i >> 5;
      return base + ((bi * (bi + 1) >> 1) + (j >> 5)) * kBlock + (i & 31) * kLdb + (j & 31);
    } else {
      return base + i * ld + j;
    }
  }
  __device__ __forceinline__ int rs() const { return kPacked ? kLdb : ld; }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barrier `id` (0 is __syncthreads') of `count` threads: bar_sync
// waits until they have all arrived or waited, bar_arrive does not wait.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// acc[p][q] += x[p]·y[q] over the four k of a quad, in k order.
__device__ __forceinline__ void quad_fma(float (&acc)[4][4], const float4 (&x)[4],
                                        const float4 (&y)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] += x[p].x * y[q].x;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] += x[p].y * y[q].y;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] += x[p].z * y[q].z;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] += x[p].w * y[q].w;
}

// (a) The diagonal block at D (rows rs floats apart) replaced by the inverse
// of its Cholesky factor, zeros above the diagonal, by two warps:
//   diag_factor, warp 0: the factor, column by column, lane l holding row l.
//     The pivot reaches the lanes by a shuffle; column kk of L goes to row
//     kk of the block (Lᵀ, with dinv[kk] = 1/L[kk][kk] on the diagonal),
//     whence the rank-1 update of the rows below reads it by 16-byte
//     broadcasts. Every 4 columns warp 0 arrives at named barrier 4, 5, …,
//     11. *ok is cleared on a pivot that is not > 0.
//   diag_inverse, warp 1: Linv's column `lane`, right-looking, 4 columns of
//     L behind: s[k] is final once the columns < k have given their terms,
//     li[k] = s[k]·dinv[k]; then s[r] −= L[r][k]·li[k] for r > k, row k of Lᵀ
//     read by 16-byte broadcasts. s[r] so takes the terms k = 0, 1, … of the
//     forward substitution li[r] = (δ(r, lane) − Σ_{k<r} L[r][k]·li[k])·
//     dinv[r] in that order; li[r] is exactly 0 for r < lane. Linv then
//     overwrites the block.
constexpr int kInverseLag = 4;  // columns of L a named barrier hands on
constexpr int kLagBarrier = 4;  // the first of their named barriers

__device__ __forceinline__ void diag_factor(float* D, int rs, int lane, int* ok) {
  float rv[kPanel];  // row `lane` of the block; L's row where t <= lane
#pragma unroll
  for (int t = 0; t < kPanel; t += 4) {
    const float4 v = ld4(D + lane * rs + t);
    rv[t] = v.x, rv[t + 1] = v.y, rv[t + 2] = v.z, rv[t + 3] = v.w;
  }
  __syncwarp();  // the rows are read before Lᵀ overwrites them
  bool good = true;
  // lane kk + 1's next pivot, formed in-lane before the row update: the
  // same FMA as that update's, off the shuffle that feeds the other rows
  float dn = rv[0];
#pragma unroll
  for (int kk = 0; kk < kPanel; ++kk) {
    const float d = __shfl_sync(kAll, dn, kk);  // the same pivot in every lane
    good = good && d > 0.f;
    const float inv = rsqrtf(d);
    rv[kk] *= inv;  // lanes > kk: L[lane][kk]
    const float lik = rv[kk];
    D[kk * rs + lane] = lane == kk ? inv : lik;
    if (kk + 1 < kPanel) dn = rv[kk + 1] - lik * lik;
    __syncwarp();  // column kk of L in row kk
#pragma unroll
    for (int g = (kk + 1) / 4 * 4; g < kPanel; g += 4) {
      const float4 l = ld4(D + kk * rs + g);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e > kk && lane >= g + e) rv[g + e] -= lik * lv[e];
    }
    if (kk % kInverseLag == kInverseLag - 1) bar_arrive(kLagBarrier + kk / kInverseLag, 64);
  }
  if (!good && lane == 0) *ok = 0;
}

__device__ __forceinline__ void diag_inverse(float* D, int rs, int lane) {
  float s[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r) s[r] = lane == r ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    if (k % kInverseLag == 0) bar_sync(kLagBarrier + k / kInverseLag, 64);
    s[k] *= D[k * rs + k];
#pragma unroll
    for (int g = (k + 1) / 4 * 4; g < kPanel; g += 4) {
      const float4 l = ld4(D + k * rs + g);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e > k) s[g + e] -= lv[e] * s[k];
    }
  }
  __syncwarp();  // every lane has read Lᵀ
#pragma unroll
  for (int r = 0; r < kPanel; ++r) D[r * rs + lane] = s[r];
}

// (b) L21 = A21·Linvᵀ on the 16 rows i0… of panel r0's column strip, in
// place: lane (rt, ct) keeps rows i0 + rt + 4q and columns r0 + ct + 8q.
template <bool kPacked>
__device__ __forceinline__ void l21_rows(const Mat<kPacked>& A, int r0, int i0, int lane) {
  const int rt = lane >> 3;
  const int ct = lane & 7;
  const int rs = A.rs();
  float* u = A.at(i0 + rt, r0);            // rows of A21, 4·rs apart
  const float* v = A.at(r0 + ct, r0);      // rows of Linv, 8·rs apart
  float acc[4][4] = {};
#pragma unroll 2
  for (int k = 0; k < kPanel; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = ld4(u + 4 * q * rs + k);
      y[q] = ld4(v + 8 * q * rs + k);
    }
    quad_fma(acc, x, y);
  }
  __syncwarp();  // the warp's rows are read before any lane overwrites them
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) u[4 * p * rs + ct + 8 * q] = acc[p][q];
}

// (c) One unit of the trailing update at panel r0: columns jc…jc + 15 of the
// block row i0…i0 + 31 −= (L21 rows i0…)·(L21 rows jc…)ᵀ, lane (rg, cg)
// keeping rows i0 + rg + 8q and columns jc + cg + 4q; on a diagonal block
// only the entries on and below the diagonal are stored.
template <bool kPacked>
__device__ __forceinline__ void trailing_unit(const Mat<kPacked>& A, int r0, int i0, int jc,
                                              int lane) {
  const int rg = lane >> 2;
  const int cg = lane & 3;
  const int rs = A.rs();
  const float* u = A.at(i0 + rg, r0);  // 8·rs apart
  const float* v = A.at(jc + cg, r0);  // 4·rs apart
  float acc[4][4] = {};
#pragma unroll 2
  for (int k = 0; k < kPanel; k += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = ld4(u + 8 * q * rs + k);
      y[q] = ld4(v + 4 * q * rs + k);
    }
    quad_fma(acc, x, y);
  }
  float* t = A.at(i0 + rg, jc + cg);  // the unit lies in one block
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (jc + cg + 4 * q <= i0 + rg + 8 * p) t[8 * p * rs + 4 * q] -= acc[p][q];
}

// kInWorkspace: the matrix lives in `work` (n > kMaxSharedN), else in shared
// memory. kFactorOnly: the block factors and leaves the factor in `work`,
// stored symmetric, and its F1 flag in `ok_out`, for damped_chol_subst_kernel
// (b and x unused); else it substitutes b (batch, n) into x (batch, n), and,
// in shared memory with `work` given (damped_chol_factor_launch), hands its
// factor on as the factor-only form does.
template <bool kInWorkspace, bool kFactorOnly>
__global__ void __launch_bounds__(kThreads,
                                  kFactorOnly ? kFactorOnlyBlocksPerSm : kFusedBlocksPerSm)
damped_chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ damp,
                         const float* __restrict__ b, float* __restrict__ x, int n,
                         float* __restrict__ work, int* __restrict__ ok_out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int ok;  // cleared by warp 0 when a pivot is not > 0
  const int m = padded(n);
  const int nb = m / kPanel;  // P
  const int ld = m + 4;       // the workspace form's rows
  const long long sys = blockIdx.x;
  const Mat<!kInWorkspace> A{kInWorkspace ? work + sys * m * ld : sm, ld};
  // a right-hand side, then y, then x
  float* y = kInWorkspace ? sm : sm + (nb * (nb + 1) / 2) * kBlock;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* as = a + sys * n * n;
  const float* ds = damp + sys * n;

  // The load, a warp a row: row i < n's lower block triangle, columns
  // [0, w(i) = min(n, 32·⌊i/32⌋ + 32)), by cp.async of 4 bytes a lane (the
  // rows of n = 157 floats are not 16-byte aligned). All warps copy block
  // (0, 0)'s rows and the padding; then warps 0 and 1 factor the block while
  // warps 2–7 copy the rest and the right-hand side. The thread that copies a
  // diagonal entry adds its damping once its copy is in (row i goes to warp
  // i mod 8 or, past row 31, to warp 2 + (i − 32) mod 6, lane i mod 32). The
  // workspace form copies by plain loads and stores, the damping added.
  auto copy_rows = [&](int i_begin, int i_end, int first, int stride) {
    for (int i = i_begin + first; i < i_end; i += stride) {
      const int w = min(n, (i / kPanel + 1) * kPanel);
      const float* src = as + (long long)i * n;
#pragma unroll 4
      for (int j = lane; j < w; j += 32) {
        if constexpr (kInWorkspace) *A.at(i, j) = j == i ? src[j] + ds[i] : src[j];
        else cp_async4(A.at(i, j), src + j);
      }
    }
  };
  const int n0 = min(n, kPanel);
  const float d0 = !kInWorkspace && (lane & 7) == warp && lane < n0 ? ds[lane] : 0.f;
  copy_rows(0, n0, warp, kWarps);
  // padding, in the last block row alone: identity rows and columns; with
  // n ≤ 32 it lies in block (0, 0), so all warps set it before (a)
  for (int i = m - kPanel + warp; i < m; i += kWarps)
    for (int j = lane; j < m; j += 32)
      if (i >= n || j >= n) *A.at(i, j) = i == j ? 1.f : 0.f;
  if (tid == 0) ok = 1;
  if constexpr (!kInWorkspace) {
    cp_async_wait_all();
    if ((lane & 7) == warp && lane < n0) *A.at(lane, lane) += d0;
  }
  __syncthreads();
  if (warp == 0) diag_factor(A.at(0, 0), A.rs(), lane, &ok);  // (a) of panel 0
  else if (warp == 1) diag_inverse(A.at(0, 0), A.rs(), lane);
  else {
    // this thread's diagonal entries past row 31: i = lane + 32c
    float dsv[kMaxSharedN / kPanel];
#pragma unroll
    for (int c = 1; c < kMaxSharedN / kPanel; ++c) {
      const int i = lane + kPanel * c;
      dsv[c] = !kInWorkspace && i < n && (i - kPanel) % (kWarps - 2) == warp - 2 ? ds[i] : 0.f;
    }
    copy_rows(kPanel, n, warp - 2, kWarps - 2);
    if (!kFactorOnly)
      for (int i = tid - 64; i < m; i += kThreads - 64) {
        if (i < n) cp_async4(y + i, b + sys * n + i);
        else y[i] = 0.f;
      }
    cp_async_wait_all();
    if constexpr (!kInWorkspace) {
#pragma unroll
      for (int c = 1; c < kMaxSharedN / kPanel; ++c) {
        const int i = lane + kPanel * c;
        if (i < n && (i - kPanel) % (kWarps - 2) == warp - 2) *A.at(i, i) += dsv[c];
      }
    }
  }
  __syncthreads();

  // The panels. Panel r0's (b) and (c) and the next panel's (a), between
  // block barriers, with named barriers inside:
  //   warps 0 and 1: L21 of the next diagonal block's rows, 16 each, then
  //     arrive at 3; both wait at 1; the block's update, the left half by
  //     warp 0, the right by warp 1, which arrives at 2, where warp 0 waits;
  //     then (a) of the next panel, warp 0 the factor, warp 1 the inverse;
  //   warps 2–7: L21 of the rows below, 16 a warp in turn; after 3 (all of
  //     L21 in) the other units of (c), in a fixed round-robin order.
  for (int r0 = 0; ok && r0 + kPanel < m; r0 += kPanel) {  // ok: read after a barrier
    const int t0 = r0 + kPanel;
    if (warp < 2) {
      l21_rows(A, r0, t0 + 16 * warp, lane);
      bar_arrive(3, kThreads);
      bar_sync(1, 64);
      trailing_unit(A, r0, t0, t0 + 16 * warp, lane);
      if (warp == 0) {
        bar_sync(2, 64);
        diag_factor(A.at(t0, t0), A.rs(), lane, &ok);  // (a) of the next panel, under (c)
      } else {
        bar_arrive(2, 64);
        diag_inverse(A.at(t0, t0), A.rs(), lane);
      }
    } else {
      for (int s = warp - 2; s < (m - t0) / 16 - 2; s += kWarps - 2)
        l21_rows(A, r0, t0 + kPanel + 16 * s, lane);
      bar_sync(3, kThreads);
      // the trailing block triangle of R block rows, row by row, two units a
      // block, but the first block's; unit u to warp 2 + u mod 6
      const int R = nb - 1 - r0 / kPanel;
      const int units = R * (R + 1) - 2;
      for (int u = warp - 2; u < units; u += kWarps - 2) {
        const int q = 1 + (u >> 1);  // block (t0/32 + r, t0/32 + c) of the triangle
        const int r = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
        const int c = q - (r * (r + 1) >> 1);
        trailing_unit(A, r0, t0 + kPanel * r, t0 + kPanel * c + 16 * (u & 1), lane);
      }
    }
    __syncthreads();  // (c) done
  }

  if (kFactorOnly || (!kInWorkspace && work != nullptr)) {
    // Hand the factor on, stored symmetric: below and on the diagonal blocks
    // as factored, above them its transpose. From shared memory it goes out
    // in rows of m floats (128-byte aligned, m ≡ 0 mod 32); in the workspace
    // form the upper part is written in place (it reads only the lower one)
    // and the rows keep their m + 4.
    if (ok) {  // uniform: read after the last barrier
      const int ldo = kInWorkspace ? ld : m;
      const int rs = A.rs();
      float* out = work + sys * m * ldo;
      // a warp a block (I, J), I ≥ J, a lane a column
      for (int q = warp; q < nb * (nb + 1) / 2; q += kWarps) {
        const int bi = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
        const int bj = q - (bi * (bi + 1) >> 1);
        const float* blk = A.at(kPanel * bi, kPanel * bj);
        for (int r = 0; r < kPanel; ++r) {
          if (!kInWorkspace) out[(kPanel * bi + r) * ldo + kPanel * bj + lane] = blk[r * rs + lane];
          if (bi > bj) out[(kPanel * bj + r) * ldo + kPanel * bi + lane] = blk[lane * rs + r];
        }
      }
    }
    if (tid == 0) ok_out[sys] = ok;
  }
  if constexpr (!kFactorOnly) {
    // The substitutions, a panel at a time: warp 0 multiplies by the panel's
    // Linv (forward) or Linvᵀ (back), then the block updates the rest.
    const int rs = A.rs();
    if (ok) {  // uniform: read after a barrier
      for (int r0 = 0; r0 < m; r0 += kPanel) {  // L y = b
        if (warp == 0) {
          const float* lrow = A.at(r0 + lane, r0);  // Linv row `lane`
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 4) {
            const float4 l = ld4(lrow + t);
            s0 += l.x * y[r0 + t];
            s1 += l.y * y[r0 + t + 1];
            s0 += l.z * y[r0 + t + 2];
            s1 += l.w * y[r0 + t + 3];
          }
          __syncwarp();
          y[r0 + lane] = s0 + s1;
        }
        __syncthreads();
        for (int i = r0 + kPanel + tid; i < m; i += kThreads) {
          const float* row = A.at(i, r0);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 4) {
            const float4 l = ld4(row + t);
            s0 += l.x * y[r0 + t];
            s1 += l.y * y[r0 + t + 1];
            s0 += l.z * y[r0 + t + 2];
            s1 += l.w * y[r0 + t + 3];
          }
          y[i] -= s0 + s1;
        }
        __syncthreads();
      }
      for (int r0 = m - kPanel; r0 >= 0; r0 -= kPanel) {  // Lᵀ x = y
        if (warp == 0) {
          const float* lcol = A.at(r0, r0 + lane);  // Linv column `lane`
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += lcol[t * rs] * y[r0 + t];
            s1 += lcol[(t + 1) * rs] * y[r0 + t + 1];
          }
          __syncwarp();
          y[r0 + lane] = s0 + s1;
        }
        __syncthreads();
        for (int i = tid; i < r0; i += kThreads) {
          const float* col = A.at(r0, i);  // column i of the panel's rows
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += col[t * rs] * y[r0 + t];
            s1 += col[(t + 1) * rs] * y[r0 + t + 1];
          }
          y[i] -= s0 + s1;
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) x[sys * n + i] = ok ? y[i] : nanf("");
  }
}

// The update of a substitution block's tile T (rows of kCg·4 + 4 floats) at
// panel r0: T[i] −= Σ_t F[r0 + t][i]·Y[t], Y = T's rows r0..r0 + 31, for the
// rows [lo, hi). The rows go out in chunks of 4·kRg to the warps in turn;
// lane (rg, cg) keeps a 4 × 4 register tile at rows 4·rg, columns 4·cg of
// its chunk, fed per t by one 16-byte load of F (four consecutive rows; four
// scalar loads when F's rows are not 16-byte aligned, kAligned false) and
// one 16-byte broadcast of Y.
template <bool kAligned, int kRg, int kCg>
__device__ __forceinline__ void subst_update(const float* __restrict__ F, int ldf, float* T,
                                             int r0, int lo, int hi, int warp, int lane) {
  constexpr int ldt = 4 * kCg + 4;
  constexpr int kChunk = 4 * kRg;
  const int rg = lane / kCg;
  const int cg = lane - rg * kCg;
  const float* fp = F + r0 * ldf;
  const float* yp = T + r0 * ldt + 4 * cg;
  for (int i0 = lo + warp * kChunk + 4 * rg; i0 < hi; i0 += kWarps * kChunk) {
    float acc[4][4] = {};
#pragma unroll 8
    for (int t = 0; t < kPanel; ++t) {
      float u[4];
      if (kAligned) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(fp + t * ldf + i0));
        u[0] = f.x, u[1] = f.y, u[2] = f.z, u[3] = f.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = __ldg(fp + t * ldf + i0 + q);
      }
      const float4 y = *reinterpret_cast<const float4*>(yp + t * ldt);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][0] += u[q] * y.x;
        acc[q][1] += u[q] * y.y;
        acc[q][2] += u[q] * y.z;
        acc[q][3] += u[q] * y.w;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4* ti = reinterpret_cast<float4*>(T + (i0 + q) * ldt + 4 * cg);
      float4 v = *ti;
      v.x -= acc[q][0], v.y -= acc[q][1], v.z -= acc[q][2], v.w -= acc[q][3];
      *ti = v;
    }
  }
}

// The substitution of KC right-hand-side columns of one system through the
// factor damped_chol_solve_kernel<·, true> left in `fac` (m rows of ldf
// floats a system, stored symmetric) with its flag in `ok_in`. Block
// (sys, tile) of a 1-D grid of batch·⌈k / KC⌉ owns columns tile·KC … of system
// sys. Shared memory: the tile T by rows of KC + 4 floats, then two buffers
// of a panel's Linv (32 rows of 33 floats). A panel's step, between two
// barriers:
//   Y = Linv·T[r0:r0 + 32] (Linvᵀ· in the back pass), in place: warp w owns
//     columns w·KC/8 …, lane a row r0 + a of them;
//   subst_update of the rows below the panel (forward) or above it (back);
//   meanwhile the next panel's Linv comes into registers, stored in the other
//     buffer after the update.
template <int KC>
__global__ void __launch_bounds__(kThreads, kSubstBlocksPerSm)
damped_chol_subst_kernel(const float* __restrict__ fac, int ldf, const int* __restrict__ ok_in,
                         const float* __restrict__ b, float* __restrict__ x, int n, int k) {
  constexpr int kCw = KC / kWarps;     // panel-product columns a warp owns
  constexpr int kCg = KC / 4;          // update column groups of 4
  constexpr int kRg = 32 / kCg;        // update row groups of 4 in a warp
  constexpr int ldt = KC + 4;          // 16-byte rows; 8 lanes' rows in distinct banks
  constexpr int kLinvPerThread = kPanel * kPanel / kThreads;
  constexpr int kLs = kPanel * (kPanel + 1);
  static_assert(KC % 32 == 0 || KC == 8, "KC: 8 or a multiple of 32");
  extern __shared__ __align__(16) float subst_sm[];
  const int m = padded(n);
  const int tiles = (k + KC - 1) / KC;
  const long long sys = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - (int)sys * tiles) * KC;
  const int kc = min(KC, k - c0);  // the last tile may be ragged
  const float* F = fac + sys * m * ldf;
  float* T = subst_sm;
  float* Ls = subst_sm + m * ldt;  // buffers 0 and 1, kLs floats each
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cw = warp * kCw;
  const bool f4 = (ldf & 3) == 0;  // F's rows 16-byte aligned (rows of m or m + 4: always)
  const float* bs = b + sys * n * k + c0;  // row i, column c at bs[i·k + c]
  float* xs = x + sys * n * k + c0;

  if (!ok_in[sys]) {  // ROADMAP F1: every column of a failed system is NaN
    for (int idx = tid; idx < n * KC; idx += kThreads) {
      const int i = idx / KC;
      const int c = idx - i * KC;
      if (c < kc) xs[(long long)i * k + c] = nanf("");
    }
    return;
  }
  // Linv_j[r][c] for the entries idx = tid + u·kThreads: load, then store
  float lv[kLinvPerThread];
  auto load_linv = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kLinvPerThread; ++u) {
      const int idx = tid + u * kThreads;
      lv[u] = __ldg(F + (r0 + (idx >> 5)) * ldf + r0 + (idx & 31));
    }
  };
  auto store_linv = [&](float* buf) {
#pragma unroll
    for (int u = 0; u < kLinvPerThread; ++u) {
      const int idx = tid + u * kThreads;
      buf[(idx >> 5) * (kPanel + 1) + (idx & 31)] = lv[u];
    }
  };
  load_linv(0);
  // The tile, a warp a row of KC consecutive floats, kLoadUnroll loads in
  // flight a thread; zeros past n and kc.
  for (int base = tid; base < m * KC; base += kThreads * kLoadUnroll) {
    float v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads;
      const int i = idx / KC;
      const int c = idx - i * KC;
      v[u] = i < n && c < kc ? __ldg(bs + (long long)i * k + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads;
      const int i = idx / KC;
      if (i < m) T[i * ldt + idx - i * KC] = v[u];
    }
  }
  store_linv(Ls);

  int cur = 0;
  // One panel's step, while panel `next` (< 0: none) gets its Linv.
  auto step = [&](int r0, bool back, int lo, int hi, int next) {
    __syncthreads();  // T's rows updated, this panel's Linv stored
    if (next >= 0) load_linv(next);
    // Linv[lane][t], or Linvᵀ[lane][t] = Linv[t][lane] in the back pass
    const float* L = Ls + cur * kLs + (back ? lane : lane * (kPanel + 1));
    const int lstep = back ? kPanel + 1 : 1;
    float out[kCw] = {};
#pragma unroll 8
    for (int t = 0; t < kPanel; ++t) {
      const float l = L[t * lstep];
      const float* y = T + (r0 + t) * ldt + cw;
#pragma unroll
      for (int p = 0; p < kCw; ++p) out[p] += l * y[p];
    }
    __syncwarp();  // the warp's reads of its columns' panel rows are done
#pragma unroll
    for (int p = 0; p < kCw; ++p) T[(r0 + lane) * ldt + cw + p] = out[p];
    __syncthreads();  // Y whole
    if (f4) subst_update<true, kRg, kCg>(F, ldf, T, r0, lo, hi, warp, lane);
    else subst_update<false, kRg, kCg>(F, ldf, T, r0, lo, hi, warp, lane);
    if (next >= 0) store_linv(Ls + (cur ^ 1) * kLs);  // read first after the next barrier
    cur ^= 1;
  };
  for (int r0 = 0; r0 < m; r0 += kPanel) {  // L y = b; the back pass starts on the last panel
    step(r0, false, r0 + kPanel, m, r0 + kPanel < m ? r0 + kPanel : r0);
  }
  for (int r0 = m - kPanel; r0 >= 0; r0 -= kPanel)  // Lᵀ x = y
    step(r0, true, 0, r0, r0 - kPanel);
  __syncthreads();
  for (int idx = tid; idx < n * KC; idx += kThreads) {  // x by rows, a warp a row
    const int i = idx / KC;
    const int c = idx - i * KC;
    if (c < kc) xs[(long long)i * k + c] = T[i * ldt + c];
  }
}

// Bytes of dynamic shared memory of a substitution block with KC columns.
int subst_smem_bytes(int n, int kc) {
  const int m = padded(n);
  return (m * (kc + 4) + 2 * kPanel * (kPanel + 1)) * (int)sizeof(float);
}

template <int KC>
cudaError_t launch_subst(const float* fac, int ldf, const int* ok, const float* b, float* x,
                         int batch, int n, int k, cudaStream_t s) {
  const int smem = subst_smem_bytes(n, KC);
  cudaError_t err = cudaFuncSetAttribute(damped_chol_subst_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch * ((k + KC - 1) / KC);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  damped_chol_subst_kernel<KC><<<(unsigned)blocks, kThreads, smem, s>>>(fac, ldf, ok, b, x, n,
                                                                         k);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory one fused block needs for an (n, n) system:
// the packed lower block triangle and a right-hand side up to n = 288, the
// right-hand side alone past it. A factor-only block needs no right-hand side.
int smem_bytes(int n, bool factor_only) {
  const int nb = padded(n) / kPanel;
  const int rhs = factor_only ? 0 : nb * kPanel;
  return (n <= kMaxSharedN ? nb * (nb + 1) / 2 * kBlock + rhs : rhs) * (int)sizeof(float);
}

template <bool kInWorkspace, bool kFactorOnly>
cudaError_t launch_factor(const float* a, const float* damp, const float* b, float* x,
                          int batch, int n, float* work, int* ok, cudaStream_t s) {
  const int smem = smem_bytes(n, kFactorOnly);
  if (!kInWorkspace) {
    cudaError_t err =
        cudaFuncSetAttribute(damped_chol_solve_kernel<kInWorkspace, kFactorOnly>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)  // three 69 KB blocks an SM need its whole carveout
      err = cudaFuncSetAttribute(damped_chol_solve_kernel<kInWorkspace, kFactorOnly>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  damped_chol_solve_kernel<kInWorkspace, kFactorOnly><<<batch, kThreads, smem, s>>>(
      a, damp, b, x, n, work, ok);
  return cudaGetLastError();
}

// The current device's workspace pool, made at its first use: a
// stream-ordered pool like the device's default one, but keeping up to
// kPoolKeepBytes mapped when the host synchronizes. The default pool gives
// all its memory back at every synchronization, and mapping it again on the
// next launch took more than the k > 1 kernels themselves on an H100 (0.15–
// 0.49 ms against 0.12 at (32, 156, 470)).
cudaError_t workspace_pool(cudaMemPool_t* pool) {
  static std::mutex mu;
  static cudaMemPool_t pools[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t made;
    err = cudaMemPoolCreate(&made, &props);
    if (err != cudaSuccess) return err;
    uint64_t keep = kPoolKeepBytes;
    err = cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) {
      cudaMemPoolDestroy(made);
      return err;
    }
    pools[dev] = made;
  }
  *pool = pools[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// a: (batch, n, n), damp: (batch, n), b and x: (batch, n, k); float32,
// contiguous, on the device; 1 ≤ n ≤ 4096, k ≥ 1. k = 1 runs the fused
// kernel; past n = 288 it takes a workspace of batch·m·(m + 4) floats from
// workspace_pool. k > 1 runs the factor and then the substitution kernel,
// through a workspace of batch·m·(m + 4) floats and batch ints from the same
// pool. Each workspace is freed after its kernels, in stream order. Launches
// on `stream`; returns the first CUDA error.
int damped_chol_solve_launch(const void* a, const void* damp, const void* b, void* x,
                             int batch, int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* af = (const float*)a;
  const float* df = (const float*)damp;
  const float* bf = (const float*)b;
  float* xf = (float*)x;
  const int m = padded(n);
  if (k == 1 && n <= kMaxSharedN)
    return (int)launch_factor<false, false>(af, df, bf, xf, batch, n, nullptr, nullptr, s);
  const size_t floats = (size_t)batch * m * (m + 4);
  cudaMemPool_t pool;
  cudaError_t err = workspace_pool(&pool);
  if (err != cudaSuccess) return (int)err;
  float* work = nullptr;
  err = cudaMallocFromPoolAsync(
      (void**)&work, floats * sizeof(float) + (k > 1 ? batch * sizeof(int) : 0), pool, s);
  if (err != cudaSuccess) return (int)err;
  int* ok = reinterpret_cast<int*>(work + floats);
  if (k == 1) {
    err = launch_factor<true, false>(af, df, bf, xf, batch, n, work, nullptr, s);
  } else {
    err = n <= kMaxSharedN
              ? launch_factor<false, true>(af, df, nullptr, nullptr, batch, n, work, ok, s)
              : launch_factor<true, true>(af, df, nullptr, nullptr, batch, n, work, ok, s);
    const int ldf = n <= kMaxSharedN ? m : m + 4;  // as the factor kernel leaves it
    if (err == cudaSuccess)
      err = subst_smem_bytes(n, kCols) <= kMaxSmem
                ? launch_subst<kCols>(work, ldf, ok, bf, xf, batch, n, k, s)
                : launch_subst<kColsNarrow>(work, ldf, ok, bf, xf, batch, n, k, s);
  }
  const cudaError_t freed = cudaFreeAsync(work, s);
  return (int)(err != cudaSuccess ? err : freed);
}

// The factor alone, as damped_chol_subst_kernel reads it, for n ≤ 288: the
// factor-only kernel (fused = 0) or the fused one with its factor handed on
// beside x (fused = 1, b and x (batch, n)). fac: batch·m·m floats, rows of m =
// ⌈n/32⌉·32; ok: batch ints, the F1 flags. For tests and measurements: the
// solve launches the kernels through damped_chol_solve_launch.
int damped_chol_factor_launch(const void* a, const void* damp, const void* b, void* x,
                              void* fac, void* ok, int batch, int n, int fused,
                              void* stream) {
  if (n < 1 || n > kMaxSharedN || batch < 1) return (int)cudaErrorInvalidValue;
  const float* af = (const float*)a;
  const float* df = (const float*)damp;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(fused ? launch_factor<false, false>(af, df, (const float*)b, (float*)x, batch, n,
                                                  (float*)fac, (int*)ok, s)
                     : launch_factor<false, true>(af, df, nullptr, nullptr, batch, n,
                                                 (float*)fac, (int*)ok, s));
}

}  // extern "C"
