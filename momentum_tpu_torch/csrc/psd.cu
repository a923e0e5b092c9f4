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
// GFLOP: 39 µs of the card's 67 TFLOP/s f32). Neither is near: with one
// system per block and two blocks per SM, a block's dependent steps set the
// time. The first form of this kernel (a right-looking rank-1 factor, one
// thread per row, 2.48 ms at B = 2048, n = 157 on an H100 at 700 W) spent it
// on one 4-byte load in flight per thread, n pivot steps of three block
// barriers each, a trailing update paced by its longest row (~n²/2 dependent
// shared-memory updates), and 2n dependent substitution steps in one warp.
//
// Design: one block of 256 threads per system. The damped matrix sits in
// dynamic shared memory padded to m = ⌈n/32⌉·32 rows of ld = m + 1 floats
// (ld ≡ 1 mod 32: a walk down a column hits 32 banks), 104 KB at n = 157, so
// two blocks share an SM. The padding exists only there: its rows and columns
// are identity, with zero damping and a zero right-hand side, so the padded
// unknowns are 0 and are not written back.
//   Load. The system's n² floats are one flat span whose start is 16-byte
//   aligned only for every fourth system at n = 157: a scalar head to the
//   first 16-byte boundary, float4 loads for the body with eight in flight
//   per thread, a scalar tail; each float goes to (i, j) = divmod(flat, n),
//   the damping added on the diagonal.
//   Per 32-wide panel, K2's algorithm:
//   (a) warp 0 factors the 32 × 32 diagonal block in registers (lane l holds
//       row l, column k of L reaches the other lanes by shuffles) and forms
//       its triangular inverse Linv, one column per lane, from the factor in
//       the other lanes' registers: no barrier inside. Linv overwrites the
//       block, zeros above its diagonal; L11 itself is never read again.
//   (b) L21 = A21·Linvᵀ over all warps: a warp owns 16 whole rows of A21, each
//       lane a 4 × 4 register tile of them, so the product needs no block
//       barrier and writes L21 in place. This replaces the per-row triangular
//       solve (one thread per row, a 32-step serial chain) by a product.
//   (c) the whole block applies L22 −= L21·L21ᵀ to the lower triangle in 4 × 4
//       FP32 register tiles; a warp's 8 row tiles and 4 column tiles read 8
//       and 4 distinct rows at one column, which ld ≡ 1 (mod 32) puts in
//       distinct banks.
//   Substitutions, K3's algorithm: y_k = Linv_k·(b_k − Σ_{j<k} L_kj y_j) and
//   x_k = Linv_kᵀ·(y_k − Σ_{j>k} L_jkᵀ x_j), each a 32-wide matrix-vector
//   product by warp 0 and a block-wide update of the remaining right-hand
//   side: no 32-step dependent chain.
// Plain FP32 FMA throughout: the systems reach κ ≈ 1e7–1e8 (ROADMAP F5), and
// the time is latency, not flops. Measured on an H100 (700 W) at B = 2048,
// n = 157: 0.45 ms (14% of the bound), against 2.14 ms for cholesky_ex +
// cholesky_solve and 2.48 ms for the first form; one system alone (B = 128)
// takes 45 µs. Overlapping warp 0's next diagonal block with the trailing
// update, larger register tiles, and wgmma are later work.
//
// Larger systems (ROADMAP F7). JAX's TPU kernel takes every n ≥ 64
// (psd_pallas.py:41), so this kernel takes them as well. Past n = 224 the
// padded system does not fit in 227 KB of shared memory: the same code then
// keeps the matrix in a device workspace of m·(m + 1) floats a system, which
// the launch takes from a stream-ordered pool and gives back after the
// kernel; shared memory holds the right-hand side. The block's own global
// loads and stores of its system stay in order across the same barriers; at
// n = 300, B = 64 it takes 0.49 ms on an H100 (700 W), cholesky_ex +
// cholesky_solve 0.94.
//
// More right-hand sides (k > 1). JAX factors a matrix right-hand side's
// system with K2 too (psd_pallas.py:301-311) and substitutes it by blocked
// products (_solve_panels :262-282), so the launch runs two kernels in stream
// order:
//   damped_chol_solve_kernel<·, kFactorOnly = true>, the factor above, one
//     block a system, which leaves the factor and its F1 flag in a workspace
//     of B·m·(m + 1) floats and B ints (3.3 MB at B = 32, n = 156: it stays in
//     the 50 MB L2). The factor is stored symmetric: below and on the diagonal
//     blocks as factored (Linv on the diagonal blocks, zeros above their
//     diagonal, L21 below), above them its transpose, so both substitutions
//     read a panel's 32 rows of it, contiguous and, out of shared memory (rows
//     of m floats), 16-byte aligned;
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
// 470). On an H100 (700 W; tools/kernel_ab.py) the call takes 0.11 ms there,
// against 1.48 for the form this replaced, which walked the k columns one
// after another, each a chain of 32-wide matrix-vector products by warp 0
// with ~22 barriers a column. Of the 0.11 ms the factor is 0.046, the single-
// system latency of the kernel above at n = 156 (32 blocks on 132 SMs); the
// substitution 0.060: 2 blocks an SM (no spills at 128 registers), so 480
// blocks run in two rounds of one block's latency, ten panel steps each,
// ~0.011 ms of it loading b and storing x. KC = 32 against 64, and 2 blocks an
// SM against 4, are the sweep of tools/kernel_ab.py (PSD_PROBES): 64 is 7–8%
// faster at k = 470 and 782 and 8% slower at (10, 169, 508), 4 blocks 3–7%
// faster at n = 156 and 6% slower there; the paths' launches weigh the three
// alike. The workspaces come from a pool of the library's own
// (workspace_pool below). Past m = 1536 the tile takes KC = 8 to fit. With
// k = 1 the fused kernel above runs unchanged: a vector right-hand side is
// substituted in the factor's block.
//
// Failure (ROADMAP F1): a pivot that is not > 0 (negative, zero or NaN) stops
// the factorization and the system's x is all NaN — the behaviour of the JAX
// CPU path (lax.linalg.cholesky) and of torch.linalg.cholesky_ex's `info`, not
// the TPU kernels' pivot clamp. Warp 0 decides; the block reads the flag after
// a barrier, so the decision is uniform.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kPanel = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedN = 224;  // m·(m + 1) + m floats must fit in 227 KB
constexpr int kMaxN = 4096;       // one block a system: the time grows as n³
constexpr int kLoadUnroll = 8;  // float4 loads a thread keeps in flight
constexpr int kCols = 32;        // KC: right-hand-side columns a substitution block owns
constexpr int kColsNarrow = 8;   // KC where kCols' tile does not fit (m > 1536)
constexpr int kSubstBlocksPerSm = 2;  // register budget: 128 a thread, no spills
constexpr int kMaxDevices = 64;
// bytes the workspace pool keeps mapped across synchronizations
constexpr uint64_t kPoolKeepBytes = 256ull << 20;
constexpr int kMaxSmem = 232448; // bytes of shared memory a block can have
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int padded(int n) { return (n + kPanel - 1) / kPanel * kPanel; }

// kInWorkspace: the matrix lives in `work` (n > kMaxSharedN), else in shared
// memory. kFactorOnly: the block factors and leaves the factor in `work`,
// stored symmetric, and its F1 flag in `ok_out`, for damped_chol_subst_kernel
// (b and x unused); else it substitutes b (batch, n) into x (batch, n).
template <bool kInWorkspace, bool kFactorOnly>
__global__ void __launch_bounds__(kThreads, 2)
damped_chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ damp,
                         const float* __restrict__ b, float* __restrict__ x, int n,
                         float* __restrict__ work, int* __restrict__ ok_out) {
  extern __shared__ float sm[];
  __shared__ int ok;  // cleared by warp 0 when a pivot is not > 0
  const int m = padded(n);
  const int ld = m + 1;
  const long long sys = blockIdx.x;
  // m rows of ld floats; L21 and Linv overwrite the lower triangle
  float* A = kInWorkspace ? work + sys * m * ld : sm;
  float* y = kInWorkspace ? sm : sm + m * ld;  // a right-hand side, then y, then x
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* as = a + sys * n * n;
  const float* ds = damp + sys * n;

  // The load. Element f of the flat span is (i, j) = divmod(f, n); with
  // f < 2^16 and n ≤ 224, (f + 0.5)/n in f32 is within 3e-5 of the exact
  // quotient, whose fraction stays ≥ 0.5/n from an integer. Larger systems
  // divide exactly.
  const float inv_n = 1.f / (float)n;
  auto put = [&](int f, float v) {
    const int i = kInWorkspace ? f / n : __float2int_rz(((float)f + 0.5f) * inv_n);
    const int j = f - i * n;
    A[i * ld + j] = i == j ? v + ds[i] : v;
  };
  const int total = n * n;
  const int head = min(total, (int)((16 - (reinterpret_cast<uintptr_t>(as) & 15)) & 15) / 4);
  const int body = (total - head) / 4;
  const float4* a4 = reinterpret_cast<const float4*>(as + head);
  for (int f = tid; f < head; f += kThreads) put(f, as[f]);
  for (int base = tid; base < body; base += kThreads * kLoadUnroll) {
    float4 v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u)
      if (base + u * kThreads < body) v[u] = __ldg(a4 + base + u * kThreads);
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads;
      if (idx < body) {
        const int f = head + 4 * idx;
        put(f, v[u].x);
        put(f + 1, v[u].y);
        put(f + 2, v[u].z);
        put(f + 3, v[u].w);
      }
    }
  }
  for (int f = head + 4 * body + tid; f < total; f += kThreads) put(f, as[f]);
  for (int idx = tid; idx < (m - n) * m; idx += kThreads) {  // padding: identity rows
    const int i = n + idx / m;
    const int j = idx - (i - n) * m;
    A[i * ld + j] = i == j ? 1.f : 0.f;
  }
  if (!kFactorOnly)  // the right-hand side
    for (int i = tid; i < m; i += kThreads) y[i] = i < n ? b[sys * n + i] : 0.f;
  if (tid == 0) ok = 1;
  __syncthreads();

  for (int r0 = 0; r0 < m; r0 += kPanel) {
    const int t0 = r0 + kPanel;
    // (a) warp 0: the diagonal block's factor, then its inverse
    if (warp == 0) {
      float rv[kPanel];  // row r0 + lane of the block; L's row where t <= lane
      float* row = A + (r0 + lane) * ld + r0;
#pragma unroll
      for (int t = 0; t < kPanel; ++t) rv[t] = row[t];
      bool good = true;
      float dinv = 0.f;  // 1 / L[lane][lane]
      // lane kk + 1's next pivot, formed in-lane before the row update: the
      // same FMA as that update's, off the shuffle that feeds the other rows
      float dn = rv[0];
#pragma unroll
      for (int kk = 0; kk < kPanel; ++kk) {
        const float d = __shfl_sync(kAll, dn, kk);  // the same pivot in every lane
        good = good && d > 0.f;
        const float inv = rsqrtf(d);
        if (lane == kk) dinv = inv;
        rv[kk] *= inv;  // lanes > kk: L[lane][kk]
        const float lik = rv[kk];
        if (kk + 1 < kPanel) dn = rv[kk + 1] - lik * lik;
#pragma unroll
        for (int jj = kk + 1; jj < kPanel; ++jj) {
          const float ljk = __shfl_sync(kAll, lik, jj);
          if (lane >= jj) rv[jj] -= lik * ljk;
        }
      }
      // Linv's column `lane` by forward substitution, L[r][k] from lane r:
      // li[r] = (δ(r, lane) − Σ_{k<r} L[r][k]·li[k]) / L[r][r]; li[r] is
      // exactly 0 for r < lane.
      float li[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) {
        float s = lane == r ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < r; ++k) s -= __shfl_sync(kAll, rv[k], r) * li[k];
        li[r] = s * __shfl_sync(kAll, dinv, r);
      }
#pragma unroll
      for (int r = 0; r < kPanel; ++r) A[(r0 + r) * ld + r0 + lane] = li[r];
      if (!good && lane == 0) ok = 0;
    }
    __syncthreads();
    if (!ok) break;  // uniform: read after the barrier

    // (b) L21 = A21·Linvᵀ: a warp owns 16 whole rows, lane (rt, ct) the
    //     4 × 4 tile at rows 4·rt, columns 4·ct; in place after a warp barrier
    for (int s = warp; s < (m - t0) / 16; s += kWarps) {
      const int i0 = t0 + s * 16 + (lane >> 3) * 4;
      const int c0 = (lane & 7) * 4;
      float* ai = A + i0 * ld + r0;
      const float* lc = A + (r0 + c0) * ld + r0;
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kPanel; ++k) {
        float u[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = ai[q * ld + k];
          v[q] = lc[q * ld + k];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += u[p] * v[q];
      }
      __syncwarp();  // the warp's rows are read before any lane overwrites them
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) ai[p * ld + c0 + q] = acc[p][q];
    }
    __syncthreads();

    // (c) the trailing update L22 −= L21·L21ᵀ, lower triangle, by the block
    const int strips_down = (m - t0) / 32;  // row strips of 32; strip R has 2R + 2
    const int strips = strips_down * (strips_down + 1);  // column strips of 16
    for (int s = warp; s < strips; s += kWarps) {
      int rs = 0;
      while ((rs + 1) * (rs + 2) <= s) ++rs;
      const int cs = s - rs * (rs + 1);
      const int i0 = t0 + rs * 32 + (lane >> 2) * 4;
      const int j0 = t0 + cs * 16 + (lane & 3) * 4;
      if (j0 > i0 + 3) continue;  // the whole 4 × 4 tile lies above the diagonal
      float acc[4][4] = {};
      const float* li = A + i0 * ld + r0;
      const float* lj = A + j0 * ld + r0;
#pragma unroll 8
      for (int t = 0; t < kPanel; ++t) {
        float u[4], v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = li[q * ld + t];
          v[q] = lj[q * ld + t];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += u[p] * v[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q <= i0 + p) A[(i0 + p) * ld + j0 + q] -= acc[p][q];
    }
    __syncthreads();
  }

  if constexpr (kFactorOnly) {
    // Hand the factor on, stored symmetric: below and on the diagonal blocks
    // as factored, above them its transpose. From shared memory it goes out
    // in rows of m floats (128-byte aligned, m ≡ 0 mod 32); in the workspace
    // form the upper part is written in place (it reads only the lower one)
    // and the rows keep their m + 1.
    if (ok) {  // uniform: read after the last barrier
      const int ldo = kInWorkspace ? ld : m;
      float* out = work + sys * m * ldo;
      for (int idx = tid; idx < m * m; idx += kThreads) {
        const int i = idx / m;
        const int j = idx - i * m;
        if (i / kPanel < j / kPanel) out[i * ldo + j] = A[j * ld + i];
        else if (!kInWorkspace) out[i * ldo + j] = A[i * ld + j];
      }
    }
    if (tid == 0) ok_out[sys] = ok;
  } else {
    // The substitutions, a panel at a time: warp 0 multiplies by the panel's
    // Linv (forward) or Linvᵀ (back), then the block updates the rest.
    if (ok) {  // uniform: read after a barrier
      for (int r0 = 0; r0 < m; r0 += kPanel) {  // L y = b
        if (warp == 0) {
          const float* lrow = A + (r0 + lane) * ld + r0;  // Linv row `lane`
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += lrow[t] * y[r0 + t];
            s1 += lrow[t + 1] * y[r0 + t + 1];
          }
          __syncwarp();
          y[r0 + lane] = s0 + s1;
        }
        __syncthreads();
        for (int i = r0 + kPanel + tid; i < m; i += kThreads) {
          const float* row = A + i * ld + r0;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += row[t] * y[r0 + t];
            s1 += row[t + 1] * y[r0 + t + 1];
          }
          y[i] -= s0 + s1;
        }
        __syncthreads();
      }
      for (int r0 = m - kPanel; r0 >= 0; r0 -= kPanel) {  // Lᵀ x = y
        if (warp == 0) {
          const float* lcol = A + r0 * ld + r0 + lane;  // Linv column `lane`
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += lcol[t * ld] * y[r0 + t];
            s1 += lcol[(t + 1) * ld] * y[r0 + t + 1];
          }
          __syncwarp();
          y[r0 + lane] = s0 + s1;
        }
        __syncthreads();
        for (int i = tid; i < r0; i += kThreads) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int t = 0; t < kPanel; t += 2) {
            s0 += A[(r0 + t) * ld + i] * y[r0 + t];
            s1 += A[(r0 + t + 1) * ld + i] * y[r0 + t + 1];
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
  const bool f4 = (ldf & 3) == 0;  // F's rows 16-byte aligned (not in the workspace form)
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
// the padded system and a right-hand side up to n = 224, the right-hand side
// alone past it. A factor-only block needs no right-hand side.
int smem_bytes(int n, bool factor_only) {
  const int m = padded(n);
  const int rhs = factor_only ? 0 : m;
  return (n <= kMaxSharedN ? m * (m + 1) + rhs : rhs) * (int)sizeof(float);
}

template <bool kInWorkspace, bool kFactorOnly>
cudaError_t launch_factor(const float* a, const float* damp, const float* b, float* x,
                          int batch, int n, float* work, int* ok, cudaStream_t s) {
  const int smem = smem_bytes(n, kFactorOnly);
  if (!kInWorkspace) {
    const cudaError_t err =
        cudaFuncSetAttribute(damped_chol_solve_kernel<kInWorkspace, kFactorOnly>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
// kernel; past n = 224 it takes a workspace of batch·m·(m + 1) floats from
// workspace_pool. k > 1 runs the factor and then the substitution kernel,
// through a workspace of batch·m·(m + 1) floats and batch ints from the same
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
  const size_t floats = (size_t)batch * m * (m + 1);
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
    const int ldf = n <= kMaxSharedN ? m : m + 1;  // as the factor kernel leaves it
    if (err == cudaSuccess)
      err = subst_smem_bytes(n, kCols) <= kMaxSmem
                ? launch_subst<kCols>(work, ldf, ok, bf, xf, batch, n, k, s)
                : launch_subst<kColsNarrow>(work, ldf, ok, bf, xf, batch, n, k, s);
  }
  const cudaError_t freed = cudaFreeAsync(work, s);
  return (int)(err != cudaSuccess ? err : freed);
}

}  // extern "C"
