// K2+K3 — damped_chol_solve_kernel: batched damped Cholesky solve for Hopper
// (sm_90a). Solves (a + diag(damp)) x = b for B symmetric positive-definite
// (n, n) systems, 1 ≤ n ≤ 4096, with k ≥ 1 right-hand sides each.
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
// Larger systems and more right-hand sides (ROADMAP F7). JAX's TPU kernel
// takes every n ≥ 64 (psd_pallas.py:41) and factors a matrix right-hand
// side's system with K2 too (:301-311), so this kernel takes them as well.
// Past n = 224 the padded system does not fit in 227 KB of shared memory:
// the same code then keeps the matrix in a device workspace of m·(m + 1)
// floats a system, which the launch takes from the stream's memory pool and
// gives back after the kernel; shared memory holds the right-hand side. The
// block's own global loads and stores of its system stay in order across the
// same barriers; at n = 300, B = 64 it takes 0.49 ms on an H100 (700 W),
// cholesky_ex + cholesky_solve 0.94. With k right-hand sides the factor is
// formed once and each column substituted in turn through the same buffer.
//
// Failure (ROADMAP F1): a pivot that is not > 0 (negative, zero or NaN) stops
// the factorization and the system's x is all NaN — the behaviour of the JAX
// CPU path (lax.linalg.cholesky) and of torch.linalg.cholesky_ex's `info`, not
// the TPU kernels' pivot clamp. Warp 0 decides; the block reads the flag after
// a barrier, so the decision is uniform.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedN = 224;  // m·(m + 1) + m floats must fit in 227 KB
constexpr int kMaxN = 4096;       // one block a system: the time grows as n³
constexpr int kLoadUnroll = 8;  // float4 loads a thread keeps in flight
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ inline int padded(int n) { return (n + kPanel - 1) / kPanel * kPanel; }

// b and x are (batch, n, k); kInWorkspace: the matrix lives in `work`
// (n > kMaxSharedN), else in shared memory.
template <bool kInWorkspace>
__global__ void __launch_bounds__(kThreads, 2)
damped_chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ damp,
                         const float* __restrict__ b, float* __restrict__ x, int n, int k,
                         float* __restrict__ work) {
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
  // the first right-hand side; the others load after the factorization
  for (int i = tid; i < m; i += kThreads) y[i] = i < n ? b[(sys * n + i) * k] : 0.f;
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

  // The substitutions, a panel at a time: warp 0 multiplies by the panel's
  // Linv (forward) or Linvᵀ (back), then the block updates the rest; one
  // right-hand side after another. A thread loads and stores the same
  // entries of y, so a column's load needs no barrier before it.
  for (int c = 0; c < k; ++c) {
    if (c > 0) {
      for (int i = tid; i < m; i += kThreads) y[i] = i < n ? b[(sys * n + i) * k + c] : 0.f;
      __syncthreads();
    }
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
    for (int i = tid; i < n; i += kThreads) x[(sys * n + i) * k + c] = ok ? y[i] : nanf("");
  }
}

// Bytes of dynamic shared memory one block needs for an (n, n) system: the
// padded system and a right-hand side up to n = 224, the right-hand side alone
// past it.
int smem_bytes(int n) {
  const int m = padded(n);
  return (n <= kMaxSharedN ? m * (m + 1) + m : m) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// a: (batch, n, n), damp: (batch, n), b and x: (batch, n, k); float32,
// contiguous, on the device; 1 ≤ n ≤ 4096, k ≥ 1. Past n = 224 the launch
// takes a workspace of batch·m·(m + 1) floats from the stream's memory pool
// and frees it after the kernel, in stream order. Launches on `stream`;
// returns the first CUDA error.
int damped_chol_solve_launch(const void* a, const void* damp, const void* b, void* x,
                             int batch, int n, int k, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = smem_bytes(n);
  if (n <= kMaxSharedN) {
    cudaError_t err = cudaFuncSetAttribute(
        damped_chol_solve_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    damped_chol_solve_kernel<false><<<batch, kThreads, smem, s>>>(
        (const float*)a, (const float*)damp, (const float*)b, (float*)x, n, k, nullptr);
    return (int)cudaGetLastError();
  }
  const int m = padded(n);
  float* work = nullptr;
  cudaError_t err = cudaMallocAsync(
      (void**)&work, (size_t)batch * m * (m + 1) * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  damped_chol_solve_kernel<true><<<batch, kThreads, smem, s>>>(
      (const float*)a, (const float*)damp, (const float*)b, (float*)x, n, k, work);
  err = cudaGetLastError();
  const cudaError_t freed = cudaFreeAsync(work, s);
  return (int)(err != cudaSuccess ? err : freed);
}

}  // extern "C"
