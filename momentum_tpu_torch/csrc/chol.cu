// K5b — chol_blocked_solve_kernel: batched damped Cholesky solve in 32-wide
// panels for Hopper (sm_90a). Solves (a + diag(damp)) x = b for B symmetric
// positive-definite (n, n) systems, n a multiple of 32, one right-hand side
// each.
//
// Replaces momentum_tpu/ops/chol_pallas.py::_kernel_blocked (:93, launched by
// chol_solve_pallas_blocked :174): a batch tile of 16 systems resident in
// VMEM, each 32-wide panel factored column by column over all its rows, then
// the trailing update T −= L21·L21ᵀ as one MXU product per panel, then the
// substitutions. K5a (chol_pallas.py::_kernel :55, the rank-1 form) is
// csrc/psd.cu's damped_chol_solve_kernel, reached through ops/chol.py.
//
// What bounds it on the H100: it reads B·n²·4 bytes (210 MB at B = 2048,
// n = 160; ~63 µs at 3.35 TB/s) and does B·n³/6 FMAs (1.4 GFMA; ~42 µs of the
// card's 67 TFLOP/s f32). Neither is near: with one system per block and two
// blocks per SM, the time goes to the dependent steps of each block. The
// unblocked form (psd.cu) takes n pivot steps of three block barriers each,
// with the trailing update of step k serialised along each row. Here the
// dependent steps shrink to 32 per panel inside one warp, and everything
// else is parallel over the block.
//
// Design: one block of 256 threads per system, the damped matrix in dynamic
// shared memory (n·ld + 2n floats, ld = n + 1 so that rows step across banks;
// 104 KB at n = 160: two blocks share an SM). The matrix comes in as float4
// loads, eight in flight per thread: with one 4-byte load in flight per
// thread, 16 warps per SM keep too few bytes on the way (~0.27 TB/s).
// For each panel of 32 columns:
//   1a. warp 0 factors the 32 × 32 diagonal block: lane l holds row r0 + l in
//       registers and column k of L reaches the other lanes by shuffles, so
//       the 32 dependent steps need no barrier at all;
//   1b. the panel's rows below it, one per thread: L21 = A21·L11⁻ᵀ by a
//       triangular solve in registers, reading L11 as broadcasts. This is the
//       panel factor K5b runs column by column over all m rows, in
//       left-looking order, so that the rows proceed in parallel instead of
//       one warp walking them all;
//   2.  the whole block applies L22 −= L21·L21ᵀ to the lower triangle of the
//       trailing matrix: a warp takes a 32 × 16 strip, each lane a 4 × 4
//       register tile of it, with 32-long dot products read from L21 in shared
//       memory. Within a warp the 8 row tiles and 4 column tiles read 8 and 4
//       distinct rows at one column: with ld ≡ 1 (mod 32) those fall in
//       distinct banks, and lanes on the same row read one word (broadcast).
// The substitutions go a panel at a time the same way: warp 0 solves the
// block's 32 unknowns with shuffles, then the block updates the remaining
// right-hand side, instead of 2n dependent warp steps with shared-memory
// round trips. Measured on an H100 (700 W) at B = 2048, n = 160: 0.57 ms,
// where the one-warp, scalar-load form of the same algorithm took 2.31 ms.
// Plain FMA tiles: wgmma, TMA and double buffering are later work.
//
// Failure (ROADMAP F1): a pivot that is not > 0 (negative, zero or NaN) stops
// the factorization and the system's x is all NaN, as in K2+K3 and
// torch.linalg.cholesky_ex's `info`; the TPU kernel clamps the pivot to 1e-30
// instead (chol_pallas.py:116).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPanel = 32;
constexpr int kThreads = 256;
constexpr int kLoadUnroll = 8;  // float4 loads a thread keeps in flight
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 2)
chol_blocked_solve_kernel(const float* __restrict__ a, const float* __restrict__ damp,
                          const float* __restrict__ b, float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  __shared__ int ok;  // cleared by warp 0 when a pivot is not > 0
  const int ld = n + 1;
  float* A = sm;           // n rows of ld floats; L overwrites the lower triangle
  float* y = sm + n * ld;  // rhs, then y, then x
  float* dinv = y + n;     // 1 / L[k][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long sys = blockIdx.x;
  const float* ds = damp + sys * n;

  // The load: kLoadUnroll float4 loads in flight per thread before their
  // stores, so that 16 warps per SM keep enough bytes on the way.
  const float4* a4 = reinterpret_cast<const float4*>(a + sys * n * n);
  const int n4 = n / 4;
  const int total = n * n4;
  for (int base = tid; base < total; base += kThreads * kLoadUnroll) {
    float4 v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u)
      if (base + u * kThreads < total) v[u] = __ldg(a4 + base + u * kThreads);
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads;
      if (idx < total) {
        const int i = idx / n4;
        const int j = (idx - i * n4) * 4;
        float* dst = A + i * ld + j;
        dst[0] = v[u].x;
        dst[1] = v[u].y;
        dst[2] = v[u].z;
        dst[3] = v[u].w;
        if (i >= j && i < j + 4) dst[i - j] += ds[i];  // the damping, on the diagonal
      }
    }
  }
  for (int i = tid; i < n; i += kThreads) y[i] = b[sys * n + i];
  if (tid == 0) ok = 1;
  __syncthreads();

  for (int r0 = 0; r0 < n; r0 += kPanel) {
    const int t0 = r0 + kPanel;
    // 1a. the panel's diagonal block, by warp 0: lane l holds row r0 + l in
    //     registers, column k of L reaches the other lanes by shuffles
    if (warp == 0) {
      float rv[kPanel];
      float* row = A + (r0 + lane) * ld + r0;
#pragma unroll
      for (int t = 0; t < kPanel; ++t) rv[t] = row[t];  // t > lane: never used
      bool good = true;
#pragma unroll
      for (int kk = 0; kk < kPanel; ++kk) {
        const float d = __shfl_sync(kAll, rv[kk], kk);  // the same pivot in every lane
        good = good && d > 0.f;
        const float lkk = sqrtf(d);
        const float inv = 1.f / lkk;
        if (lane == kk) {
          rv[kk] = lkk;
          dinv[r0 + kk] = inv;
        } else if (lane > kk) {
          rv[kk] *= inv;
        }
        const float lik = rv[kk];
#pragma unroll
        for (int jj = kk + 1; jj < kPanel; ++jj) {
          const float ljk = __shfl_sync(kAll, rv[kk], jj);
          if (lane >= jj) rv[jj] -= lik * ljk;
        }
      }
#pragma unroll
      for (int t = 0; t < kPanel; ++t)
        if (t <= lane) row[t] = rv[t];
      if (!good && lane == 0) ok = 0;
    }
    __syncthreads();
    if (!ok) break;  // uniform: read after the barrier

    // 1b. the panel's rows below the block, one row per thread:
    //     L21 = A21 · L11⁻ᵀ, row by row in registers; L11 is read as broadcasts
    for (int i = t0 + tid; i < n; i += kThreads) {
      float xr[kPanel];
      float* row = A + i * ld + r0;
#pragma unroll
      for (int t = 0; t < kPanel; ++t) xr[t] = row[t];
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj) {
        const float* l11 = A + (r0 + jj) * ld + r0;
        float s = xr[jj];
#pragma unroll
        for (int t = 0; t < jj; ++t) s -= xr[t] * l11[t];
        xr[jj] = s * dinv[r0 + jj];
      }
#pragma unroll
      for (int t = 0; t < kPanel; ++t) row[t] = xr[t];
    }
    __syncthreads();

    // 2. the trailing update L22 −= L21·L21ᵀ, lower triangle, by the block
    const int strips_down = (n - t0) / 32;  // row strips of 32; strip R has 2R + 2
    const int strips = strips_down * (strips_down + 1);  // column strips of 16
    for (int s = warp; s < strips; s += kThreads / 32) {
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

  // 3. the substitutions, a panel at a time: warp 0 solves the 32 unknowns
  //    of the diagonal block (shuffles), then the block updates the rest
  if (ok) {  // uniform: read after the barrier
    for (int r0 = 0; r0 < n; r0 += kPanel) {  // L y = b
      if (warp == 0) {
        float yl = y[r0 + lane];
        const float* row = A + (r0 + lane) * ld + r0;
#pragma unroll
        for (int kk = 0; kk < kPanel; ++kk) {
          if (lane == kk) yl *= dinv[r0 + kk];
          const float yk = __shfl_sync(kAll, yl, kk);
          if (lane > kk) yl -= row[kk] * yk;
        }
        y[r0 + lane] = yl;
      }
      __syncthreads();
      for (int i = r0 + kPanel + tid; i < n; i += kThreads) {
        const float* row = A + i * ld + r0;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) s += row[t] * y[r0 + t];
        y[i] -= s;
      }
      __syncthreads();
    }
    for (int r0 = n - kPanel; r0 >= 0; r0 -= kPanel) {  // Lᵀ x = y
      if (warp == 0) {
        float yl = y[r0 + lane];
#pragma unroll
        for (int kk = kPanel - 1; kk >= 0; --kk) {
          if (lane == kk) yl *= dinv[r0 + kk];
          const float xk = __shfl_sync(kAll, yl, kk);
          if (lane < kk) yl -= A[(r0 + kk) * ld + r0 + lane] * xk;
        }
        y[r0 + lane] = yl;
      }
      __syncthreads();
      for (int i = tid; i < r0; i += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kPanel; ++t) s += A[(r0 + t) * ld + i] * y[r0 + t];
        y[i] -= s;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) x[sys * n + i] = ok ? y[i] : nanf("");
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for an (n, n) system.
int chol_blocked_solve_smem_bytes(int n) { return (n * (n + 1) + 2 * n) * (int)sizeof(float); }

// a: (batch, n, n), damp: (batch, n), b: (batch, n), x: (batch, n); float32,
// contiguous, a 16-byte aligned, on the device; n a multiple of 32. Launches on `stream`;
// returns cudaGetLastError().
int chol_blocked_solve_launch(const void* a, const void* damp, const void* b, void* x,
                              int batch, int n, void* stream) {
  if (n % kPanel != 0) return (int)cudaErrorInvalidValue;
  const int smem = chol_blocked_solve_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      chol_blocked_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_blocked_solve_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)damp, (const float*)b, (float*)x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
