// K2+K3 — damped_chol_solve_kernel: batched damped Cholesky solve for Hopper
// (sm_90a). Solves (a + diag(damp)) x = b for B symmetric positive-definite
// (n, n) systems, one right-hand side each.
//
// One kernel replaces two TPU kernels of momentum_tpu/ops/psd_pallas.py:
//   K2 _panel_kernel (:53, launched by _panel_cholinv_call :104): Cholesky and
//      triangular inverse of each 64/32-wide diagonal panel, batch in lanes,
//      with the l21 / trailing-update products left to XLA between panels;
//   K3 _subst_kernel (:120, launched by _subst_call :186): the blocked forward
//      and back substitution from those panel factors.
// The TPU split the work because its vector unit wanted the batch in lanes and
// the n³ products on the MXU. On the H100 one system fits in one block's
// shared memory, so factor and substitution run in one pass without writing
// the factor to device memory (the fused design of ops/chol_pallas.py, K5).
//
// What bounds it on the H100: it reads B·n²·4 bytes (202 MB at B = 2048,
// n = 157; ~60 µs at 3.35 TB/s) and does B·n³/6 FMAs (1.3 GFMA; ~40 µs of the
// card's 67 TFLOP/s f32). In this simple form neither bound is near; latency
// is: each block walks n dependent pivot steps of three block barriers each,
// and in step k the thread of row i makes i − k updates of its row, so the
// last rows set the pace, then 2n dependent substitution steps. Two blocks
// (~100 KB of shared memory each) share an SM, ten warps in all, too few to
// hide a shared-memory round trip per dependent update.
//
// Design: the whole damped matrix sits in dynamic shared memory (n·ld + 2n
// floats, ld = n rounded up to odd so a column walk by 32 consecutive rows hits
// 32 banks; 100 KB at n = 157, under the 227 KB a block may use). The block
// runs a right-looking Cholesky with one thread per row: each pivot step
// scales column k, copies it to a contiguous vector, and updates the trailing
// rows four entries at a time with the loads issued before the stores, so the
// updates of a row overlap instead of waiting on each other. The first warp
// then runs the forward and back substitution alone, with warp barriers, and
// the block writes x. Panels, register tiling and wgmma are later work.
//
// Failure (ROADMAP F1): a pivot that is not > 0 (negative, zero or NaN) stops
// the factorization and the system's x is all NaN — the behaviour of the JAX
// CPU path (lax.linalg.cholesky) and of torch.linalg.cholesky_ex's `info`, not
// the TPU kernels' pivot clamp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void damped_chol_solve_kernel(const float* __restrict__ a,
                                         const float* __restrict__ damp,
                                         const float* __restrict__ b,
                                         float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  const int ld = n | 1;
  float* A = sm;            // n rows of ld floats; L overwrites the lower triangle
  float* y = sm + n * ld;   // rhs, then y, then x
  float* lc = y + n;        // column k of L during pivot step k
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long sys = blockIdx.x;
  const float* as = a + sys * n * n;
  const float* ds = damp + sys * n;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n;
    const int j = idx - i * n;
    float v = as[idx];
    if (i == j) v += ds[i];
    A[i * ld + j] = v;
  }
  for (int i = tid; i < n; i += nt) y[i] = b[sys * n + i];
  __syncthreads();

  bool ok = true;  // uniform: every thread reads the same pivot
  for (int k = 0; k < n; ++k) {
    const float d = A[k * ld + k];
    if (!(d > 0.f)) {
      ok = false;
      break;
    }
    const float lkk = sqrtf(d);
    const float inv = 1.f / lkk;
    __syncthreads();  // every thread has read the pivot before it is replaced
    if (tid == 0) A[k * ld + k] = lkk;
    for (int i = k + 1 + tid; i < n; i += nt) {
      const float v = A[i * ld + k] * inv;
      A[i * ld + k] = v;
      lc[i] = v;
    }
    __syncthreads();
    // A[i][j] -= L[i][k]·L[j][k] for k < j <= i, one row per thread. Four
    // entries at a time, loads before stores: the row and the column copy
    // share one array, so the compiler would not reorder them itself and
    // each update would wait out a shared-memory round trip.
    for (int i = k + 1 + tid; i < n; i += nt) {
      const float lik = lc[i];
      float* row = A + i * ld;
      int j = k + 1;
      for (; j + 3 <= i; j += 4) {
        const float l0 = lc[j], l1 = lc[j + 1], l2 = lc[j + 2], l3 = lc[j + 3];
        const float r0 = row[j], r1 = row[j + 1], r2 = row[j + 2], r3 = row[j + 3];
        row[j] = r0 - lik * l0;
        row[j + 1] = r1 - lik * l1;
        row[j + 2] = r2 - lik * l2;
        row[j + 3] = r3 - lik * l3;
      }
      for (; j <= i; ++j) row[j] -= lik * lc[j];
    }
    __syncthreads();
  }

  // Substitutions by the first warp alone: warp barriers, not block ones.
  if (ok && tid < 32) {
    for (int k = 0; k < n; ++k) {  // L y = b
      const float yk = y[k] / A[k * ld + k];
      __syncwarp();
      if (tid == 0) y[k] = yk;
      for (int i = k + 1 + tid; i < n; i += 32) y[i] -= A[i * ld + k] * yk;
      __syncwarp();
    }
    for (int k = n - 1; k >= 0; --k) {  // Lᵀ x = y
      const float xk = y[k] / A[k * ld + k];
      __syncwarp();
      if (tid == 0) y[k] = xk;
      for (int i = tid; i < k; i += 32) y[i] -= A[k * ld + i] * xk;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) x[sys * n + i] = ok ? y[i] : nanf("");
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for an (n, n) system.
int damped_chol_solve_smem_bytes(int n) {
  return (n * (n | 1) + 2 * n) * (int)sizeof(float);
}

// Threads per block: one per row, rounded up to a warp, at most 1024.
int damped_chol_solve_threads(int n) {
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// a: (batch, n, n), damp: (batch, n), b: (batch, n), x: (batch, n); float32,
// contiguous, on the device. Launches on `stream`; returns cudaGetLastError().
int damped_chol_solve_launch(const void* a, const void* damp, const void* b,
                             void* x, int batch, int n, void* stream) {
  const int smem = damped_chol_solve_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      damped_chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  damped_chol_solve_kernel<<<batch, damped_chol_solve_threads(n), smem,
                             (cudaStream_t)stream>>>(
      (const float*)a, (const float*)damp, (const float*)b, (float*)x, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
