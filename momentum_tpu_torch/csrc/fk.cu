// K1 — fk_global_kernel: batched global forward kinematics for Hopper (sm_90a).
//
// Replaces the TPU kernel momentum_tpu/ops/fk_pallas.py::_fk_kernel (:62,
// launched by _fk_pallas_impl :88), which runs the binary-lifting ladder on
// component-major (8, nJ+1, 128) VMEM tiles and selects parents with a
// one-hot permutation matmul per level.
//
// What bounds it on the H100: per call it moves 2·B·nJ·32 bytes (6.7 MB at
// B = 2048, nJ = 51; about 2 µs at 3.35 TB/s) and does ~60 flops per joint,
// so neither bandwidth nor FLOPs bound it. Latency does: each batch element
// is a chain of nJ dependent composes, and B = 2048 elements fill only 64
// warps on 132 SMs.
//
// Design: one thread per batch element walks the joints in topological order
// and composes parent_global ∘ local, as pymomentum's GPU backend does
// (backend/triton_fk.py:182-207). A block of 32 threads stages its 32
// elements' (nJ, 8) states in shared memory with coalesced loads, composes in
// place, and writes back with coalesced stores. Each element's row is padded
// to an odd stride (nJ·8 + 1 floats), so the 32 threads of the warp, which
// touch the same joint of 32 rows at once, hit 32 different banks. Parent
// indices come from a small int32 table (−1 = root, whose global state is its
// local state). Binary lifting across threads would shorten the chain from nJ
// to log2(depth) composes; that is later work.
//
// Layout at the interface: local and out are (B, nJ, 8) row-major float32
// states (tx, ty, tz, qx, qy, qz, qw, s), the JAX package's layout.

#include <cuda_runtime.h>

namespace {

constexpr int kElemsPerBlock = 32;

// b <- a ∘ b: t = ta + Ra·(sa·tb), q = qa ∘ qb, s = sa·sb (math/skel_state.py
// multiply; the rotation is v + qw·t + qv × t with t = 2·qv × v).
__device__ __forceinline__ void compose(const float* a, float* b) {
  const float qx = a[3], qy = a[4], qz = a[5], qw = a[6], sa = a[7];
  const float vx = sa * b[0], vy = sa * b[1], vz = sa * b[2];
  const float tx = 2.f * (qy * vz - qz * vy);
  const float ty = 2.f * (qz * vx - qx * vz);
  const float tz = 2.f * (qx * vy - qy * vx);
  b[0] = a[0] + (vx + qw * tx + (qy * tz - qz * ty));
  b[1] = a[1] + (vy + qw * ty + (qz * tx - qx * tz));
  b[2] = a[2] + (vz + qw * tz + (qx * ty - qy * tx));
  const float bx = b[3], by = b[4], bz = b[5], bw = b[6];
  b[3] = qw * bx + bw * qx + (qy * bz - qz * by);
  b[4] = qw * by + bw * qy + (qz * bx - qx * bz);
  b[5] = qw * bz + bw * qz + (qx * by - qy * bx);
  b[6] = qw * bw - (qx * bx + qy * by + qz * bz);
  b[7] = sa * b[7];
}

__global__ void fk_global_kernel(const float* __restrict__ local,
                                 const int* __restrict__ parent,
                                 float* __restrict__ out, int batch, int nj) {
  extern __shared__ float sm[];
  const int per = nj * 8;
  const int stride = per + 1;
  const long long b0 = (long long)blockIdx.x * kElemsPerBlock;
  const int nb = min(kElemsPerBlock, (int)(batch - b0));
  const float* src = local + b0 * per;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int e = i / per;
    sm[e * stride + (i - e * per)] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    float* g = sm + threadIdx.x * stride;
    for (int j = 0; j < nj; ++j) {
      const int p = parent[j];
      if (p >= 0) compose(g + p * 8, g + j * 8);
    }
  }
  __syncthreads();
  float* dst = out + b0 * per;
  for (int i = threadIdx.x; i < nb * per; i += blockDim.x) {
    const int e = i / per;
    dst[i] = sm[e * stride + (i - e * per)];
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for nj joints.
int fk_global_smem_bytes(int nj) {
  return kElemsPerBlock * (nj * 8 + 1) * (int)sizeof(float);
}

// local, out: (batch, nj, 8) float32 on the device; parent: (nj,) int32 with
// parent[j] < j. Launches on `stream`; returns cudaGetLastError().
int fk_global_launch(const void* local, const void* parent, void* out,
                     int batch, int nj, void* stream) {
  const int smem = fk_global_smem_bytes(nj);
  cudaError_t err = cudaFuncSetAttribute(
      fk_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + kElemsPerBlock - 1) / kElemsPerBlock;
  fk_global_kernel<<<grid, kElemsPerBlock, smem, (cudaStream_t)stream>>>(
      (const float*)local, (const int*)parent, (float*)out, batch, nj);
  return (int)cudaGetLastError();
}

}  // extern "C"
