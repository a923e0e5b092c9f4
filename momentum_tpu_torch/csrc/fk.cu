// K1 — fk_global_kernel: batched global forward kinematics for Hopper (sm_90a).
//
// Replaces the TPU kernel momentum_tpu/ops/fk_pallas.py::_fk_kernel (:62,
// launched by _fk_pallas_impl :88), which runs the binary-lifting ladder on
// component-major (8, nJ+1, 128) VMEM tiles and selects parents with a
// one-hot permutation matmul per level. This kernel runs the same algorithm
// with the parent selection as an index into shared memory.
//
// What bounds it on the H100: per call it moves 2·B·nJ·32 bytes (6.7 MB at
// B = 2048, nJ = 51; 2 µs at 3.35 TB/s) and does ~65 flops per joint and
// level, so the bytes bound it. The previous form (one thread per batch
// element walking its 51 joints in order, 32 elements per block) took
// 0.11 ms there: 64 one-warp blocks on 132 SMs, each staging 52 KB through
// 32 threads with scalar loads, then 51 dependent composes per thread.
//
// Design: one thread per (element, joint slot). A block of 256 threads holds
// E elements of S slots, S the power of two ≥ nJ + 1 (E = 256 / S; at
// S > 256 one element per block and S / 256 slots per thread, so nJ ≤ 1023).
// Slot nJ is the virtual identity node; the slots past it stay idle. Each
// thread loads its own 32-byte state with two float4 loads (a block's
// elements are contiguous, so a warp reads 1 KB at once), keeps it in
// registers, and runs the L levels of `levels`, the (L, nJ + 1) table of
// Skeleton.prefix_levels: g[j] ← g[p_k[j]] ∘ g[j], reading the parent's
// state from shared memory, then, after a barrier, publishing its own.
// States sit in shared memory as two float4 planes (tx ty tz qx | qy qz qw s)
// so that a warp's stores are conflict-free. Two float4 stores write the
// result. At B = 2048 and nJ = 51: 512 blocks of 256 threads, 5 composes per
// thread (the fixture rig's 5 levels) instead of 51. On an H100 (700 W) it
// takes 0.0061 ms there (0.1034 before), at 33% of its 0.0020 ms bytes
// bound, and 0.0037 ms at the render clip's B = 32 (0.0986 before): what is
// left is mostly a launch's latency (tools/kernel_ab.py).
//
// Numerics: the compose is math/skel_state.py::multiply with its order of
// operations, every product and sum rounded on its own (__fmul_rn and
// friends keep nvcc from contracting them into FMAs), in the order of
// ops/fk.py::fk_global_plain, so the two agree to the last bits of
// PyTorch's own kernels.
//
// Layout at the interface: local and out are (B, nJ, 8) row-major float32
// states (tx, ty, tz, qx, qy, qz, qw, s), 16-byte aligned, the JAX package's
// layout; levels is int32 (L, nJ + 1) with entries in [0, nJ].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 1024;  // slots per element: nJ + 1 ≤ 1024

struct State {
  float4 a;  // tx, ty, tz, qx
  float4 b;  // qy, qz, qw, s
};

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }

// p ∘ g (apply g, then p): t = tp + rotate(qp, sp·tg), rotate(q, v) =
// (v + qw·t2) + qv × t2 with t2 = 2·(qv × v); q = (wp·vg + wg·vp) + vp × vg,
// w = wp·wg − ((xp·xg + yp·yg) + zp·zg); s = sp·sg.
__device__ __forceinline__ State compose(const State& p, const State& g) {
  const float qx = p.a.w, qy = p.b.x, qz = p.b.y, qw = p.b.z, sp = p.b.w;
  const float vx = mul(sp, g.a.x), vy = mul(sp, g.a.y), vz = mul(sp, g.a.z);
  const float tx = mul(2.f, sub(mul(qy, vz), mul(qz, vy)));
  const float ty = mul(2.f, sub(mul(qz, vx), mul(qx, vz)));
  const float tz = mul(2.f, sub(mul(qx, vy), mul(qy, vx)));
  const float gx = g.a.w, gy = g.b.x, gz = g.b.y, gw = g.b.z;
  State o;
  o.a.x = add(p.a.x, add(add(vx, mul(qw, tx)), sub(mul(qy, tz), mul(qz, ty))));
  o.a.y = add(p.a.y, add(add(vy, mul(qw, ty)), sub(mul(qz, tx), mul(qx, tz))));
  o.a.z = add(p.a.z, add(add(vz, mul(qw, tz)), sub(mul(qx, ty), mul(qy, tx))));
  o.a.w = add(add(mul(qw, gx), mul(gw, qx)), sub(mul(qy, gz), mul(qz, gy)));
  o.b.x = add(add(mul(qw, gy), mul(gw, qy)), sub(mul(qz, gx), mul(qx, gz)));
  o.b.y = add(add(mul(qw, gz), mul(gw, qz)), sub(mul(qx, gy), mul(qy, gx)));
  o.b.z = sub(mul(qw, gw), add(add(mul(qx, gx), mul(qy, gy)), mul(qz, gz)));
  o.b.w = mul(sp, g.b.w);
  return o;
}

// KPT slots per thread; a block covers kThreads·KPT slots = E elements of
// 1 << log2s slots.
template <int KPT>
__global__ void __launch_bounds__(kThreads) fk_global_kernel(
    const float4* __restrict__ local, const int* __restrict__ levels, int n_levels,
    float4* __restrict__ out, int batch, int nj, int log2s) {
  extern __shared__ float4 sm[];
  constexpr int kSlots = kThreads * KPT;
  float4* sa = sm;
  float4* sb = sm + kSlots;
  const long long e0 = (long long)blockIdx.x * (kSlots >> log2s);
  const int mask = (1 << log2s) - 1;

  State g[KPT];
  int j[KPT], base[KPT];
  bool live[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = threadIdx.x + k * kThreads;
    j[k] = s & mask;
    base[k] = s - j[k];  // the element's slot 0 in shared memory
    const long long e = e0 + (s >> log2s);
    live[k] = e < batch && j[k] < nj;
    if (live[k]) {
      const long long at = (e * nj + j[k]) * 2;
      g[k].a = local[at];
      g[k].b = local[at + 1];
    } else {  // the identity node, idle slots and elements past the batch
      g[k].a = make_float4(0.f, 0.f, 0.f, 0.f);
      g[k].b = make_float4(0.f, 0.f, 1.f, 1.f);
    }
    sa[s] = g[k].a;
    sb[s] = g[k].b;
  }
  int p[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) p[k] = (n_levels > 0 && j[k] < nj) ? __ldg(levels + j[k]) : 0;
  __syncthreads();

  for (int lev = 0; lev < n_levels; ++lev) {
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      if (j[k] < nj) {
        const State par = {sa[base[k] + p[k]], sb[base[k] + p[k]]};
        if (lev + 1 < n_levels) p[k] = __ldg(levels + (lev + 1) * (nj + 1) + j[k]);
        g[k] = compose(par, g[k]);
      }
    }
    if (lev + 1 == n_levels) break;
    __syncthreads();  // every parent has been read
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int s = threadIdx.x + k * kThreads;
      sa[s] = g[k].a;
      sb[s] = g[k].b;
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    if (live[k]) {
      const long long e = e0 + ((threadIdx.x + k * kThreads) >> log2s);
      const long long at = (e * nj + j[k]) * 2;
      out[at] = g[k].a;
      out[at + 1] = g[k].b;
    }
  }
}

template <int KPT>
int launch(const void* local, const void* levels, int n_levels, void* out, int batch, int nj,
           int log2s, cudaStream_t stream) {
  const int elems = (kThreads * KPT) >> log2s;
  const int grid = (batch + elems - 1) / elems;
  const int smem = 2 * kThreads * KPT * (int)sizeof(float4);
  fk_global_kernel<KPT><<<grid, kThreads, smem, stream>>>(
      (const float4*)local, (const int*)levels, n_levels, (float4*)out, batch, nj, log2s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most joints the kernel takes.
int fk_global_max_joints() { return kMaxSlots - 1; }

// local, out: (batch, nj, 8) float32 on the device, 16-byte aligned; levels:
// (n_levels, nj + 1) int32, row k the parents p_k over the virtual identity
// node nj. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for nj outside [1, fk_global_max_joints()].
int fk_global_launch(const void* local, const void* levels, int n_levels, void* out,
                     int batch, int nj, void* stream) {
  if (nj < 1 || nj >= kMaxSlots || batch < 1) return (int)cudaErrorInvalidValue;
  int log2s = 0;
  while ((1 << log2s) < nj + 1) ++log2s;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((1 << log2s) <= kThreads ? 1 : (1 << log2s) / kThreads) {
    case 1: return launch<1>(local, levels, n_levels, out, batch, nj, log2s, s);
    case 2: return launch<2>(local, levels, n_levels, out, batch, nj, log2s, s);
    default: return launch<4>(local, levels, n_levels, out, batch, nj, log2s, s);
  }
}

}  // extern "C"
