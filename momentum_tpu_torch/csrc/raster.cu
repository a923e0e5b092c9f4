// K4a raster_planes_kernel and K4b raster_planes_binned_kernel: the plane
// z-buffer rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernels momentum_tpu/ops/raster_pallas.py::_kernel (:196,
// launched by _raster_call :392) and ::_kernel_binned (:220, launched by
// _raster_call_binned :349). Those put pixels in lanes and faces in sublanes,
// reduce over faces with a sublane min, fetch the winner's attributes with a
// one-hot MXU matmul and untile the tile-flat outputs with an XLA transpose.
// None of that suits this card; the algorithm does.
//
// A face is a row of 12 plane coefficients (ops/raster.py face_planes): the
// three barycentric edge functions and the depth, each w(x, y) = a·x + b·y +
// c. A pixel keeps the least depth among the faces with w0, w1, w2 >= 0 and
// z > 0, and the lowest face id among equal depths.
//
// What bounds it on the H100: neither bytes nor FLOPs. At the config-7
// camera pass (1280×960, 612 faces, th = 8) the binned scan does about
// 1200 tiles × 1024 pixels × ≤128 faces × 4 planes × 3 flops ≈ 1.9 GFLOP of
// f32 at most (~30 µs at 67 TFLOP/s) and writes 11 floats a pixel (~54 MB,
// ~16 µs at 3.35 TB/s). Issue rate and the block's serial walk over its
// faces are what is left: on an H100 (700 W) frame 0's camera pass takes
// 0.11 ms, set by its one overflow tile, whose block walks all 640 face rows
// for 8 pixel rows alone on one SM.
//
// Design: one block of 128 threads per (th × 128)-pixel tile; thread c owns
// column c of the tile and its th pixels, keeping (best z, best id) for each
// in registers. The block stages up to 128 face rows (planes + ids) in shared
// memory; every thread then walks them in ascending order, and since all
// threads of a warp read the same row at once, the reads are broadcasts with
// no bank conflicts. Each face's a·x is computed once and reused across the
// thread's th rows. A pixel updates only if the face passes the test and
// z < best: with ids ascending, the first face to reach the least depth is
// the lowest id among those at that depth, JAX's rule (:176-182).
//
//   K4b: the tile's ≤ K binned face ids (ascending, then 1 << 30 in empty
//        slots) come from the binning in ops/raster.py; the block gathers
//        their plane rows itself, so the host never builds per-tile plane or
//        attribute tables. An overflow tile (more than K faces overlap it)
//        scans the whole plane table instead, 128 rows at a time, which with
//        ascending ids and the strict < reproduces JAX's strict < across
//        chunks (:274).
//   K4a: the whole plane table for every tile; ids are the row index.
//
// After the scan, each thread re-evaluates the winner's planes at its pixels
// (barycentrics, and attribute planes (a, b, c) per channel from the
// (Fp, 3, C) table, read once per pixel from device memory, where the
// table's few tens of KB stay in L2) and writes depth, face, barycentrics and
// attributes straight into (H, W), (H, W, 3) and (H, W, C) row-major images,
// with the empty-pixel values (inf, −1, 0, 0) of rasterize_planes.
//
// Numerics. Every plane is evaluated as (a·x + b·y) + c with __fmul_rn and
// __fadd_rn: nvcc would otherwise contract a·x + b·y into an FMA, while the
// plain PyTorch version (ops/raster.py) rounds each product. At an edge
// (w exactly 0) or a depth tie one ulp flips the winner, so only the same
// order and rounding give the same face map. The tests are written w >= 0.f
// and z > 0.f, never !(w < 0.f): a NaN plane value must fail them, as
// where(ok, z, inf) makes it fail in JAX. An empty bin slot's id (1 << 30)
// is never used as an index: its row becomes a killed plane (a = b = 0,
// c0 = −1, so w0 < 0 everywhere), ROADMAP F3.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;   // tile width in pixels = threads per block
constexpr int kStage = 128;  // face rows staged in shared memory per pass
constexpr int kNoFace = 1 << 30;

__device__ __forceinline__ float plane(float ax, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, y)), c);
}

template <int TH, bool BINNED>
__global__ void __launch_bounds__(kCols) raster_kernel(
    const float* __restrict__ planes, int fp, const int* __restrict__ tile_fids, int k,
    const int* __restrict__ overflow, const float* __restrict__ attr_tab, int n_attr,
    int want_bary, float* __restrict__ depth, int* __restrict__ face,
    float* __restrict__ bary, float* __restrict__ attrs, int width, int height, int gj) {
  __shared__ float s_pl[kStage * 12];
  __shared__ int s_id[kStage];
  __shared__ int s_n;

  const int tile = blockIdx.x;
  const int ti = tile / gj;
  const int col = (tile - ti * gj) * kCols + threadIdx.x;
  const int row0 = ti * TH;
  const float x = (float)col + 0.5f;
  float ys[TH], best[TH];
  int bid[TH];
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    ys[r] = (float)(row0 + r) + 0.5f;
    best[r] = __int_as_float(0x7f800000);  // +inf
    bid[r] = kNoFace;
  }

  const bool binned = BINNED && overflow[tile] == 0;
  const int total = binned ? k : fp;
  const int* ids = binned ? tile_fids + (long long)tile * k : nullptr;

  for (int base = 0; base < total; base += kStage) {
    const int n = min(kStage, total - base);
    __syncthreads();  // every thread is done with the previous stage
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const int id = binned ? ids[base + s] : base + s;
      const bool live = id >= 0 && id < fp;
      const float* src = planes + (long long)(live ? id : 0) * 12;
#pragma unroll
      for (int c = 0; c < 12; ++c) s_pl[s * 12 + c] = live ? src[c] : (c == 2 ? -1.f : 0.f);
      s_id[s] = live ? id : kNoFace;
      if (live) atomicMax(&s_n, s + 1);
    }
    __syncthreads();
    const int m = s_n;  // rows past the last live one are all killed
    for (int s = 0; s < m; ++s) {
      const float* p = s_pl + s * 12;
      const float a0x = __fmul_rn(p[0], x), a1x = __fmul_rn(p[3], x);
      const float a2x = __fmul_rn(p[6], x), azx = __fmul_rn(p[9], x);
      const int id = s_id[s];
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const float y = ys[r];
        const float w0 = plane(a0x, p[1], y, p[2]);
        const float w1 = plane(a1x, p[4], y, p[5]);
        const float w2 = plane(a2x, p[7], y, p[8]);
        const float z = plane(azx, p[10], y, p[11]);
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && z > 0.f && z < best[r]) {
          best[r] = z;
          bid[r] = id;
        }
      }
    }
  }

  if (col >= width) return;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int row = row0 + r;
    if (row >= height) break;
    const long long pix = (long long)row * width + col;
    const int f = bid[r];
    const bool empty = f == kNoFace;
    const float y = ys[r];
    depth[pix] = best[r];  // +inf where empty
    face[pix] = empty ? -1 : f;
    if (want_bary) {
      const float* p = planes + (long long)(empty ? 0 : f) * 12;
#pragma unroll
      for (int e = 0; e < 3; ++e)
        bary[pix * 3 + e] =
            empty ? 0.f : plane(__fmul_rn(p[3 * e], x), p[3 * e + 1], y, p[3 * e + 2]);
    }
    if (n_attr > 0) {
      const float* t = attr_tab + (long long)(empty ? 0 : f) * 3 * n_attr;
      for (int c = 0; c < n_attr; ++c)
        attrs[pix * n_attr + c] =
            empty ? 0.f : plane(__fmul_rn(t[c], x), t[n_attr + c], y, t[2 * n_attr + c]);
    }
  }
}

template <bool BINNED, int TH>
int launch_th(const float* planes, int fp, const int* tile_fids, int k, const int* overflow,
              const float* attr_tab, int n_attr, int want_bary, float* depth, int* face,
              float* bary, float* attrs, int width, int height, cudaStream_t stream) {
  const int gi = (height + TH - 1) / TH;
  const int gj = (width + kCols - 1) / kCols;
  raster_kernel<TH, BINNED><<<gi * gj, kCols, 0, stream>>>(
      planes, fp, tile_fids, k, overflow, attr_tab, n_attr, want_bary, depth, face, bary,
      attrs, width, height, gj);
  return (int)cudaGetLastError();
}

template <bool BINNED>
int launch(const float* planes, int fp, const int* tile_fids, int k, const int* overflow,
           const float* attr_tab, int n_attr, int want_bary, float* depth, int* face,
           float* bary, float* attrs, int width, int height, int th, cudaStream_t stream) {
  switch (th) {  // the tile heights rasterize_planes picks: 4 unbinned, 8 binned
    case 4:
      return launch_th<BINNED, 4>(planes, fp, tile_fids, k, overflow, attr_tab, n_attr,
                                  want_bary, depth, face, bary, attrs, width, height, stream);
    case 8:
      return launch_th<BINNED, 8>(planes, fp, tile_fids, k, overflow, attr_tab, n_attr,
                                  want_bary, depth, face, bary, attrs, width, height, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K4a. planes: (fp, 12) float32; attr_tab: (fp, 3, n_attr) float32 or null
// when n_attr = 0; depth, face: (height, width) float32 / int32; bary:
// (height, width, 3) or null unless want_bary; attrs: (height, width, n_attr)
// or null. th in {4, 8}. Launches on `stream`; returns
// cudaGetLastError().
int raster_planes_launch(const void* planes, int fp, const void* attr_tab, int n_attr,
                         int want_bary, void* depth, void* face, void* bary, void* attrs,
                         int width, int height, int th, void* stream) {
  return launch<false>((const float*)planes, fp, nullptr, 0, nullptr,
                       (const float*)attr_tab, n_attr, want_bary, (float*)depth,
                       (int*)face, (float*)bary, (float*)attrs, width, height, th,
                       (cudaStream_t)stream);
}

// K4b. As K4a, plus tile_fids: (gi·gj, k) int32, each tile's binned face ids
// ascending then 1 << 30; overflow: (gi·gj,) int32, nonzero where the tile
// scans all fp faces instead; tiles in row-major order of
// gi = ceil(height / th) rows by gj = ceil(width / 128) columns.
int raster_planes_binned_launch(const void* planes, int fp, const void* tile_fids, int k,
                                const void* overflow, const void* attr_tab, int n_attr,
                                int want_bary, void* depth, void* face, void* bary,
                                void* attrs, int width, int height, int th, void* stream) {
  return launch<true>((const float*)planes, fp, (const int*)tile_fids, k,
                      (const int*)overflow, (const float*)attr_tab, n_attr, want_bary,
                      (float*)depth, (int*)face, (float*)bary, (float*)attrs, width,
                      height, th, (cudaStream_t)stream);
}

}  // extern "C"
