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
// 0 < z < inf, and the lowest face id among equal depths.
//
// What bounds it on the H100: bytes. At the config-7 camera pass (1280×960,
// 612 faces, th = 8) the binned scan does ~2300 face-tile tests (~0.3 µs of
// f32 at 67 TFLOP/s) and writes 11 floats a pixel (54.8 MB, 16.3 µs at
// 3.35 TB/s). On an H100 (700 W) a pass without an overflow tile takes
// ~0.047 ms, 3× that bound; with one, the previous form took 0.116 ms: one
// block scanned all 640 face rows for its 8 × 128 pixels alone on one SM.
// Split across 5 chunk blocks, frame 0's camera pass takes 0.051 ms and the
// shadow pass of frame 11 0.022 (0.086 before); the clip's 64 passes sum to
// 2.11 ms, 2.82 before (tools/kernel_ab.py).
//
// Design: one block of 128 threads per (th × 128)-pixel tile; thread c owns
// column c of the tile and its th pixels, keeping (best z, best id) for each
// in registers. The block stages up to 128 face rows (planes + ids) at a
// time in shared memory: thread s loads row s of the stage as three float4
// (a row is 48 bytes, 16-byte aligned), keeps it only if the face may cover
// a pixel of the tile, and the kept rows are compacted into shared memory in
// ascending order (a warp ballot and a prefix sum over the 4 warps). Every
// thread then walks the kept rows in that order; since all threads of a
// warp read the same row at once, the reads are broadcasts with no bank
// conflicts. K4a loads the next stage's rows into registers before the
// current stage is walked, so their loads overlap the walk. (Staging them
// through shared memory by cp.async, double-buffered, measured slower on an
// H100 at 700 W: 0.111 against 0.080 ms on the 612-face pass below, 0.059
// against 0.031 on the 120-face one; with the walk compiled out the 612-face
// pass takes 0.023 ms, so the walk of the kept rows holds it, not the
// staging; tools/kernel_ab.py's probes.) Each face's a·x
// is computed once and reused across the thread's th rows. A pixel updates
// only if the face passes the test and z < best: with ids ascending, the
// first face to reach the least depth is the lowest id among those at that
// depth, JAX's rule (:176-182).
//
//   K4a: the whole plane table for every tile; ids are the row index. A row
//        is kept only where `may_cover` holds for the tile (below): an edge
//        function or the depth is affine in (x, y), so a face covers no
//        pixel centre of the tile when one of its four planes is negative
//        at all four corner pixel centres. On the 612-face camera pass of
//        config 7 (the mesh covers ~1% of the image) the tiles keep 53 520
//        of the 1.44 M (tile, face) pairs. The previous form tested all 640
//        rows at every pixel of the 2400 tiles: 0.636 ms on an H100 (700 W),
//        0.082 ms now; on the small-mesh render's camera pass (120 faces)
//        0.137 ms, 0.031 now.
//   K4b: the tile's ≤ K binned face ids (ascending, then 1 << 30 in empty
//        slots) come from the binning in ops/raster.py; the block gathers
//        their plane rows itself, so the host never builds per-tile plane or
//        attribute tables. Its rows are already culled by bbox, so it keeps
//        every live row. A tile whose bin overflows (more than K faces
//        overlap it) scans the whole plane table instead, split across
//        blocks: S = ceil(Fp / 128) chunk blocks per group of kGroup = 8
//        consecutive tiles, placed first in the grid so that they start at
//        once. Chunk block (g, c) scans face rows [128c, 128c + 128) for each
//        overflow tile of group g and merges each pixel's winner into a
//        64-bit key (bits of z << 32 | id) with atomicMin: for z > 0 the
//        bits of a float order as its value, and the low word breaks depth
//        ties by the lowest id, so the minimum over chunks is JAX's strict <
//        over ascending chunks (:273-276) and the face map stays identical to
//        the plain version's. The last chunk block to arrive at a tile (a
//        per-tile counter after __threadfence) reads the keys, writes the
//        pixels, and resets keys and counter for the next launch. The tile's
//        own block exits. The keys and counters are scratch owned by the
//        wrapper, set once to all-ones and zero.
//
// The reject is conservative. The per-pixel test computes
// p = (a·x + b·y) + c with each operation rounded, so |p − e| ≤ 3.01·u·S at
// any pixel of the tile, e the exact value, u = 2^-24 and
// S = |a|·xmax + |b|·ymax + |c| (x, y ≥ 0.5 at pixel centres). `may_cover`
// bounds the largest e over the tile's pixel centres by
// hi = e(centre) + |a|·hx + |b|·hy, computed with ≤ 7·u·S of rounding, and
// drops the face only when hi < −2^-20·S for some plane. Then e < −9·u·S at
// every pixel, so p < 0 there and the per-pixel test would drop the face
// too: the face maps stay identical to the plain version's. A NaN plane is
// never dropped (the comparison fails) and never wins (w >= 0 fails).
//
// After the scan, each thread re-evaluates the winner's planes at its pixels
// (barycentrics, and attribute planes (a, b, c) per channel from the
// (Fp, 3, C) table, read once per pixel from device memory, where the
// table's few tens of KB stay in L2) and writes depth, face, barycentrics and
// attributes straight into (H, W), (H, W, 3) and (H, W, C) row-major images,
// with the empty-pixel values (inf, −1, 0, 0) of rasterize_planes. The
// barycentrics and attributes pass through shared memory, so that a warp
// stores a row's 32 pixels as consecutive floats (`write_pixels`).
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
constexpr int kStage = 128;  // face rows staged in shared memory per pass = chunk rows
constexpr int kNoFace = 1 << 30;
// K4a's reject margin, relative to |a|·xmax + |b|·ymax + |c| (the note above)
constexpr float kRejectMargin = 9.5367431640625e-07f;  // 2^-20
constexpr unsigned long long kNoKey = ~0ull;
// floats a pixel that the epilogue stages in shared memory (bary 3, attributes ≤ 8)
constexpr int kOutChannels = 8;
// consecutive tiles that share one set of K4b's chunk blocks (≤ 32, one
// ballot bit each). On an H100 (700 W), frame 0's camera pass of the clip
// took 0.0538 ms with 1 (6000 chunk blocks), 0.0514 with 8, 0.0521 with 32.
constexpr int kGroup = 8;
static_assert(kGroup >= 1 && kGroup <= 32, "one ballot bit per tile of a group");

__device__ __forceinline__ float plane(float ax, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, y)), c);
}

// face rows staged in shared memory: 12 plane coefficients as 3 float4 each
struct Stage {
  float4 pl[kStage * 3];
  int id[kStage];
  int warp_kept[kCols / 32];
};

// A face row in registers: its planes and id, or !live.
struct Row {
  float4 p0, p1, p2;
  int id;
  bool live;
};

// The pixel centres of a tile, columns col0 .. col0 + 127 and rows row0 ..
// row0 + th − 1 at +0.5: their centre, half extents and largest x and y.
struct TileBox {
  float xc, yc, hx, hy, xmax, ymax;
};

__device__ __forceinline__ TileBox tile_box(int col0, int row0, int th) {
  TileBox t;
  t.hx = 0.5f * (float)(kCols - 1);
  t.hy = 0.5f * (float)(th - 1);
  t.xc = (float)col0 + 0.5f + t.hx;
  t.yc = (float)row0 + 0.5f + t.hy;
  t.xmax = t.xc + t.hx;
  t.ymax = t.yc + t.hy;
  return t;
}

// Whether the plane (a, b, c) may be ≥ 0 at a pixel centre of the tile, up
// to the rounding margin of the note above. !(hi < −tol): NaN keeps the face.
__device__ __forceinline__ bool may_reach(float a, float b, float c, const TileBox& t) {
  const float hi = fmaf(a, t.xc, fmaf(b, t.yc, c)) + fabsf(a) * t.hx + fabsf(b) * t.hy;
  const float tol = kRejectMargin * (fabsf(a) * t.xmax + fabsf(b) * t.ymax + fabsf(c));
  return !(hi < -tol);
}

// Whether a face may cover a pixel centre of the tile: its three edge
// functions and its depth may all be ≥ 0 there.
__device__ __forceinline__ bool may_cover(const Row& r, const TileBox& t) {
  return may_reach(r.p0.x, r.p0.y, r.p0.z, t) && may_reach(r.p0.w, r.p1.x, r.p1.y, t) &&
         may_reach(r.p1.z, r.p1.w, r.p2.x, t) && may_reach(r.p2.y, r.p2.z, r.p2.w, t);
}

// The tables a pass reads and the images it writes. The kernels take them
// as __restrict__ parameters and hand them on as such: without it nvcc must
// assume that the epilogue's stores may alias its table loads.
#define RASTER_IO_PARAMS                                                          \
  const float* __restrict__ planes, const float* __restrict__ attr_tab, int n_attr, \
      int want_bary, float* __restrict__ depth, int* __restrict__ face,             \
      float* __restrict__ bary, float* __restrict__ attrs, int width, int height
#define RASTER_IO_ARGS planes, attr_tab, n_attr, want_bary, depth, face, bary, attrs, width, height

// Row s of a scan: face ids[s] (binned) or first + s; not live past
// `total`, for an empty bin slot or an id outside the table.
__device__ __forceinline__ Row load_row(const float* __restrict__ planes, int fp,
                                        const int* __restrict__ ids, int first, int s,
                                        int total) {
  Row r;
  r.id = s < total ? (ids ? ids[s] : first + s) : -1;
  r.live = r.id >= 0 && r.id < fp;
  if (r.live) {
    const float4* src = reinterpret_cast<const float4*>(planes) + (long long)r.id * 3;
    r.p0 = __ldg(src);
    r.p1 = __ldg(src + 1);
    r.p2 = __ldg(src + 2);
  }
  return r;
}

// Scans `total` face rows in ascending order, kStage at a time, keeping
// those that may cover the tile (REJECT) or every live one, and updates
// each pixel's (best, bid).
template <int TH, bool REJECT>
__device__ __forceinline__ void scan(Stage& st, const float* __restrict__ planes, int fp,
                                     const int* __restrict__ ids, int first, int total,
                                     const TileBox& box, float x, const float* ys,
                                     float* best, int* bid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Row row = load_row(planes, fp, ids, first, threadIdx.x, total);
  for (int base = 0; base < total; base += kStage) {
    const bool keep = row.live && (!REJECT || may_cover(row, box));
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) st.warp_kept[warp] = __popc(ballot);
    __syncthreads();  // every thread is done with the previous stage's rows
    int pos = __popc(ballot & ((1u << lane) - 1u)), m = 0;
#pragma unroll
    for (int w = 0; w < kCols / 32; ++w) {
      pos += w < warp ? st.warp_kept[w] : 0;
      m += st.warp_kept[w];
    }
    if (keep) {
      st.pl[pos * 3] = row.p0;
      st.pl[pos * 3 + 1] = row.p1;
      st.pl[pos * 3 + 2] = row.p2;
      st.id[pos] = row.id;
    }
    // K4a's next stage: its row is in flight while this stage is walked (K4b
    // scans one stage at its bin capacity and would only hold the registers)
    if (REJECT) row = load_row(planes, fp, ids, first, base + kStage + threadIdx.x, total);
    __syncthreads();
    for (int s = 0; s < m; ++s) {
      const float* p = reinterpret_cast<const float*>(st.pl + s * 3);
      const float a0x = __fmul_rn(p[0], x), a1x = __fmul_rn(p[3], x);
      const float a2x = __fmul_rn(p[6], x), azx = __fmul_rn(p[9], x);
      const int id = st.id[s];
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
    if (!REJECT) row = load_row(planes, fp, ids, first, base + kStage + threadIdx.x, total);
  }
}

// Writes the th pixels of column `col` from row `row0` down. Depth and face
// are one value a pixel, and the warp's 32 threads store them at 32
// consecutive addresses. The barycentrics and attributes are 3 and n_attr
// floats a pixel: each thread puts its pixel's into `buf`, its warp's
// 32 × kOutChannels floats of shared memory, and the warp then stores the
// row's 32 pixels as consecutive floats, so that every store instruction
// fills whole 128-byte lines (a thread storing its own pixel's floats
// writes 3 or n_attr partial lines per instruction). Past kOutChannels
// attributes, each thread stores its own.
template <int TH>
__device__ __forceinline__ void write_pixels(RASTER_IO_PARAMS, float* __restrict__ buf,
                                             int col, int row0, float x, const float* ys,
                                             const float* best, const int* bid) {
  const int lane = threadIdx.x & 31;
  const int ncols = min(32, width - (col - lane));  // the warp's columns in the image
  if (ncols <= 0) return;
  const bool in = lane < ncols;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int row = row0 + r;
    if (row >= height) break;
    const long long pix0 = (long long)row * width + (col - lane);  // the warp's first pixel
    const int f = bid[r];
    const bool empty = f == kNoFace;
    const float y = ys[r];
    if (in) {
      depth[pix0 + lane] = best[r];  // +inf where empty
      face[pix0 + lane] = empty ? -1 : f;
    }
    if (want_bary) {
      const float* p = planes + (long long)(empty ? 0 : f) * 12;
#pragma unroll
      for (int e = 0; e < 3; ++e)
        buf[lane * 3 + e] =
            empty ? 0.f : plane(__fmul_rn(p[3 * e], x), p[3 * e + 1], y, p[3 * e + 2]);
      __syncwarp();
      for (int k = lane; k < ncols * 3; k += 32) bary[pix0 * 3 + k] = buf[k];
      __syncwarp();
    }
    if (n_attr > 0) {
      const float* t = attr_tab + (long long)(empty ? 0 : f) * 3 * n_attr;
      if (n_attr <= kOutChannels) {
        for (int c = 0; c < n_attr; ++c)
          buf[lane * n_attr + c] =
              empty ? 0.f : plane(__fmul_rn(t[c], x), t[n_attr + c], y, t[2 * n_attr + c]);
        __syncwarp();
        for (int k = lane; k < ncols * n_attr; k += 32) attrs[pix0 * n_attr + k] = buf[k];
        __syncwarp();
      } else if (in) {
        for (int c = 0; c < n_attr; ++c)
          attrs[(pix0 + lane) * n_attr + c] =
              empty ? 0.f : plane(__fmul_rn(t[c], x), t[n_attr + c], y, t[2 * n_attr + c]);
      }
    }
  }
}

template <int TH>
__device__ __forceinline__ void init_pixels(int row0, float* ys, float* best, int* bid) {
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    ys[r] = (float)(row0 + r) + 0.5f;
    best[r] = __int_as_float(0x7f800000);  // +inf
    bid[r] = kNoFace;
  }
}

// K4a: every tile scans the whole plane table.
template <int TH>
__global__ void __launch_bounds__(kCols) raster_planes_kernel(RASTER_IO_PARAMS, int fp,
                                                              int gj) {
  __shared__ Stage st;
  __shared__ float out[kCols * kOutChannels];
  const int tile = blockIdx.x;
  const int ti = tile / gj;
  const int col0 = (tile - ti * gj) * kCols;
  const int col = col0 + threadIdx.x;
  const float x = (float)col + 0.5f;
  float ys[TH], best[TH];
  int bid[TH];
  init_pixels<TH>(ti * TH, ys, best, bid);
  scan<TH, true>(st, planes, fp, nullptr, 0, fp, tile_box(col0, ti * TH, TH), x, ys, best,
                 bid);
  write_pixels<TH>(RASTER_IO_ARGS, out + (threadIdx.x & ~31u) * kOutChannels, col,
                   ti * TH, x, ys, best, bid);
}

// K4b: blocks [0, n_groups·S) are the chunk blocks of the overflow tiles,
// the rest one block per tile.
template <int TH>
__global__ void __launch_bounds__(kCols) raster_planes_binned_kernel(
    RASTER_IO_PARAMS, int fp, const int* __restrict__ tile_fids, int k,
    const int* __restrict__ overflow, int n_tiles, int gj, int n_chunks,
    unsigned long long* __restrict__ keys, int* __restrict__ arrivals) {
  __shared__ Stage st;
  __shared__ float out[kCols * kOutChannels];
  __shared__ unsigned s_mask;
  __shared__ bool s_last;
  float ys[TH], best[TH];
  int bid[TH];
  const int n_chunk_blocks = (n_tiles + kGroup - 1) / kGroup * n_chunks;
  const int cb = blockIdx.x;  // chunk blocks first,
  const int tb = (int)blockIdx.x - n_chunk_blocks;  // then one block per tile

  if (tb >= 0) {
    const int tile = tb;
    if (overflow[tile] != 0) return;  // its chunk blocks scan it
    const int ti = tile / gj;
    const int col = (tile - ti * gj) * kCols + threadIdx.x;
    const float x = (float)col + 0.5f;
    init_pixels<TH>(ti * TH, ys, best, bid);
    scan<TH, false>(st, planes, fp, tile_fids + (long long)tile * k, 0, k, TileBox{}, x, ys,
                    best, bid);
    write_pixels<TH>(RASTER_IO_ARGS, out + (threadIdx.x & ~31u) * kOutChannels, col,
                     ti * TH, x, ys, best, bid);
    return;
  }

  const int g = cb / n_chunks;
  const int chunk = cb - g * n_chunks;
  const int first = chunk * kStage;
  if (threadIdx.x < 32) {  // one bit per tile of the group
    const int t = g * kGroup + threadIdx.x;
    const unsigned m =
        __ballot_sync(0xffffffffu, threadIdx.x < kGroup && t < n_tiles && overflow[t] != 0);
    if (threadIdx.x == 0) s_mask = m;
  }
  __syncthreads();
  for (unsigned mask = s_mask; mask != 0; mask &= mask - 1) {
    const int tile = g * kGroup + __ffs(mask) - 1;
    const int ti = tile / gj;
    const int col = (tile - ti * gj) * kCols + threadIdx.x;
    const float x = (float)col + 0.5f;
    init_pixels<TH>(ti * TH, ys, best, bid);
    scan<TH, false>(st, planes, fp, nullptr, first, min(kStage, fp - first), TileBox{}, x, ys,
                    best, bid);
    unsigned long long* key = keys + (long long)tile * TH * kCols + threadIdx.x;
#pragma unroll
    for (int r = 0; r < TH; ++r)
      if (bid[r] != kNoFace)
        atomicMin(key + r * kCols,
                  ((unsigned long long)__float_as_uint(best[r]) << 32) | (unsigned)bid[r]);
    __threadfence();  // the keys are visible before the arrival counts
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(arrivals + tile, 1) == n_chunks - 1;
    __syncthreads();
    if (s_last) {  // every chunk of the tile has merged its keys
      __threadfence();
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const unsigned long long kv = __ldcg(key + r * kCols);
        key[r * kCols] = kNoKey;
        if (kv != kNoKey) {
          best[r] = __uint_as_float((unsigned)(kv >> 32));
          bid[r] = (int)(kv & 0xffffffffu);
        } else {
          best[r] = __int_as_float(0x7f800000);
          bid[r] = kNoFace;
        }
      }
      if (threadIdx.x == 0) arrivals[tile] = 0;
      write_pixels<TH>(RASTER_IO_ARGS, out + (threadIdx.x & ~31u) * kOutChannels, col,
                       ti * TH, x, ys, best, bid);
    }
  }
}

template <int TH>
int launch_th(RASTER_IO_PARAMS, int fp, const int* tile_fids, int k, const int* overflow,
              unsigned long long* keys, int* arrivals, cudaStream_t stream) {
  const int gi = (height + TH - 1) / TH;
  const int gj = (width + kCols - 1) / kCols;
  const int n_tiles = gi * gj;
  if (tile_fids == nullptr) {
    raster_planes_kernel<TH><<<n_tiles, kCols, 0, stream>>>(RASTER_IO_ARGS, fp, gj);
  } else {
    const int n_chunks = (fp + kStage - 1) / kStage;
    const int blocks = (n_tiles + kGroup - 1) / kGroup * n_chunks + n_tiles;
    raster_planes_binned_kernel<TH><<<blocks, kCols, 0, stream>>>(
        RASTER_IO_ARGS, fp, tile_fids, k, overflow, n_tiles, gj, n_chunks, keys, arrivals);
  }
  return (int)cudaGetLastError();
}

int launch(RASTER_IO_PARAMS, int fp, const int* tile_fids, int k, const int* overflow,
           unsigned long long* keys, int* arrivals, int th, cudaStream_t stream) {
  if (tile_fids != nullptr && fp < 1) return (int)cudaErrorInvalidValue;
  switch (th) {  // the tile heights rasterize_planes picks: 4 unbinned, 8 binned
    case 4:
      return launch_th<4>(RASTER_IO_ARGS, fp, tile_fids, k, overflow, keys, arrivals, stream);
    case 8:
      return launch_th<8>(RASTER_IO_ARGS, fp, tile_fids, k, overflow, keys, arrivals, stream);
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
  return launch((const float*)planes, (const float*)attr_tab, n_attr, want_bary,
                (float*)depth, (int*)face, (float*)bary, (float*)attrs, width, height, fp,
                nullptr, 0, nullptr, nullptr, nullptr, th, (cudaStream_t)stream);
}

// K4b. As K4a, plus tile_fids: (gi·gj, k) int32, each tile's binned face ids
// ascending then 1 << 30; overflow: (gi·gj,) int32, nonzero where the tile
// scans all fp faces instead; tiles in row-major order of
// gi = ceil(height / th) rows by gj = ceil(width / 128) columns. keys:
// (gi·gj, th·128) uint64, all bits set; arrivals: (gi·gj,) int32, zero; the
// kernel leaves both so, and launches that share them must run in order.
int raster_planes_binned_launch(const void* planes, int fp, const void* tile_fids, int k,
                                const void* overflow, const void* attr_tab, int n_attr,
                                int want_bary, void* depth, void* face, void* bary,
                                void* attrs, int width, int height, int th, void* keys,
                                void* arrivals, void* stream) {
  return launch((const float*)planes, (const float*)attr_tab, n_attr, want_bary,
                (float*)depth, (int*)face, (float*)bary, (float*)attrs, width, height, fp,
                (const int*)tile_fids, k, (const int*)overflow, (unsigned long long*)keys,
                (int*)arrivals, th, (cudaStream_t)stream);
}

}  // extern "C"
