// K6 — point_jacobian_kernel: the position rows' model-space Jacobian for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this function with jnp
// operators (momentum_tpu/solver/analytic_jacobian.py::
// fused_point_jacobian_model_merged), and so did the port's plain form,
// solver/analytic_jacobian.py::fused_point_jacobian_model_merged. On the
// card that form writes and reads a dozen intermediates of (B, nJ, 3, P) and
// (B, C, 3, P) floats: at B = 65536, C = 41 markers, nJ = 23 joints and
// P = 73 parameters each is 1.3–2.35 GB, ~28 ms a full-batch Jacobian.
//
// What bounds it on the H100: the output. J (B, 3C, P) float32 is written
// once, 2.35 GB at that size, 0.70 ms at 3.35 TB/s; the inputs (joint
// axes and positions, world points, row scales) add ~0.17 GB, and the
// arithmetic (~11 GFLOP) takes ~0.17 ms at 67 TFLOP/s. So the kernel is
// bound by bytes, and its design keeps everything but J out of device
// memory and writes J once.
//
// Algorithm. Per element and joint j the chain rule through the parameter
// transform folds into one factor G_j (7 × P): with the transform's rows
// PT_j (7 × P) of joint j, its translation and rotation axes T_j, R_j
// (3 × 3, columns = axes) and its world position t_j,
//   G_j[0:3] = T_j·PT_t + ([t_j]×·R_j)·PT_r − ln2·t_j ⊗ PT_s
//   G_j[3:6] = R_j·PT_r
//   G_j[6]   = ln2·PT_s (the same for every element).
// Summed down the tree, S_j = S_parent(j) + G_j (topological order), a
// constraint point p_c below joint j = parent(c) with row scale s_c has the
// rows J_c = s_c·(S_j[0:3] + S_j[3:6] × p_c + p_c ⊗ S_j[6]): the plain
// form's dense (C × nJ) ancestor-mask product becomes one walk down the
// tree. The tree is read off the ancestor-or-self mask: a joint's parent is
// its ancestor of largest index (the joints are in topological order).
//
// Design. A block of 256 threads owns a tile of PT columns of P and walks
// elements (a grid-stride loop, as many blocks as fit on the card). Once, at
// its start, it lists the (joint, column) pairs whose 7 transform rows are
// not all zero (a rig's transform is sparse: each parameter drives one or a
// few joints; the CMU and full-body rigs have one pair a column), keeps
// each column's mask of them over the joints, and sums S[6] down the tree
// (nJ·PT floats). Per element it holds S[0:6] (nJ·6·PT floats), each
// joint's factor matrix [T | [t]×R | R | −ln2·t] and each constraint's
// (p_c, s_c); the element's inputs (21 floats a joint, 4 a constraint) come
// by cp.async into a second buffer while the block works on the element
// before. Per element: the factor matrices (a thread a joint, float4 stores
// 36 floats apart, conflict-free), G of the listed pairs (a thread a pair,
// the transform's entries from the L1 cache), the walk down the tree (a
// thread a column of S, nJ steps, the running sum in a register: only a
// branch's first joint reads its parent's sum back, and G is read only
// where the column's mask lists it), then J: a thread a (constraint,
// column) pair computes its three rows' entries from conflict-free reads of
// S, and a warp's 4-byte streaming stores run along a row, 128 bytes
// coalesced. The first form stored aligned 16-byte chunks across the
// element stride (3C·P·4 = 35 916 bytes at C = 41, P = 73, not a multiple
// of 16): its threads then read S four columns apart, four-way bank
// conflicts, and it took 3.37 ms at B = 65536 against this form's 1.43
// (NVIDIA H100 80GB HBM3, 700 W). In this form the stores bound it: with
// J's loop compiled out it takes 0.745 ms (and the form before this one,
// storing constants in place of J's entries, 1.42). The store phase adds
// ~0.68 ms, J's 2.35 GB at ~1.65 TB/s (about half the card's bandwidth),
// and it hardly overlaps the per-element phases; wider stores staged
// through shared memory are the next step.
//
// Tile. PT is the widest that lets three blocks share an SM (kBudgets: 74
// KB each), the column count spread evenly over the fewest tiles: the CMU
// rig (nJ = 23, C = 41, P = 73) takes one tile of 73 (~60 KB), the repo's
// full-body rig (nJ = 51, C = 80, P = 157) five tiles of 32. A rig too wide
// for three blocks takes the budget of two, or of one.
//
// Numerics: float32 throughout, the plain form's products and sums in
// another order (the factor [t]×R formed before PT_r, the tree walk in
// place of the mask product), so the two agree to float32 rounding of
// sums of nJ terms, not to the bit.
//
// Layout at the interface: anc (nJ, nJ) float 0/1, anc[a, j] = a is j's
// ancestor or j itself; trans, rot (B, nJ, 3, 3) row-major, [.., w, k] =
// component w of axis k; pos (B, nJ, 3) with element stride pos_es and
// joint stride pos_js floats (the skeleton states' first three columns
// fit as they lie); points (B, C, 3); scale (B, C) with element stride
// scale_es (0: one (C,) row for every element) or null (1); cpar (C,)
// int32 joints, clamped into [0, nJ); pt (nJ·7, P); out (B, 3C, P), row
// 3c + v = component v of constraint c.

//
// K6's projection form — projection_jacobian_kernel: the pixel rows of K
// cameras that see the same C points (camera projection modules over one
// locator set, the tracker's keypoints), J (B, 2KC, P), camera k's 2C rows
// in a block. Per element it forms S as K6 does; then, for each chunk of
// kChunk cameras, the chain factor of every (camera k, point c) pair,
//   M'_kc = s_kc · dπ_k/dp_eye(R_k·p_c + t_k) · R_k        (2 × 3)
// (the OpenCV model's derivative in the eye-space point, camera/models.py,
// a pinhole's with zero distortion; s_kc the row scale, zero behind the
// near clip), a thread a pair, and then a thread a (point, column) pair
// forms the point's world Jacobian column j_w = S[0:3] + S[3:6] × p + p·U
// and stores M'_kc·j_w for the chunk's cameras, two rows each, along rows
// as K6 stores. Nothing of J's size is formed anywhere else.
//
// Reckoned before any run, at the multi-view cell's shape (B = 16384,
// C = 41, K = 31, nJ = 23, P = 73): J is 4·B·2KC·P = 12.16 GB, 3.63 ms at
// 3.35 TB/s; the inputs (the element's joints and points, 1877 floats with
// the K·C scales) 0.12 GB; the arithmetic ~17 GFLOP (the chain ~80 flops a
// (camera, point) pair, 1.7 GFLOP; 5 a stored entry, 15.2 GFLOP), 0.25 ms at
// 67 TFLOP/s. So the stores of J bound it, not the per-(camera, point)
// chain, by ~15 to 1: an element stores 742 KB against K6's 36 KB, so its
// per-element phases (S, the chain) are a twentieth of the store phase,
// where in K6 they took half the time. Expected: between K6's reached store
// rate (~1.65 TB/s, 7.4 ms) and ~2.5 TB/s (4.9 ms) a full evaluation.
// Shared memory: K6's block plus the camera records and one chunk's M'
// (10.9 KB at K = 31, C = 41), so the CMU rig keeps one tile of 73 columns
// and three blocks an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// floats between joints' factor matrices (30 used): 16-byte aligned, and
// 36 ≡ 4 (mod 32) banks, so that eight threads' float4 stores of eight
// joints' matrices fall in distinct banks
constexpr int kMatrix = 36;
// Shared memory a block may take for 3, 2 or 1 blocks an SM: the SM's
// 228 KB less 1 KB reserved a block, shared; a block's most is 227 KB.
constexpr int kBudgets[3] = {75776, 115712, 232448};
constexpr float kLn2 = 0.6931471805599453f;
// The projection form: floats of a camera's record (R row-major, t, then
// fx, fy, cx, cy, k1..k6, p1, p2) and the cameras of one chunk of chain
// factors.
constexpr int kCamera = 24;
constexpr int kChunk = 8;

// Floats of one element's inputs: T, R (9 a joint), t (3 a joint), points
// (3 a constraint) and scales (1 a constraint).
__host__ __device__ __forceinline__ int record_floats(int nj, int c) { return 21 * nj + 4 * c; }

// 32-bit words of a column's joint mask
__host__ __device__ __forceinline__ int mask_words(int nj) { return (nj + 31) / 32; }

// Bytes of dynamic shared memory of a block with a tile of pt_tile columns:
// floats (factor matrices, constraints, U, S, two records), ints (the
// parents, the joints' masks of tree links, the columns' joint masks, the
// count of nonzero factors) and the nonzero factors' indices (16 bits each).
long long smem_bytes(int nj, int c, int pt_tile) {
  const long long floats =
      (long long)kMatrix * nj + 4LL * c + 7LL * nj * pt_tile + 2LL * record_floats(nj, c);
  const long long ints = nj + c + (2LL + pt_tile) * mask_words(nj) + 1;
  return 4 * (floats + ints) + 2LL * nj * pt_tile;
}

// The widest tile whose block, with `extra` bytes more, fits `budget`
// bytes, P spread evenly over the fewest tiles; 0 where not one column fits.
int tile_for(int nj, int c, int p, long long budget, long long extra) {
  const long long fixed = smem_bytes(nj, c, 0) + extra;
  const long long per_column = smem_bytes(nj, c, 1) - smem_bytes(nj, c, 0);
  const long long widest = (budget - fixed) / per_column;
  if (widest < 1) return 0;
  if (widest >= p) return p;
  const long long tiles = (p + widest - 1) / widest;
  return (int)((p + tiles - 1) / tiles);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Inputs {
  const float* trans;
  const float* rot;
  const float* pos;
  long long pos_es;
  int pos_js;
  const float* points;
  const float* scale;
  long long scale_es;
};

// Element e's record into `rec` by cp.async: [T | R | t | points | scales].
__device__ __forceinline__ void fetch_record(const Inputs& in, long long e, int nj, int c,
                                             float* rec) {
  const int n_t = 9 * nj, n_pos = 3 * nj, n_pts = 3 * c;
  const int n = record_floats(nj, c) - (in.scale ? 0 : c);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float* src;
    if (i < n_t) {
      src = in.trans + e * n_t + i;
    } else if (i < 2 * n_t) {
      src = in.rot + e * n_t + (i - n_t);
    } else if (i < 2 * n_t + n_pos) {
      const int k = i - 2 * n_t, j = k / 3;
      src = in.pos + e * in.pos_es + (long long)j * in.pos_js + (k - 3 * j);
    } else if (i < 2 * n_t + n_pos + n_pts) {
      src = in.points + e * n_pts + (i - 2 * n_t - n_pos);
    } else {
      src = in.scale + e * in.scale_es + (i - 2 * n_t - n_pos - n_pts);
    }
    cp_async4(rec + i, src);
  }
  cp_async_commit();
}

// K6's shared memory of a block (the projection form puts its own after `end`).
struct Shared {
  float* M;              // (nJ, kMatrix) factor matrices
  float4* cd;            // (C,) (p_c, s_c)
  float* U;              // (nJ, PT) ln2·PT_s summed down the tree
  float* S;              // (nJ·6, PT) the element's sums down the tree
  float* rec0;           // two records
  int* jpar;             // (nJ,) parents
  int* cpar;             // (C,) the constraints' joints
  unsigned* chain;       // (words,) bit j: joint j's parent is joint j − 1
  unsigned* roots;       // (words,) bit j: joint j is a root
  unsigned* colmask;     // (PT, words) the columns' nonzero joints
  int* n_items;          // the count of nonzero (joint, column) pairs
  unsigned short* items;  // (nJ·PT,) the nonzero pairs
  void* end;             // the first byte past them
};

__device__ __forceinline__ Shared carve(void* base, int nj, int c, int pt_tile) {
  Shared sh;
  float4* const smem4 = reinterpret_cast<float4*>(base);
  sh.M = reinterpret_cast<float*>(smem4);
  sh.cd = smem4 + nj * (kMatrix / 4);
  sh.U = reinterpret_cast<float*>(sh.cd + c);
  sh.S = sh.U + nj * pt_tile;
  sh.rec0 = sh.S + 6 * nj * pt_tile;
  const int words = mask_words(nj);
  sh.jpar = reinterpret_cast<int*>(sh.rec0 + 2 * record_floats(nj, c));
  sh.cpar = sh.jpar + nj;
  sh.chain = reinterpret_cast<unsigned*>(sh.cpar + c);
  sh.roots = sh.chain + words;
  sh.colmask = sh.roots + words;
  sh.n_items = reinterpret_cast<int*>(sh.colmask + pt_tile * words);
  sh.items = reinterpret_cast<unsigned short*>(sh.n_items + 1);
  sh.end = sh.items + nj * pt_tile;
  return sh;
}

// Once a block: the tree off the mask, the constraints' joints, the
// nonzero (joint, column) pairs of the tile and U. The caller synchronizes
// the block before it reads them.
__device__ __forceinline__ void block_setup(const Shared& sh, const float* __restrict__ anc,
                                            const int* __restrict__ cpar_g,
                                            const float* __restrict__ ptc, int p, int c, int nj,
                                            int pt_tile, int w) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int words = mask_words(nj);
  for (int j = tid; j < nj; j += kThreads) {
    int par = -1;
    for (int a = j - 1; a >= 0; --a) {
      if (anc[(long long)a * nj + j] != 0.f) {
        par = a;
        break;
      }
    }
    sh.jpar[j] = par;
  }
  for (int i = tid; i < c; i += kThreads) sh.cpar[i] = min(max(cpar_g[i], 0), nj - 1);
  __syncthreads();
  for (int i = tid; i < words; i += kThreads) {
    unsigned link = 0, root = 0;
    for (int j = 32 * i; j < min(32 * i + 32, nj); ++j) {
      link |= (unsigned)(sh.jpar[j] == j - 1) << (j & 31);
      root |= (unsigned)(sh.jpar[j] < 0) << (j & 31);
    }
    sh.chain[i] = link;
    sh.roots[i] = root;
  }
  // The (joint, column) pairs whose factor is not zero (the parameter
  // transform is sparse: each parameter drives a few joints) as each
  // column's mask over the joints, a thread a pair, with ln2·PT_s into U;
  // then the pairs listed in order by warp 0, and U summed down the tree:
  // U_j = ln2·Σ_{a ≤ j} PT_s,a, the same for every element.
  for (int i = tid; i < pt_tile * words; i += kThreads) sh.colmask[i] = 0u;
  __syncthreads();
  for (int i = tid; i < nj * pt_tile; i += kThreads) {
    const int j = i / pt_tile, col = i - j * pt_tile;
    float x[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      x[k] = col < w ? __ldg(ptc + (long long)(7 * j + k) * p + col) : 0.f;
    bool nz = false;
#pragma unroll
    for (int k = 0; k < 7; ++k) nz |= x[k] != 0.f;
    if (nz) atomicOr(sh.colmask + col * words + (j >> 5), 1u << (j & 31));
    sh.U[i] = kLn2 * x[6];
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < nj * pt_tile; base += 32) {
      const int item = base + lane;
      const int j = item / pt_tile, col = item - j * pt_tile;
      const bool nz =
          item < nj * pt_tile && ((sh.colmask[col * words + (j >> 5)] >> (j & 31)) & 1u);
      const unsigned ballot = __ballot_sync(0xffffffffu, nz);
      if (nz) sh.items[count + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)item;
      count += __popc(ballot);
    }
    if (lane == 0) *sh.n_items = count;
  }
  for (int col = tid; col < pt_tile; col += kThreads)
    for (int j = 1; j < nj; ++j)
      if (sh.jpar[j] >= 0) sh.U[j * pt_tile + col] += sh.U[sh.jpar[j] * pt_tile + col];
}

// Per element, after its record has landed: S, the element's per-joint
// factors summed down the tree (three phases, the block synchronized after
// each); cd holds (p_c, s_c), s_c 1 without scales.
__device__ __forceinline__ void element_sums(const Shared& sh, const float* rec, bool scaled,
                                             const float* __restrict__ ptc, int p, int c,
                                             int nj, int pt_tile) {
  const int tid = threadIdx.x;
  const int words = mask_words(nj);
  const int stride = 6 * pt_tile;  // floats of one joint's S

  // Each joint's [T | [t]×R | R | −ln2·t]; each constraint's (p_c, s_c).
  for (int i = tid; i < nj + c; i += kThreads) {
    if (i < nj) {
      const float* T = rec + 9 * i;
      const float* R = rec + 9 * nj + 9 * i;
      const float* t = rec + 18 * nj + 3 * i;
      float m[32];
#pragma unroll
      for (int k = 0; k < 9; ++k) m[k] = T[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        m[9 + k] = t[1] * R[6 + k] - t[2] * R[3 + k];  // ([t]× R) row 0
        m[12 + k] = t[2] * R[k] - t[0] * R[6 + k];     // row 1
        m[15 + k] = t[0] * R[3 + k] - t[1] * R[k];     // row 2
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) m[18 + k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) m[27 + k] = -kLn2 * t[k];
      m[30] = m[31] = 0.f;
      float4* m4 = reinterpret_cast<float4*>(sh.M + kMatrix * i);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m4[k] = make_float4(m[4 * k], m[4 * k + 1], m[4 * k + 2], m[4 * k + 3]);
    } else {
      const int k = i - nj;
      const float* pts = rec + 21 * nj + 3 * k;
      sh.cd[k] = make_float4(pts[0], pts[1], pts[2], scaled ? rec[21 * nj + 3 * c + k] : 1.f);
    }
  }
  __syncthreads();

  // G of the nonzero (joint, column) pairs, a thread a pair.
  for (int t = tid; t < *sh.n_items; t += kThreads) {
    const int item = sh.items[t];
    const int j = item / pt_tile, col = item - j * pt_tile;
    float m[32];
    const float4* m4 = reinterpret_cast<const float4*>(sh.M + kMatrix * j);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 q = m4[k];
      m[4 * k] = q.x;
      m[4 * k + 1] = q.y;
      m[4 * k + 2] = q.z;
      m[4 * k + 3] = q.w;
    }
    float x[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) x[k] = __ldg(ptc + (long long)(7 * j + k) * p + col);
    float* s = sh.S + j * stride + col;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      s[v * pt_tile] = m[3 * v] * x[0] + m[3 * v + 1] * x[1] + m[3 * v + 2] * x[2] +
                       m[9 + 3 * v] * x[3] + m[10 + 3 * v] * x[4] + m[11 + 3 * v] * x[5] +
                       m[27 + v] * x[6];
      s[(3 + v) * pt_tile] =
          m[18 + 3 * v] * x[3] + m[19 + 3 * v] * x[4] + m[20 + 3 * v] * x[5];
    }
  }
  __syncthreads();

  // Down the tree, a thread two columns of S: S_j = S_parent(j) + G_j,
  // G_j read where the column's mask lists it (else zero). The parent is
  // mostly the joint before, whose sum the thread still holds: only a
  // branch's first joint reads its parent's sum back.
  for (int q = tid; q < stride; q += 2 * kThreads) {
    const int q2 = q + kThreads;
    const bool two = q2 < stride;
    const unsigned* mask = sh.colmask + (q % pt_tile) * words;
    const unsigned* mask2 = sh.colmask + (two ? q2 % pt_tile : 0) * words;
    unsigned bits = 0, bits2 = 0, link = 0, root = 0;
    float prev = 0.f, prev2 = 0.f;
    for (int j = 0; j < nj; ++j) {
      const int b = j & 31;
      if (b == 0) {
        bits = mask[j >> 5];
        bits2 = two ? mask2[j >> 5] : 0u;
        link = sh.chain[j >> 5];
        root = sh.roots[j >> 5];
      }
      float* const sj = sh.S + j * stride;
      if ((root >> b) & 1u) {
        prev = prev2 = 0.f;
      } else if (!((link >> b) & 1u)) {
        const float* const sa = sh.S + sh.jpar[j] * stride;
        prev = sa[q];
        if (two) prev2 = sa[q2];
      }
      if ((bits >> b) & 1u) prev += sj[q];
      if ((bits2 >> b) & 1u) prev2 += sj[q2];
      sj[q] = prev;
      if (two) sj[q2] = prev2;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 3) point_jacobian_kernel(
    const float* __restrict__ anc, Inputs in, const int* __restrict__ cpar_g,
    const float* __restrict__ pt, float* __restrict__ out, int batch, int c, int nj, int p,
    int pt_tile) {
  extern __shared__ float4 smem4[];
  const Shared sh = carve(smem4, nj, c, pt_tile);
  const int rec_n = record_floats(nj, c);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * pt_tile;
  const int w = min(pt_tile, p - p0);  // this tile's columns
  const int stride = 6 * pt_tile;
  const float* const ptc = pt + p0;  // the tile's first column
  long long e = blockIdx.y;
  if (e < batch) fetch_record(in, e, nj, c, sh.rec0);
  block_setup(sh, anc, cpar_g, ptc, p, c, nj, pt_tile, w);

  int buf = 0;
  for (; e < batch; e += gridDim.y, buf ^= 1) {
    float* const rec = sh.rec0 + buf * rec_n;
    cp_async_wait_all();
    __syncthreads();  // the record has landed; the last element's J is out
    if (e + gridDim.y < batch)
      fetch_record(in, e + gridDim.y, nj, c, sh.rec0 + (buf ^ 1) * rec_n);
    element_sums(sh, rec, in.scale != nullptr, ptc, p, c, nj, pt_tile);

    // J, a thread a (constraint, column) pair: its three rows' entries,
    // s·(S[0:3] + S[3:6] × p + p·U), stored by streaming 4-byte stores that
    // a warp makes along a row (coalesced).
    float* const dst = out + e * (3LL * c) * p + p0;
    const int dc = kThreads / w, dcol = kThreads - dc * w;
    int cc = tid / w, col = tid - cc * w;
    for (; cc < c; cc += dc, col += dcol) {
      if (col >= w) {
        col -= w;
        if (++cc >= c) break;
      }
      const int j = sh.cpar[cc];
      const float4 q = sh.cd[cc];
      const float* s = sh.S + j * stride + col;
      const float a0 = s[0], a1 = s[pt_tile], a2 = s[2 * pt_tile];
      const float d0 = s[3 * pt_tile], d1 = s[4 * pt_tile], d2 = s[5 * pt_tile];
      const float u = sh.U[j * pt_tile + col];
      float* row = dst + 3LL * cc * p + col;
      __stcs(row, q.w * (a0 + (d1 * q.z - d2 * q.y) + q.x * u));
      __stcs(row + p, q.w * (a1 + (d2 * q.x - d0 * q.z) + q.y * u));
      __stcs(row + 2 * p, q.w * (a2 + (d0 * q.y - d1 * q.x) + q.z * u));
    }
  }
}

// The projection form's extra shared memory, in floats: the cameras'
// records (kCamera floats each) and one chunk's chain factors M'.
__host__ __device__ __forceinline__ long long projection_floats(int c, int k) {
  return (long long)kCamera * k + 6LL * kChunk * c;
}

// The projection form. Per element, after S: for each chunk of kChunk
// cameras, M'_kc = s_kc·dπ_k/dp_eye·R_k (2 × 3) of every (camera, point)
// pair of the chunk, a thread a pair; then a thread a (point, column) pair
// forms the point's world Jacobian column j_w = S[0:3] + S[3:6] × p + p·U
// and stores M'_kc·j_w, two rows a camera, along rows as K6 stores.
__global__ void __launch_bounds__(kThreads, 3) projection_jacobian_kernel(
    const float* __restrict__ anc, Inputs in, const float* __restrict__ scale,
    const float* __restrict__ cams_g, const int* __restrict__ cpar_g,
    const float* __restrict__ pt, float* __restrict__ out, int batch, int c, int ncam, int nj,
    int p, int pt_tile) {
  extern __shared__ float4 smem4[];
  const Shared sh = carve(smem4, nj, c, pt_tile);
  // 16-byte aligned past the ints
  float* const cams =
      reinterpret_cast<float*>(((reinterpret_cast<size_t>(sh.end) + 15) / 16) * 16);
  float* const Mp = cams + kCamera * ncam;  // (kChunk, C, 6)
  const int rec_n = record_floats(nj, c);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * pt_tile;
  const int w = min(pt_tile, p - p0);
  const int stride = 6 * pt_tile;
  const float* const ptc = pt + p0;
  const long long rows_e = 2LL * ncam * c;  // J's rows an element
  long long e = blockIdx.y;
  if (e < batch) fetch_record(in, e, nj, c, sh.rec0);
  for (int i = tid; i < kCamera * ncam; i += kThreads) cams[i] = cams_g[i];
  block_setup(sh, anc, cpar_g, ptc, p, c, nj, pt_tile, w);

  int buf = 0;
  for (; e < batch; e += gridDim.y, buf ^= 1) {
    float* const rec = sh.rec0 + buf * rec_n;
    cp_async_wait_all();
    __syncthreads();
    if (e + gridDim.y < batch)
      fetch_record(in, e + gridDim.y, nj, c, sh.rec0 + (buf ^ 1) * rec_n);
    element_sums(sh, rec, false, ptc, p, c, nj, pt_tile);
    const float* const sc = scale + e * (long long)ncam * c;
    float* const dst = out + e * rows_e * p + p0;

    for (int k0 = 0; k0 < ncam; k0 += kChunk) {
      const int nk = min(kChunk, ncam - k0);
      if (k0 > 0) __syncthreads();  // the chunk before is stored
      // M' of the chunk's (camera, point) pairs: the OpenCV model's
      // derivative at p_eye = R·p + t (camera/models.py's arithmetic),
      // times R, times the row scale; zero where the scale is (behind the
      // near clip, or no weight).
      for (int i = tid; i < nk * c; i += kThreads) {
        const int kk = i / c, cc = i - kk * c;
        const float s = sc[(long long)(k0 + kk) * c + cc];
        float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (s != 0.f) {
          const float* cam = cams + kCamera * (k0 + kk);
          const float* R = cam;
          const float4 q = sh.cd[cc];
          const float x = R[0] * q.x + R[1] * q.y + R[2] * q.z + cam[9];
          const float y = R[3] * q.x + R[4] * q.y + R[5] * q.z + cam[10];
          float z = R[6] * q.x + R[7] * q.y + R[8] * q.z + cam[11];
          if (!(fabsf(z) > 1e-12f)) z = 1.f;
          const float xp = x / z, yp = y / z, inv_z = 1.f / z;
          const float fx = cam[12], fy = cam[13];
          const float* kd = cam + 16;  // k1..k6, p1, p2
          const float r2 = xp * xp + yp * yp;
          const float num = 1.f + r2 * (kd[0] + r2 * (kd[1] + r2 * kd[2]));
          const float den = 1.f + r2 * (kd[3] + r2 * (kd[4] + r2 * kd[5]));
          const float radial = num / den;
          const float d_num = kd[0] + r2 * (2.f * kd[1] + 3.f * r2 * kd[2]);
          const float d_den = kd[3] + r2 * (2.f * kd[4] + 3.f * r2 * kd[5]);
          const float g = (d_num - radial * d_den) / den;
          const float p1 = kd[6], p2 = kd[7];
          const float cross = 2.f * xp * yp * g + 2.f * p1 * xp + 2.f * p2 * yp;
          const float a = radial + 2.f * xp * xp * g + 2.f * p1 * yp + 6.f * p2 * xp;
          const float d = radial + 2.f * yp * yp * g + 6.f * p1 * yp + 2.f * p2 * xp;
          const float su = s * fx * inv_z, sv = s * fy * inv_z;
          const float du[3] = {su * a, su * cross, -su * (a * xp + cross * yp)};
          const float dv[3] = {sv * cross, sv * d, -sv * (cross * xp + d * yp)};
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            m[v] = du[0] * R[v] + du[1] * R[3 + v] + du[2] * R[6 + v];
            m[3 + v] = dv[0] * R[v] + dv[1] * R[3 + v] + dv[2] * R[6 + v];
          }
        }
        float* const mp = Mp + 6 * i;
#pragma unroll
        for (int v = 0; v < 6; ++v) mp[v] = m[v];
      }
      __syncthreads();

      // J, a thread a (point, column) pair: j_w from S, then two rows'
      // entries a camera of the chunk, by streaming 4-byte stores along
      // rows (coalesced).
      const int dc = kThreads / w, dcol = kThreads - dc * w;
      int cc = tid / w, col = tid - cc * w;
      for (; cc < c; cc += dc, col += dcol) {
        if (col >= w) {
          col -= w;
          if (++cc >= c) break;
        }
        const int j = sh.cpar[cc];
        const float4 q = sh.cd[cc];
        const float* s = sh.S + j * stride + col;
        const float a0 = s[0], a1 = s[pt_tile], a2 = s[2 * pt_tile];
        const float d0 = s[3 * pt_tile], d1 = s[4 * pt_tile], d2 = s[5 * pt_tile];
        const float u = sh.U[j * pt_tile + col];
        const float j0 = a0 + (d1 * q.z - d2 * q.y) + q.x * u;
        const float j1 = a1 + (d2 * q.x - d0 * q.z) + q.y * u;
        const float j2 = a2 + (d0 * q.y - d1 * q.x) + q.z * u;
        float* row = dst + ((long long)k0 * 2 * c + 2LL * cc) * p + col;
        const float* mp = Mp + 6 * cc;
        for (int kk = 0; kk < nk; ++kk, row += 2LL * c * p, mp += 6 * c) {
          __stcs(row, mp[0] * j0 + mp[1] * j1 + mp[2] * j2);
          __stcs(row + p, mp[3] * j0 + mp[4] * j1 + mp[5] * j2);
        }
      }
    }
  }
}

// The grid of a kernel taking `smem` bytes a block: `tiles` columns of
// blocks, as many rows as the card holds at once, each walking elements.
cudaError_t grid_for(const void* kernel, int smem, int tiles, int batch, dim3* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long per_tile = ((long long)sms * (per_sm > 0 ? per_sm : 1) + tiles - 1) / tiles;
  if (per_tile > batch) per_tile = batch;
  if (per_tile > 65535) per_tile = 65535;
  *grid = dim3(tiles, (unsigned)per_tile);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The column tile point_jacobian_launch takes for (nJ, C, P): P itself
// where one tile fits three blocks an SM, else fewer columns; 0 where not
// one column fits a block.
int point_jacobian_tile(int nj, int c, int p) {
  for (int budget : kBudgets) {
    const int tile = tile_for(nj, c, p, budget, 0);
    if (tile > 0) return tile;
  }
  return 0;
}

// The same rule for the projection form over K cameras.
int projection_jacobian_tile(int nj, int c, int k, int p) {
  for (int budget : kBudgets) {
    const int tile = tile_for(nj, c, p, budget, 4 * projection_floats(c, k) + 16);
    if (tile > 0) return tile;
  }
  return 0;
}

// See the note at the top for the layouts. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes out of range.
int point_jacobian_launch(const void* anc, const void* trans, const void* rot, const void* pos,
                          long long pos_es, int pos_js, const void* points, const void* scale,
                          long long scale_es, const void* cpar, const void* pt, void* out,
                          int batch, int c, int nj, int p, void* stream) {
  if (batch < 1 || c < 1 || nj < 1 || p < 1 || 3LL * c * p > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int pt_tile = point_jacobian_tile(nj, c, p);
  if (pt_tile < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(nj, c, pt_tile);
  const int tiles = (p + pt_tile - 1) / pt_tile;
  dim3 grid;
  const cudaError_t err =
      grid_for((const void*)point_jacobian_kernel, smem, tiles, batch, &grid);
  if (err != cudaSuccess) return (int)err;
  const Inputs in{(const float*)trans, (const float*)rot, (const float*)pos,
                  pos_es, pos_js, (const float*)points, (const float*)scale, scale_es};
  point_jacobian_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)anc, in, (const int*)cpar, (const float*)pt, (float*)out, batch, c, nj, p,
      pt_tile);
  return (int)cudaGetLastError();
}

// The projection form: trans, rot, pos, points and cpar as K6 takes them;
// scale (B, K·C) row scales; cams (K, 24) camera records; out (B, 2KC, P),
// row 2(kC + c) + v = component v of camera k's pixel of point c.
int projection_jacobian_launch(const void* anc, const void* trans, const void* rot,
                               const void* pos, long long pos_es, int pos_js,
                               const void* points, const void* scale, const void* cams,
                               const void* cpar, const void* pt, void* out, int batch, int c,
                               int k, int nj, int p, void* stream) {
  if (batch < 1 || c < 1 || k < 1 || nj < 1 || p < 1 || 2LL * k * c * p > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int pt_tile = projection_jacobian_tile(nj, c, k, p);
  if (pt_tile < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)(smem_bytes(nj, c, pt_tile) + 4 * projection_floats(c, k) + 16);
  const int tiles = (p + pt_tile - 1) / pt_tile;
  dim3 grid;
  const cudaError_t err =
      grid_for((const void*)projection_jacobian_kernel, smem, tiles, batch, &grid);
  if (err != cudaSuccess) return (int)err;
  const Inputs in{(const float*)trans, (const float*)rot, (const float*)pos,
                  pos_es, pos_js, (const float*)points, nullptr, 0};
  projection_jacobian_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)anc, in, (const float*)scale, (const float*)cams, (const int*)cpar,
      (const float*)pt, (float*)out, batch, c, k, nj, p, pt_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
