// RoI align: TF1-bilinear crop-and-resize of integer feature-space ROIs
// [x1, y1, x2, y2] to P x P cells, NHWC in, (B, R, P, P, C) out; and its
// backward, the 4-tap scatter-add of the pooled cotangent into the map.
//
// Replaces: faster_rcnn_tpu/ops/roi_align_pallas.py _kernel (pallas_call at
// :178, driven by _forward :104, entry roi_align_pallas :195). The TPU kernel
// recast the resize as two dense matmuls with tap-weight matrices for the
// MXU, over the ROIs sorted by y1 so that it could skip chunks of the map.
// Its backward (_bwd :213) is no Pallas kernel there: XLA's transpose of the
// einsum form roi_align_einsum, computed in f32 and cast to the feature
// dtype. The backward kernel below is its counterpart.
//
// Forward. What bounds it on the H100: bytes. It must read the map pixels
// that the ROIs' taps touch, once, and write the pooled output, once: at
// B=16, 300 ROIs, a 38x94x1024 bf16 map, 52 MB of touched pixels and 481.7
// MB of output, 0.159 ms at 3.35 TB/s; at one frame, 300 ROIs, C=512, 1.8 MB
// and 15.1 MB, 5.0 us. The interpolation is 9 f32 operations a value, far
// below the card's rate. The output dominates, and each output vector needs
// four tap vectors, which the L2 (and L1, where cells share taps) serves.
//
// Design: no matmul, so no tensor cores; the design is about bytes in
// flight, idle lanes, instructions per output vector and the L2.
//   * A block takes one ROI's cells for one chunk of K1_VECS = 32 16-byte
//     vectors of channels (256 bf16 or 128 f32 channels): lane x of warp y
//     owns vector x of the chunk in column j = y of every cell row, a (cell
//     column, vector) map, so the paths' C (512 and 1024, 2 to 8 chunks)
//     leave no lane idle. A
//     warp reads 512 contiguous bytes of a tap pixel and writes 512 of the
//     output; the 7 warps of a block read neighbouring columns of the same
//     rows, which the L1 serves where cells share taps.
//   * A frame's 300 ROIs make 600 to 2,400 blocks of 7 warps, one wave.
//   * P is a template argument for the one pool size the paths use (7): one
//     warp a column; other P take a generic instantiation (8 warps, the
//     columns in turn).
//   * The ROI's row taps are computed once a block, into shared memory, as
//     map offsets (one 16-byte load a cell row); a thread computes its
//     column's taps once, in registers. Per output vector: at most 4 loads,
//     the lerps, 1 store and a few address adds.
//   * A thread runs its column's cell rows in order, and a tap row that the
//     row before used keeps its horizontal lerps in registers (the same
//     operations on the same values, the same bits). Where a crop is under
//     14 map rows, neighbouring cells share tap rows (the hi tap of cell i
//     is the lo tap of cell i + 1, or cells repeat a row), and those cells
//     need two thirds of the lerps. In bf16 every tap is loaded all the
//     same and the 7 rows unroll, so their loads overlap; in f32, whose
//     output is twice the bytes, a kept tap row is not loaded again, and
//     its rows stay rolled (unrolled, f32 ran 29-38% slower). Tried and
//     dropped, on the bench script's inputs: a flat (cell, vector) map (a
//     division and shared taps per item); two rows' loads before their
//     lerps with no reuse (faster at the joint step's tall crops, slower at
//     detect); either beside the other in one kernel (92 registers); an L1
//     prefetch of the next row's taps; an ROI's cell rows cut over 2 or 7
//     blocks. The explicit minimum of one block in __launch_bounds__ gave
//     64 registers where none gave 68, and 4% at B=16 detect.
//   * Stores are streaming (st.global.cs; plain stores ran 1-15% slower):
//     the write-once output is marked evict-first, so it does not push the
//     map, which an image's ROIs read again and again, out of the L2.
//   * The lerps are __fsub_rn, __fmul_rn and __fadd_rn in the plain
//     version's order (ops/roi_align.py roi_align_batched): top = f00 +
//     (f01 - f00) * fx, bot = f10 + (f11 - f10) * fx, top + (bot - top) * fy,
//     in f32, so nvcc cannot contract them into FMAs and the kernel gives the
//     plain version's bits in bf16 and in f32 (rounded once to bf16). The
//     taps divide crop by P truly, as the plain version does.
// The tap arithmetic repeats faster_rcnn_tpu/ops/roi_align.py _tap_weights
// and the gather form roi_align: crop/P first, then i*(crop/P), floor, the
// crop-1 clamp of the upper tap, then the [0, limit-1] clamp.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int K1_VECS = 32;          // vectors of channels a block takes: one a lane
constexpr int K1_GENERIC_WARPS = 8;  // warps of a block for a pool size other than 7

struct Taps {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Taps taps(int i, float start, float crop, int P, int limit) {
  const float src = (float)i * (crop / (float)P);
  const float lo = floorf(src);
  Taps t;
  t.frac = src - lo;
  const float lo_abs = fminf(fmaxf(lo + start, 0.f), (float)(limit - 1));
  const float hi_abs = fminf(fmaxf(fminf(lo + 1.f, crop - 1.f) + start, 0.f), (float)(limit - 1));
  t.lo = (int)lo_abs;
  t.hi = (int)hi_abs;
  return t;
}

// a + (b - a) * f, each operation rounded on its own, as PyTorch's separate
// elementwise kernels round them
__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

// PT: the pool size, or 0 for the generic instantiation (P from p_arg).
// Block (r * chunks + chunk, b) writes the cells of ROI r of image b,
// vectors [chunk K1_VECS, (chunk + 1) K1_VECS) of each; thread (x, y) the
// vector chunk K1_VECS + x of columns j = y, y + blockDim.y, ... of every
// cell row.
template <typename T, int PT>
__global__ void __launch_bounds__(K1_VECS * (PT > 0 ? PT : K1_GENERIC_WARPS), 1)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois, T* __restrict__ out,
                 int H, int W, int C, int R, int p_arg) {
  const int P = PT > 0 ? PT : p_arg;
  extern __shared__ int4 rows[];  // [P]: lo offset, hi offset, frac's bits
  constexpr int VN = Vec16<T>::N;
  const int nvec = C / VN, chunks = (nvec + K1_VECS - 1) / K1_VECS;
  const int b = blockIdx.y, r = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const float* roi = rois + ((size_t)b * R + r) * 4;
  const float x1 = roi[0], y1 = roi[1], crop_w = roi[2] - x1, crop_h = roi[3] - y1;
  for (int k = threadIdx.y * K1_VECS + threadIdx.x; k < P; k += K1_VECS * blockDim.y) {
    const Taps t = taps(k, y1, crop_h, P, H);
    rows[k] = make_int4(t.lo * W * nvec, t.hi * W * nvec, __float_as_int(t.frac), 0);
  }
  __syncthreads();
  const int v = chunk * K1_VECS + threadIdx.x;
  if (v >= nvec) return;

  const uint4* fb = reinterpret_cast<const uint4*>(feat + (size_t)b * H * W * C);
  uint4* ob = reinterpret_cast<uint4*>(out + ((size_t)b * R + r) * P * P * C) + v;
  for (int j = threadIdx.y; j < P; j += blockDim.y) {
    const Taps tx = taps(j, x1, crop_w, P, W);
    const int xa = tx.lo * nvec + v, xb = tx.hi * nvec + v;
    // Rows in order. A cell row needs the horizontal lerps of its two tap
    // rows (top and bot); where a tap row is one the row before used, its
    // lerps are kept from there: the same operations on the same values,
    // so the same bits. The branches follow the row taps, the same for the
    // whole warp. In bf16 the four taps are loaded whether or not their
    // lerps are kept, so that the unrolled rows' loads overlap (a kept tap
    // row's pixels are the row before's, in L1); in f32, whose output is
    // twice the bytes, only new tap rows are loaded, row by row.
    constexpr bool load_all = sizeof(T) == 2;
    constexpr int row_unroll = load_all && PT > 0 ? PT : 1;  // f32 runs slower unrolled
    float top[VN], bot[VN];
    int prev_lo = -1, prev_hi = -1;
#pragma unroll(row_unroll)
    for (int i = 0; i < P; ++i) {
      const int4 ty = rows[i];
      const bool top_new = ty.x != prev_lo && ty.x != prev_hi;
      const bool bot_new = ty.y != ty.x && ty.y != prev_hi;
      Vec16<T> a, c, d, e;
      if (load_all || top_new) {
        a.raw = fb[ty.x + xa];
        c.raw = fb[ty.x + xb];
      }
      if (load_all || bot_new) {
        d.raw = fb[ty.y + xa];
        e.raw = fb[ty.y + xb];
      }
      if (top_new) {
#pragma unroll
        for (int k = 0; k < VN; ++k)
          top[k] = lerp_rn(to_f32(a.v()[k]), to_f32(c.v()[k]), tx.frac);
      } else if (ty.x == prev_hi) {
#pragma unroll
        for (int k = 0; k < VN; ++k) top[k] = bot[k];
      }
      if (bot_new) {
#pragma unroll
        for (int k = 0; k < VN; ++k)
          bot[k] = lerp_rn(to_f32(d.v()[k]), to_f32(e.v()[k]), tx.frac);
      } else if (ty.y == ty.x) {
#pragma unroll
        for (int k = 0; k < VN; ++k) bot[k] = top[k];
      }
      prev_lo = ty.x, prev_hi = ty.y;
      const float fy = __int_as_float(ty.z);
      Vec16<T> res;
#pragma unroll
      for (int k = 0; k < VN; ++k) res.v()[k] = from_f32<T>(lerp_rn(top[k], bot[k], fy));
      uint4* o = ob + ((size_t)i * P + j) * nvec;
      __stcs(o, res.raw);
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rois, void* out, int B, int H, int W, int C, int R,
           int P, void* stream) {
  const int nvec = C / Vec16<T>::N, chunks = (nvec + K1_VECS - 1) / K1_VECS;
  if ((long long)H * W * nvec > INT_MAX) return (int)cudaErrorInvalidValue;  // int offsets
  const dim3 grid(R * chunks, B);
  const size_t smem = (size_t)P * sizeof(int4);
  if (P == 7) {
    roi_align_kernel<T, 7><<<grid, dim3(K1_VECS, 7), smem, (cudaStream_t)stream>>>(
        (const T*)feat, (const float*)rois, (T*)out, H, W, C, R, P);
  } else {
    roi_align_kernel<T, 0><<<grid, dim3(K1_VECS, std::min(P, K1_GENERIC_WARPS)), smem,
                             (cudaStream_t)stream>>>(
        (const T*)feat, (const float*)rois, (T*)out, H, W, C, R, P);
  }
  return (int)cudaGetLastError();
}

// Backward. What bounds it: at B=16, R=64 (the train step) it must read the
// 102.8 MB bf16 cotangent and write the 117.0 MB bf16 gradient of the map,
// 0.066 ms at 3.35 TB/s.
//
// Design: owner computes. One block takes one map row y of one image b for
// one chunk of 32 16-byte vectors of channels (256 bf16, 128 f32); a lane
// owns one vector of each column it sums, in f32 registers, and writes that
// pixel once, zeros included: no zeroed scratch, no atomics on the map, no
// rounding pass; the map is written exactly once, rounded once from f32.
// The block takes the image's ROIs in batches of RB (all of them at once
// where they fit: the train step's 64 do), in r order, and runs steps 1-3
// on each; a column's sum carries from batch to batch in shared memory.
//   1. Hits. Each thread takes ROIs (in order, blockDim at a time): the row
//      taps of cells 0 and P-1 bound those of all cells (both taps are
//      monotone in i), so most ROIs stop there; the others store their P
//      column taps (taps(), the forward's function) and find their cells i
//      with a tap on row y: the lo tap (weight 1 - frac), the hi tap
//      (weight frac, skipped at frac == 0), or both when lo == hi, one hit
//      of weight (1 - frac) + frac, as the reference's tap-weight matrix
//      sums them. A scan over the block writes the hits in (r, i) order.
//   2. Entries. Each hit gives, for j from 0 to P-1, an entry on its lo
//      column and one on its hi column (one entry of weight (1 - frac) +
//      frac when they coincide; none for a zero weight), each a cotangent
//      row (b, r, i, j) and the weight wy * wx (one f32 multiply). The
//      block writes them in (r, i, j, lo/hi) order, then one warp sorts
//      them stably by column (__match_any_sync, a cursor per column), so a
//      column's entries lie together in that order. Columns whose entries
//      do not fit the buffer at once go in later rounds (a round holds
//      whole columns; one column never exceeds the buffer).
//   3. Sums. Warps take columns (a counter in shared memory) and add their
//      entries in order to the column's carried sum (0 in the first
//      batch), BWD_INFLIGHT loads issued before the first add: acc += g *
//      w, one f32 multiply and one f32 add each (__fmul_rn / __fadd_rn: no
//      FMA, so the fixed order fixes every rounding and the result is the
//      same bits on every run). ROIs cluster around the ground truth, so
//      one column can hold a large share of a row's entries (458 of the
//      train step's first input); a column with more than BWD_HEAVY entries
//      in a batch and more than 1/BWD_WARPS of its row's in that batch is
//      split: warp w sums the w-th of BWD_WARPS equal runs of its entries,
//      the first run from the carried sum, and the runs' sums are added in
//      run order. The last batch stores the columns, the others carry them.
// A tap whose weight is zero (frac == 0: the hi tap; 1 - frac is never 0)
// is skipped. That changes no finite sum; an inf or NaN in the cotangent
// stays out of the zero-weight tap's pixel, where the plain version and the
// JAX VJP would put 0 * inf = NaN.
// Traffic: each cotangent row is read by the blocks of its two tap rows,
// and in each of them for its two tap columns where they differ; the
// blocks of one image run together (b is the slowest grid index), so the
// reads after the first tend to hit L2. Shared memory (bwd_plan): 52 KB at
// R = 64, P = 7, W = 94, four blocks an SM. Above BWD_ROI_BATCH ROIs (at P
// = 7) an image takes several batches, and the carried sums need 1 KB a
// column (bf16; 512 B in f32); where a row's do not fit beside the batch,
// the row's columns are cut into tiles of XT, a block each.
constexpr int BWD_WARPS = 8;           // warps of a block
constexpr int BWD_INFLIGHT = 4;        // loads a lane issues before it adds them
constexpr int BWD_HEAVY = 64;          // entries above which a column may be split
constexpr int BWD_ROI_BATCH = 128;     // most ROIs a batch takes
constexpr int BWD_BATCH_BYTES = 98304; // most shared memory a batch's ROIs take
constexpr int BWD_SMEM_LIMIT = 232448; // shared memory an H100 block may have

struct ColTap {  // 8 bytes: the shared-memory layout below counts on it
  short lo, hi;
  float frac;
};

struct Entry {  // a cotangent row (b, r, i, j) and its weight
  int row;
  float w;
};

struct BwdPlan {
  int rb, xt;   // ROIs a batch, columns a block
  size_t smem;  // bytes of dynamic shared memory; 0: the shapes do not fit
};

// Shared memory: a batch's column taps and hits (RB P each), its entries
// (at most RB P P: a row holds at most one hit per (r, i), and each j adds
// at most one entry to a column), the split columns' run sums, the carried
// sums of XT columns (with several batches), the per-column counts and
// cursors, the entries' columns and sorted order (2 bytes each), and a
// round's three lists of columns.
inline BwdPlan bwd_plan(int R, int P, int W, int VN) {
  const size_t per_roi = (size_t)P * 16 + (size_t)P * P * 12;
  BwdPlan plan;
  plan.rb = (int)std::min<size_t>(std::min(R, BWD_ROI_BATCH),
                                  std::max<size_t>(1, BWD_BATCH_BYTES / per_roi));
  plan.xt = W;
  plan.smem = plan.rb * per_roi + (size_t)BWD_WARPS * 32 * 8 * sizeof(float) + (size_t)W * 14;
  if (plan.rb < R) {
    const size_t per_col = (size_t)32 * VN * sizeof(float);
    const size_t limit = BWD_SMEM_LIMIT;
    const size_t room = plan.smem < limit ? (limit - plan.smem) / per_col : 0;
    plan.xt = (int)std::min<size_t>(W, room);
    plan.smem += plan.xt * per_col;
  }
  if (plan.smem > (size_t)BWD_SMEM_LIMIT || plan.xt < 1) plan.smem = 0;
  return plan;
}

// The entries a column tap gives: its lo column with weight (1 - frac), or
// (1 - frac) + frac when hi == lo; its hi column with weight frac.
__device__ __forceinline__ int col_entries(const ColTap& c, int* xs, float* wx) {
  const float w_lo = 1.f - c.frac;
  if (c.frac == 0.f) {
    xs[0] = c.lo, wx[0] = w_lo;
    return 1;
  }
  if (c.hi == c.lo) {
    xs[0] = c.lo, wx[0] = __fadd_rn(w_lo, c.frac);
    return 1;
  }
  xs[0] = c.lo, wx[0] = w_lo, xs[1] = c.hi, wx[1] = c.frac;
  return 2;
}

// Exclusive scan of v over the block, in thread order; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int off = incl - v, sum = 0;
  for (int w = 0; w < BWD_WARPS; ++w) {
    off += w < warp ? warp_sum[w] : 0;
    sum += warp_sum[w];
  }
  __syncthreads();  // warp_sum may be reused
  *total = sum;
  return off;
}

// acc += the entries order[a..b) in order; loads of BWD_INFLIGHT entries
// are issued before their adds.
template <typename T>
__device__ __forceinline__ void sum_entries(float (&acc)[Vec16<T>::N], const Entry* entries,
                                            const short* order, int a, int b, const uint4* gv,
                                            int nvec, int v) {
  const int lane = threadIdx.x & 31;
  for (int e0 = a; e0 < b; e0 += BWD_INFLIGHT) {
    Entry mine{0, 0.f};
    if (lane < BWD_INFLIGHT && e0 + lane < b) mine = entries[order[e0 + lane]];
    Vec16<T> in[BWD_INFLIGHT];
#pragma unroll
    for (int u = 0; u < BWD_INFLIGHT; ++u) {
      const int row = __shfl_sync(0xffffffffu, mine.row, u);
      if (e0 + u < b && v < nvec) in[u].raw = gv[(size_t)row * nvec + v];
    }
#pragma unroll
    for (int u = 0; u < BWD_INFLIGHT; ++u) {
      const float w = __shfl_sync(0xffffffffu, mine.w, u);
      if (e0 + u < b)
#pragma unroll
        for (int e = 0; e < Vec16<T>::N; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(to_f32(in[u].v()[e]), w));
    }
  }
}

// A column's sum so far for vector l of the chunk: 0 in the first batch,
// else what the batch before carried.
template <int VN>
__device__ __forceinline__ void carried(float (&acc)[VN], const float* carry, bool first, int xl,
                                        int l) {
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = first ? 0.f : carry[(xl * 32 + l) * VN + e];
}

// The last batch writes the pixel (x, vector v = v0 + l), the others carry it.
template <typename T>
__device__ __forceinline__ void finish(T* dfeat, float* carry, bool last,
                                       const float (&acc)[Vec16<T>::N], int b, int y, int x,
                                       int xl, int l, int H, int W, int C, int nvec, int v) {
  constexpr int VN = Vec16<T>::N;
  if (!last) {
#pragma unroll
    for (int e = 0; e < VN; ++e) carry[(xl * 32 + l) * VN + e] = acc[e];
    return;
  }
  if (v >= nvec) return;
  Vec16<T> out;
#pragma unroll
  for (int e = 0; e < VN; ++e) out.v()[e] = from_f32<T>(acc[e]);
  reinterpret_cast<uint4*>(dfeat + (((size_t)b * H + y) * W + x) * C)[v] = out.raw;
}

// BATCHED: the image's ROIs take more than one batch (RB < R), so column
// sums carry from batch to batch; without it that code compiles away.
template <typename T, bool BATCHED>
__global__ void __launch_bounds__(BWD_WARPS * 32, 4)
roi_align_bwd_kernel(const T* __restrict__ grad, const float* __restrict__ rois,
                     T* __restrict__ dfeat, int H, int W, int C, int R, int P, int RB, int XT) {
  constexpr int VN = Vec16<T>::N;
  const int rp = RB * P, cap = rp * P;
  extern __shared__ __align__(16) unsigned char smem[];
  ColTap* ct = reinterpret_cast<ColTap*>(smem);                 // [RB][P]
  int* code = reinterpret_cast<int*>(ct + rp);                  // [RB P] hits: (r - r0) << 16 | i
  float* wyv = reinterpret_cast<float*>(code + rp);             // [RB P] hits' row weights
  Entry* entries = reinterpret_cast<Entry*>(wyv + rp);          // [cap]
  float* runs = reinterpret_cast<float*>(entries + cap);        // [BWD_WARPS][32][8]
  float* carry = runs + BWD_WARPS * 32 * 8;                     // [XT][32][VN] if BATCHED
  int* count = reinterpret_cast<int*>(carry + (BATCHED ? XT * 32 * VN : 0));  // [W]
  int* cursor = count + W;                                      // [W]
  short* ex = reinterpret_cast<short*>(cursor + W);             // [cap] entries' columns
  short* order = ex + cap;                                      // [cap] entries by column
  short* zero_cols = order + cap;                               // [W] a round's columns:
  short* one_cols = zero_cols + W;                              // [W]   with no entry, summed
  short* split_cols = one_cols + W;                             // [W]   by one warp, split
  __shared__ int warp_sum[BWD_WARPS];
  __shared__ int next_col, round_end, row_entries, n_zero, n_one, n_split;

  const int y = blockIdx.x % H;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = C / VN, chunks = (nvec + 31) / 32;
  const int v0 = blockIdx.x / H % chunks * 32, v = v0 + lane;  // the chunk's vectors; this lane's
  const int xa = blockIdx.x / H / chunks * XT, xb = min(W, xa + XT);  // the block's columns
  const uint4* gv = reinterpret_cast<const uint4*>(grad);
  const unsigned full = 0xffffffffu;

  for (int r0 = 0; r0 < R; r0 += RB) {
    const int r1 = min(R, r0 + RB);
    const bool first = !BATCHED || r0 == 0, last = !BATCHED || r1 == R;
    __syncthreads();  // the batch before is done with shared memory
    // 1. the hits on row y, in (r, i) order
    for (int x = threadIdx.x; x < W; x += blockDim.x) count[x] = 0;
    int nh = 0;
    for (int rbase = r0; rbase < r1; rbase += blockDim.x) {
      const int t = rbase + threadIdx.x;
      int cnt = 0;
      float y1 = 0.f, crop_h = 0.f;
      if (t < r1) {
        const float* roi = rois + ((size_t)b * R + t) * 4;
        y1 = roi[1];
        crop_h = roi[3] - y1;
        const Taps first_i = taps(0, y1, crop_h, P, H), last_i = taps(P - 1, y1, crop_h, P, H);
        if (y >= min(min(first_i.lo, first_i.hi), min(last_i.lo, last_i.hi)) &&
            y <= max(max(first_i.lo, first_i.hi), max(last_i.lo, last_i.hi))) {
          const float x1 = roi[0], crop_w = roi[2] - x1;
          for (int j = 0; j < P; ++j) {
            const Taps tx = taps(j, x1, crop_w, P, W);
            ct[(t - r0) * P + j] = ColTap{(short)tx.lo, (short)tx.hi, tx.frac};
          }
          for (int i = 0; i < P; ++i) {
            const Taps ty = taps(i, y1, crop_h, P, H);
            cnt += ty.lo == y || (ty.hi == y && ty.frac != 0.f);
          }
        }
      }
      int total;
      int off = nh + block_scan(cnt, warp_sum, &total);
      nh += total;
      if (cnt > 0) {
        for (int i = 0; i < P; ++i) {
          const Taps ty = taps(i, y1, crop_h, P, H);
          const bool lo = ty.lo == y, hi = ty.hi == y && ty.frac != 0.f;
          if (!lo && !hi) continue;
          code[off] = ((t - r0) << 16) | i;
          wyv[off++] = lo && hi ? __fadd_rn(1.f - ty.frac, ty.frac) : lo ? 1.f - ty.frac : ty.frac;
        }
      }
    }
    __syncthreads();  // the hits and column taps are written

    // the entries of each column of the row
    for (int h = threadIdx.x; h < nh; h += blockDim.x) {
      const ColTap* c = ct + (code[h] >> 16) * P;
      for (int j = 0; j < P; ++j) {
        int xs[2];
        float wx[2];
        const int n = col_entries(c[j], xs, wx);
        for (int k = 0; k < n; ++k) atomicAdd(&count[xs[k]], 1);
      }
    }
    __syncthreads();
    if (warp == 0) {
      int n = 0;
      for (int x = lane; x < W; x += 32) n += count[x];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(full, n, o);
      if (lane == 0) row_entries = n;
    }

    // 2-3. rounds of whole columns of the block's whose entries fit the buffer
    for (int xs0 = xa; xs0 < xb;) {
      __syncthreads();
      if (warp == 0) {
        // the round's end, each column's start (cursor), and the lists of
        // its columns with no entry, summed by one warp, and split over the
        // warps
        const int total = row_entries;
        int base = 0, nz = 0, nl = 0, ns = 0, xe = xb;
        for (int x0 = xs0; x0 < xb; x0 += 32) {
          const int x = x0 + lane, n = x < xb ? count[x] : 0;
          int incl = n;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int m = __shfl_up_sync(full, incl, o);
            if (lane >= o) incl += m;
          }
          const unsigned over = __ballot_sync(full, x < xb && base + incl > cap);
          const int end = over ? __ffs(over) - 1 : 32;  // columns x0 .. x0 + end - 1 fit
          const bool in = x < xb && lane < end;
          if (in) cursor[x] = base + incl - n;
          const bool split = in && n > BWD_HEAVY && n * BWD_WARPS > total;
          const unsigned zero = __ballot_sync(full, in && n == 0);
          const unsigned one = __ballot_sync(full, in && n > 0 && !split);
          const unsigned many = __ballot_sync(full, split);
          const unsigned below = (1u << lane) - 1;
          if (in && n == 0) zero_cols[nz + __popc(zero & below)] = (short)x;
          if (in && n > 0 && !split) one_cols[nl + __popc(one & below)] = (short)x;
          if (split) split_cols[ns + __popc(many & below)] = (short)x;
          nz += __popc(zero), nl += __popc(one), ns += __popc(many);
          base += __shfl_sync(full, incl, 31);
          if (over) {
            xe = x0 + end;
            break;
          }
        }
        if (lane == 0) {
          round_end = xe, n_zero = nz, n_one = nl, n_split = ns, next_col = 0;
        }
      }
      __syncthreads();
      const int xe = round_end;
      // the round's entries in (r, i, j, lo/hi) order
      int ne = 0;
      for (int hbase = 0; hbase < nh; hbase += blockDim.x) {
        const int h = hbase + threadIdx.x;
        int cnt = 0;
        const ColTap* c = ct;
        if (h < nh) {
          c = ct + (code[h] >> 16) * P;
          for (int j = 0; j < P; ++j) {
            int xs[2];
            float wx[2];
            const int n = col_entries(c[j], xs, wx);
            for (int k = 0; k < n; ++k) cnt += xs[k] >= xs0 && xs[k] < xe;
          }
        }
        int total;
        int off = ne + block_scan(cnt, warp_sum, &total);
        ne += total;
        if (cnt > 0) {
          const int row0 = ((b * R + r0 + (code[h] >> 16)) * P + (code[h] & 0xffff)) * P;
          const float wy = wyv[h];
          for (int j = 0; j < P; ++j) {
            int xs[2];
            float wx[2];
            const int n = col_entries(c[j], xs, wx);
            for (int k = 0; k < n; ++k) {
              if (xs[k] < xs0 || xs[k] >= xe) continue;
              entries[off] = Entry{row0 + j, __fmul_rn(wy, wx[k])};
              ex[off++] = (short)xs[k];
            }
          }
        }
      }
      __syncthreads();  // the round's entries are written
      // sort them stably by column: one warp, 32 entries at a time
      if (warp == 0) {
        for (int e0 = 0; e0 < ne; e0 += 32) {
          const int e = e0 + lane;
          const int x = e < ne ? ex[e] : -1;
          const unsigned same = __match_any_sync(full, x);
          const int leader = __ffs(same) - 1;
          int pos = 0;
          if (lane == leader && x >= 0) {
            pos = cursor[x];
            cursor[x] = pos + __popc(same);
          }
          pos = __shfl_sync(full, pos, leader) + __popc(same & ((1u << lane) - 1));
          if (x >= 0) order[pos] = (short)e;
        }
      } else {
        // the columns with no entry in this batch: their sums so far
        for (int k = threadIdx.x - 32; k < n_zero * 32; k += blockDim.x - 32) {
          const int x = zero_cols[k >> 5], l = k & 31;
          float acc[VN];
          carried<VN>(acc, carry, first, x - xa, l);
          finish<T>(dfeat, carry, last, acc, b, y, x, x - xa, l, H, W, C, nvec, v0 + l);
        }
      }
      __syncthreads();  // cursor[x] is now the end of column x's entries

      // columns that one warp sums
      for (;;) {
        int k = 0;
        if (lane == 0) k = atomicAdd(&next_col, 1);
        k = __shfl_sync(full, k, 0);
        if (k >= n_one) break;
        const int x = one_cols[k], n = count[x];
        float acc[VN];
        carried<VN>(acc, carry, first, x - xa, lane);
        sum_entries<T>(acc, entries, order, cursor[x] - n, cursor[x], gv, nvec, v);
        finish<T>(dfeat, carry, last, acc, b, y, x, x - xa, lane, H, W, C, nvec, v);
      }
      // split columns: warp w sums the w-th run (warp 0 from the carried
      // sum), then the runs are added in order
      for (int k = 0; k < n_split; ++k) {
        const int x = split_cols[k], n = count[x], a = cursor[x] - n;
        float acc[VN];
        carried<VN>(acc, carry, first || warp > 0, x - xa, lane);
        sum_entries<T>(acc, entries, order, a + n * warp / BWD_WARPS,
                       a + n * (warp + 1) / BWD_WARPS, gv, nvec, v);
#pragma unroll
        for (int e = 0; e < VN; ++e) runs[(warp * 32 + lane) * VN + e] = acc[e];
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[e] = runs[lane * VN + e];
          for (int w = 1; w < BWD_WARPS; ++w)
#pragma unroll
            for (int e = 0; e < VN; ++e)
              acc[e] = __fadd_rn(acc[e], runs[(w * 32 + lane) * VN + e]);
          finish<T>(dfeat, carry, last, acc, b, y, x, x - xa, lane, H, W, C, nvec, v);
        }
        __syncthreads();  // the runs are read
      }
      xs0 = xe;
    }
  }
}

template <typename T>
int launch_bwd(const void* grad, const void* rois, void* dfeat, int B, int H, int W, int C, int R,
               int P, void* stream) {
  const BwdPlan plan = bwd_plan(R, P, W, Vec16<T>::N);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;  // P, W too large for a block
  auto kernel = plan.rb < R ? roi_align_bwd_kernel<T, true> : roi_align_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (C / Vec16<T>::N + 31) / 32, tiles = (W + plan.xt - 1) / plan.xt;
  dim3 grid(tiles * chunks * H, B);
  kernel<<<grid, BWD_WARPS * 32, plan.smem, (cudaStream_t)stream>>>(
      (const T*)grad, (const float*)rois, (T*)dfeat, H, W, C, R, P, plan.rb, plan.xt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_roi_align_bf16(const void* feat, const void* rois, void* out, int B, int H,
                                    int W, int C, int R, int P, void* stream) {
  return launch<__nv_bfloat16>(feat, rois, out, B, H, W, C, R, P, stream);
}

extern "C" int frcnn_roi_align_f32(const void* feat, const void* rois, void* out, int B, int H,
                                   int W, int C, int R, int P, void* stream) {
  return launch<float>(feat, rois, out, B, H, W, C, R, P, stream);
}

extern "C" int frcnn_roi_align_bwd_bf16(const void* grad, const void* rois, void* dfeat, int B,
                                        int H, int W, int C, int R, int P, void* stream) {
  return launch_bwd<__nv_bfloat16>(grad, rois, dfeat, B, H, W, C, R, P, stream);
}

extern "C" int frcnn_roi_align_bwd_f32(const void* grad, const void* rois, void* dfeat, int B,
                                       int H, int W, int C, int R, int P, void* stream) {
  return launch_bwd<float>(grad, rois, dfeat, B, H, W, C, R, P, stream);
}

extern "C" const char* frcnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
