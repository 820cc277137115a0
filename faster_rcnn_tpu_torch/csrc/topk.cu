// Top-k of each row of an f32 score matrix, descending by value, ties by
// ascending index: exactly jax.lax.top_k, whose order is the IEEE total order
// (+NaN first, +0.0 above -0.0, -NaN last), and ops/sort.py's plain version.
//
// Replaces: faster_rcnn_tpu/ops/sort_pallas.py _kernel (pallas_call at :115,
// entries sort_descending_pallas :100 and topk_sorted_pallas :134), a VPU
// bitonic sort of the whole padded row.
//
// What bounds it on the H100: at the train step's shapes (16 rows of 64,296
// scores, k = 6000, 128 or 256) it must read 4.1 MB and write at most
// 1.15 MB, about 1.6 us at 3.35 TB/s; the comparisons are negligible. It is
// bound by latency: a chain of dependent passes over the rows.
//
// Design: each row is cut into S slices, and every pass runs one block per
// (slice, row), so that B * S blocks (twice the SM count, from the wrapper)
// share the work; the 4 MB of scores stay in L2 between the launches.
//   1. topk_select, three launches: a radix select of the k-th key over the
//      order-preserving uint32 form of the scores (smaller key = earlier in
//      the output), 11, 11 and 10 bits a pass from the top. Each block
//      histograms the keys of its slice that match the row's prefix so far
//      in shared memory and adds its non-zero bins into the row's histogram
//      in global memory; the row's last block (an atomic ticket after a
//      fence) finds the bin of the krem-th key, writes the row's prefix and
//      remaining count, and clears the histogram for the next pass.
//   2. topk_count, then topk_scatter: each slice counts its keys below the
//      k-th key and its ties; each block sums the counts of the slices
//      before its own, then keeps its keys below the k-th key and the ties
//      whose rank in index order is below krem, ranked by ballots with one
//      barrier per tile, as (key << 32 | index) pairs.
//   3. topk_sort_chunks sorts each 1024 pairs of a row in a block (bitonic:
//      warp shuffles for strides below 32, shared memory above); when k is
//      over 1024, topk_merge places every pair at its rank: its place in its
//      own chunk plus, for each other chunk, the number of smaller pairs (a
//      binary search in shared memory). The pairs are unique, so the ranks
//      are a permutation: no atomics, and the result does not depend on the
//      order in which blocks run.
//   4. Indices are written as int64 and the values read back from the input
//      by index, so the output holds the input's bits (a -0.0 stays -0.0).
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;  // blocks of the select, count and scatter passes
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 2048;    // 11-bit digits
constexpr int CHUNK = 1024;   // pairs one block sorts
constexpr int MAX_K = 16384;  // the row's pairs the merge holds in shared memory
constexpr unsigned FULL = 0xffffffffu;

struct RowState {
  uint32_t prefix;  // the k-th key's bits found so far
  int krem;         // how many keys of the top k match the prefix
  int ticket;       // blocks of the row that finished the current pass
  int pad;
};

// Scratch, carved from one buffer the wrapper allocates: per row a histogram
// and a state (zeroed by each call), per slice its two counts, per row the k
// kept pairs.
struct Work {
  int* hist;         // B x BINS
  RowState* state;   // B
  int2* counts;      // B x S: keys below the k-th key, ties of it
  u64* pairs;        // B x K
};

size_t zeroed_bytes(int B) { return (size_t)B * (BINS * sizeof(int) + sizeof(RowState)); }

size_t pairs_offset(int B, int S) {
  const size_t end = zeroed_bytes(B) + (size_t)B * S * sizeof(int2);
  return (end + 255) / 256 * 256;
}

Work carve(void* base, int B, int S) {
  char* p = (char*)base;
  Work w;
  w.hist = (int*)p;
  w.state = (RowState*)(p + (size_t)B * BINS * sizeof(int));
  w.counts = (int2*)(p + zeroed_bytes(B));
  w.pairs = (u64*)(p + pairs_offset(B, S));
  return w;
}

// Smaller key <=> earlier in the output: descending in the IEEE total order,
// as lax.top_k orders (+NaN first, +0.0 above -0.0, -NaN last).
__device__ __forceinline__ uint32_t desc_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? u : (~u & 0x7fffffffu);
}

__device__ __forceinline__ int slice_end(int N, int W, int s) {
  return (int)min((long long)N, (long long)(s + 1) * W);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Pass 0 takes bits 31..21 of the key, pass 1 bits 20..10, pass 2 bits 9..0.
__global__ void __launch_bounds__(THREADS)
topk_select(const float* __restrict__ scores, int* __restrict__ hist,
            RowState* __restrict__ state, int N, int K, int S, int W, int pass) {
  __shared__ int h[BINS];
  __shared__ int warp_total[WARPS];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, b = blockIdx.y;
  const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
  const uint32_t digit_mask = pass == 2 ? 0x3ffu : 0x7ffu;
  const uint32_t match = pass == 0 ? 0u : (~0u << (shift + (pass == 2 ? 10 : 11)));
  uint32_t prefix = 0;
  int krem = K;
  if (pass > 0) {
    prefix = __ldcg(&state[b].prefix);
    krem = __ldcg(&state[b].krem);
  }
  for (int i = tid; i < BINS; i += THREADS) h[i] = 0;
  __syncthreads();

  const float* x = scores + (size_t)b * N;
  const int end = slice_end(N, W, s);
#pragma unroll 4
  for (int i = s * W + tid; i < end; i += THREADS) {
    const uint32_t key = desc_key(x[i]);
    if ((key & match) == prefix) atomicAdd(&h[(key >> shift) & digit_mask], 1);
  }
  __syncthreads();
  int* rh = hist + (size_t)b * BINS;
  for (int i = tid; i < BINS; i += THREADS) {
    const int c = h[i];
    if (c) atomicAdd(&rh[i], c);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&state[b].ticket, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;

  // the row's last block: the bin of the krem-th smallest matching key.
  // Thread t holds bins 8t .. 8t+7; a block-wide scan of their sums.
  __threadfence();
  constexpr int PER = BINS / THREADS;
  int local[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    local[j] = __ldcg(&rh[tid * PER + j]);
    sum += local[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int cum = incl - sum;
  for (int w = 0; w < warp; ++w) cum += warp_total[w];
  if (cum < krem && krem <= cum + sum) {  // exactly one thread holds the k-th key
    int d = 0;
    while (cum + local[d] < krem) cum += local[d++];
    state[b].prefix = prefix | ((uint32_t)(tid * PER + d) << shift);
    state[b].krem = krem - cum;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) rh[tid * PER + j] = 0;  // clean for the next pass
  if (tid == 0) state[b].ticket = 0;
}

// Per slice: keys below the k-th key, and its ties.
__global__ void __launch_bounds__(THREADS)
topk_count(const float* __restrict__ scores, const RowState* __restrict__ state,
           int2* __restrict__ counts, int N, int S, int W) {
  __shared__ int part[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, b = blockIdx.y;
  const uint32_t kth = __ldcg(&state[b].prefix);
  const float* x = scores + (size_t)b * N;
  const int end = slice_end(N, W, s);
  int lt = 0, eq = 0;
#pragma unroll 4
  for (int i = s * W + tid; i < end; i += THREADS) {
    const uint32_t key = desc_key(x[i]);
    lt += key < kth;
    eq += key == kth;
  }
  lt = warp_sum(lt);
  eq = warp_sum(eq);
  if (lane == 0) {
    part[0][warp] = lt;
    part[1][warp] = eq;
  }
  __syncthreads();
  if (tid == 0) {
    int2 c = make_int2(0, 0);
    for (int w = 0; w < WARPS; ++w) {
      c.x += part[0][w];
      c.y += part[1][w];
    }
    counts[(size_t)b * S + s] = c;
  }
}

// Keep the slice's keys below the k-th key at [lt offset, ...) and its ties
// of rank below krem (in index order, over the whole row) at K - krem + rank.
__global__ void __launch_bounds__(THREADS)
topk_scatter(const float* __restrict__ scores, const RowState* __restrict__ state,
             const int2* __restrict__ counts, u64* __restrict__ pairs, int N, int K, int S,
             int W) {
  __shared__ int s_base[2];
  __shared__ int tile_count[2][WARPS];  // per warp: ties << 16 | keys below; two tiles in turn
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, b = blockIdx.y;
  const uint32_t kth = __ldcg(&state[b].prefix);
  const int krem = __ldcg(&state[b].krem);
  const int2* rc = counts + (size_t)b * S;
  if (warp == 0) {  // the counts of the slices before this one
    int lt = 0, eq = 0;
    for (int j = lane; j < s; j += 32) {
      const int2 c = __ldcg(&rc[j]);
      lt += c.x;
      eq += c.y;
    }
    lt = warp_sum(lt);
    eq = warp_sum(eq);
    if (lane == 0) {
      s_base[0] = lt;
      s_base[1] = eq;
    }
  }
  __syncthreads();
  int lt_base = s_base[0], eq_base = s_base[1];
  const int2 mine = __ldcg(&rc[s]);
  if (mine.x == 0 && (mine.y == 0 || eq_base >= krem)) return;  // nothing to keep here

  const float* x = scores + (size_t)b * N;
  u64* out = pairs + (size_t)b * K;
  const int n_lt = K - krem;
  const int lo = s * W, end = slice_end(N, W, s);
  const unsigned below = (1u << lane) - 1u;
  int parity = 0;
  for (int base = lo; base < end; base += THREADS, parity ^= 1) {  // uniform trip count
    const int i = base + tid;
    const uint32_t key = i < end ? desc_key(x[i]) : 0xffffffffu;
    const bool lt = i < end && key < kth;
    const bool eq = i < end && key == kth;
    const unsigned blt = __ballot_sync(FULL, lt), beq = __ballot_sync(FULL, eq);
    if (lane == 0) tile_count[parity][warp] = (__popc(beq) << 16) | __popc(blt);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = tile_count[parity][w];
      total += c;
      if (w < warp) before += c;
    }
    const u64 pair = ((u64)key << 32) | (uint32_t)i;
    if (lt) out[lt_base + (before & 0xffff) + __popc(blt & below)] = pair;
    if (eq) {
      const int rank = eq_base + (before >> 16) + __popc(beq & below);
      if (rank < krem) out[n_lt + rank] = pair;
    }
    lt_base += total & 0xffff;
    eq_base += total >> 16;
  }
}

// Sort each CHUNK pairs of a row ascending; blockDim.x is the power of two
// the chunk is padded to. With one chunk per row the result is the output.
__global__ void __launch_bounds__(CHUNK)
topk_sort_chunks(const float* __restrict__ scores, u64* __restrict__ pairs,
                 float* __restrict__ out_vals, int64_t* __restrict__ out_idx, int N, int K,
                 int direct) {
  __shared__ u64 buf[2][CHUNK];
  const int tid = threadIdx.x, P = blockDim.x;
  const int c = blockIdx.x, b = blockIdx.y;
  const int start = c * CHUNK, len = min(CHUNK, K - start);
  u64* row = pairs + (size_t)b * K;
  u64 v = tid < len ? __ldcg(&row[start + tid]) : ~0ull;
  int turn = 0;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      u64 other;
      if (stride >= 32) {
        buf[turn][tid] = v;
        __syncthreads();
        other = buf[turn][tid ^ stride];
        turn ^= 1;
      } else {
        other = __shfl_xor_sync(FULL, v, stride);
      }
      const bool lower = (tid & stride) == 0, ascending = (tid & size) == 0;
      v = (lower == ascending) ? min(v, other) : max(v, other);
    }
  }
  if (tid >= len) return;
  if (direct) {
    const uint32_t idx = (uint32_t)v;
    out_idx[(size_t)b * K + tid] = (int64_t)idx;
    out_vals[(size_t)b * K + tid] = scores[(size_t)b * N + idx];
  } else {
    row[start + tid] = v;
  }
}

// Each pair of chunk c goes to its rank in the row: its place in chunk c plus
// the number of smaller pairs in every other chunk.
__global__ void __launch_bounds__(CHUNK)
topk_merge(const float* __restrict__ scores, const u64* __restrict__ pairs,
           float* __restrict__ out_vals, int64_t* __restrict__ out_idx, int N, int K) {
  extern __shared__ u64 rowp[];  // the row's K pairs, sorted within each chunk
  const int tid = threadIdx.x, c = blockIdx.x, b = blockIdx.y;
  const u64* row = pairs + (size_t)b * K;
  for (int i = tid; i < K; i += CHUNK) rowp[i] = __ldcg(&row[i]);
  __syncthreads();
  const int start = c * CHUNK, len = min(CHUNK, K - start);
  if (tid >= len) return;
  const u64 v = rowp[start + tid];
  int slot = tid;
  for (int o = 0; o * CHUNK < K; ++o) {
    if (o == c) continue;
    const u64* a = rowp + o * CHUNK;
    int lo = 0, hi = min(CHUNK, K - o * CHUNK);
    while (lo < hi) {  // the number of pairs below v
      const int mid = (lo + hi) >> 1;
      if (a[mid] < v) lo = mid + 1;
      else hi = mid;
    }
    slot += lo;
  }
  const uint32_t idx = (uint32_t)v;
  out_idx[(size_t)b * K + slot] = (int64_t)idx;
  out_vals[(size_t)b * K + slot] = scores[(size_t)b * N + idx];
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// Bytes of the scratch buffer frcnn_topk_f32 takes for B rows of S slices.
extern "C" size_t frcnn_topk_work_bytes(int B, int S, int K) {
  return pairs_offset(B, S) + (size_t)B * K * sizeof(u64);
}

// scores (B, N) f32 -> vals (B, K) f32, idx (B, K) int64; `work` holds
// frcnn_topk_work_bytes(B, S, K) bytes. K <= MAX_K. All launches go to
// `stream`; nothing is synchronised.
extern "C" int frcnn_topk_f32(const void* scores, void* vals, void* idx, void* work, int B,
                              int N, int K, int S, void* stream) {
  if (K < 1 || K > MAX_K || K > N || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)scores;
  const Work w = carve(work, B, S);
  const int W = (N + S - 1) / S;
  cudaError_t err = cudaMemsetAsync(work, 0, zeroed_bytes(B), st);
  if (err != cudaSuccess) return (int)err;
#define TOPK_CHECK()                            \
  do {                                          \
    err = cudaGetLastError();                   \
    if (err != cudaSuccess) return (int)err;    \
  } while (0)
  const dim3 grid(S, B);
  for (int pass = 0; pass < 3; ++pass) {
    topk_select<<<grid, THREADS, 0, st>>>(x, w.hist, w.state, N, K, S, W, pass);
    TOPK_CHECK();
  }
  topk_count<<<grid, THREADS, 0, st>>>(x, w.state, w.counts, N, S, W);
  TOPK_CHECK();
  topk_scatter<<<grid, THREADS, 0, st>>>(x, w.state, w.counts, w.pairs, N, K, S, W);
  TOPK_CHECK();
  const int chunks = (K + CHUNK - 1) / CHUNK;
  const dim3 cgrid(chunks, B);
  const int width = chunks == 1 ? (next_pow2(K) < 32 ? 32 : next_pow2(K)) : CHUNK;
  topk_sort_chunks<<<cgrid, width, 0, st>>>(x, w.pairs, (float*)vals, (int64_t*)idx, N, K,
                                            chunks == 1);
  TOPK_CHECK();
  if (chunks > 1) {
    // the merge's shared memory, up to 128 KB; an attribute of the current device
    err = cudaFuncSetAttribute(topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_K * (int)sizeof(u64));
    if (err != cudaSuccess) return (int)err;
    topk_merge<<<cgrid, CHUNK, (size_t)K * sizeof(u64), st>>>(x, w.pairs, (float*)vals,
                                                               (int64_t*)idx, N, K);
    TOPK_CHECK();
  }
#undef TOPK_CHECK
  return (int)cudaSuccess;
}
