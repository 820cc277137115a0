// Top-k of each row of an f32 score matrix, descending by value, ties by
// ascending index: exactly torch.sort(descending=True, stable=True)[:, :k]
// and jax.lax.top_k, with -0.0 and +0.0 tied as equal values.
//
// Replaces: faster_rcnn_tpu/ops/sort_pallas.py _kernel (pallas_call at :115,
// entries sort_descending_pallas :100 and topk_sorted_pallas :134), a VPU
// bitonic sort of the whole padded row.
//
// What bounds it on the H100: at the train step's shapes (16 rows of 64,296
// scores, k = 6000, 128 or 256) it must read 4.1 MB and write at most
// 1.15 MB, about 1.6 us at 3.35 TB/s; the comparisons are negligible. It is
// bound by latency: each row is a chain of dependent block-wide passes.
//
// Design: 65,536 keys with their indices are 512 KB, more than a block's
// shared memory, so the row is not sorted whole. One block per row:
//   1. a radix select of the k-th key, 8 bits a pass from the top, over the
//      order-preserving uint32 form of the scores (smaller key = larger
//      score); each pass histograms the keys that match the prefix so far,
//      with warp-aggregated shared-memory atomics;
//   2. one sweep in index order keeps every key below the k-th key and the
//      first ties of it (a block-wide ballot scan ranks the ties);
//   3. a bitonic sort in shared memory of the k kept (key << 32 | index)
//      pairs, padded to a power of two (8192 pairs, 64 KB, at k = 6000);
//   4. the values are read back from the input by index, so the output
//      holds the input's bits (a -0.0 stays -0.0).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Smaller key <=> larger score. -0.0 joins +0.0 and every NaN one NaN,
// which sorts first, as torch.sort(descending=True) puts NaN first.
__device__ __forceinline__ uint32_t desc_key(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) == 0) u = 0;
  if (f != f) u = 0x7fc00000u;
  const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~asc;
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ scores, float* __restrict__ out_vals,
            int64_t* __restrict__ out_idx, int N, int K, int P) {
  extern __shared__ unsigned long long slots[];  // P pairs (key << 32 | index)
  __shared__ int hist[256];
  __shared__ int warp_count[WARPS];
  __shared__ uint32_t s_prefix;
  __shared__ int s_krem, s_nlt, s_eq_base;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x = scores + (size_t)blockIdx.x * N;

  // 1. radix select: after the four passes `prefix` is the k-th smallest
  //    key and `krem` the number of its ties that belong to the top k
  uint32_t prefix = 0, mask = 0;
  int krem = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += THREADS) {  // uniform trip count per warp
      const int i = base + tid;
      uint32_t digit = 0x100u;  // no bin
      if (i < N) {
        const uint32_t key = desc_key(x[i]);
        if ((key & mask) == prefix) digit = (key >> shift) & 0xffu;
      }
      const unsigned peers = __match_any_sync(FULL, digit);
      if (digit != 0x100u && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // lane l scans bins 8l .. 8l+7
      int local[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        local[j] = hist[lane * 8 + j];
        sum += local[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      int cum = incl - sum;
      if (cum < krem && krem <= incl) {  // exactly one lane holds the k-th key
        int d = 0;
        while (cum + local[d] < krem) cum += local[d++];
        s_prefix = prefix | ((uint32_t)(lane * 8 + d) << shift);
        s_krem = krem - cum;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    krem = s_krem;
    mask |= 0xffu << shift;
  }

  // 2. keep every key below the k-th and its first `krem` ties in index order
  const int n_lt = K - krem;
  if (tid == 0) {
    s_nlt = 0;
    s_eq_base = 0;
  }
  __syncthreads();
  for (int base = 0; base < N; base += THREADS) {
    const int i = base + tid;
    const uint32_t key = i < N ? desc_key(x[i]) : 0xffffffffu;
    const bool eq = i < N && key == prefix;
    if (i < N && key < prefix) {
      slots[atomicAdd(&s_nlt, 1)] = ((unsigned long long)key << 32) | (uint32_t)i;
    }
    const unsigned ballot = __ballot_sync(FULL, eq);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    if (__syncthreads_or(eq)) {
      int rank = s_eq_base + __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_count[w];
      if (eq && rank < krem) {
        slots[n_lt + rank] = ((unsigned long long)key << 32) | (uint32_t)i;
      }
      __syncthreads();
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < WARPS; ++w) total += warp_count[w];
        s_eq_base += total;
      }
    }
    __syncthreads();
  }

  // 3. bitonic sort of the kept pairs, ascending (key, then index)
  for (int i = K + tid; i < P; i += THREADS) slots[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = slots[lo], b = slots[hi];
        if ((a > b) == up) {
          slots[lo] = b;
          slots[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // 4. indices, and the values read back from the input
  float* ov = out_vals + (size_t)blockIdx.x * K;
  int64_t* oi = out_idx + (size_t)blockIdx.x * K;
  for (int i = tid; i < K; i += THREADS) {
    const uint32_t idx = (uint32_t)(slots[i] & 0xffffffffull);
    oi[i] = (int64_t)idx;
    ov[i] = x[idx];
  }
}

}  // namespace

extern "C" int frcnn_topk_f32(const void* scores, void* vals, void* idx, int B, int N, int K,
                              int P, void* stream) {
  const size_t smem = (size_t)P * sizeof(unsigned long long);  // the pairs to sort
  cudaError_t err = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (float*)vals, (int64_t*)idx, N, K, P);
  return (int)cudaGetLastError();
}
