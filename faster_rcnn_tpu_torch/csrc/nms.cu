// Keep mask of exact greedy NMS over score-sorted boxes, blocked by tiles,
// one block per image.
//
// Replaces: faster_rcnn_tpu/ops/nms_pallas.py _kernel (pallas_call at :153,
// entry nms_keep_mask_pallas :129), which equals faster_rcnn_tpu/ops/nms.py
// _blocked_keep_mask (:137). The port runs both NMS calls of the detection
// path through it: proposals (B, 8192) at IoU 0.7 and the final class-offset
// NMS (B, 384) at IoU 0.5, each with an `enough` budget of 300.
//
// What bounds it on the H100: it moves only about 2.4 MB at the proposal
// shape and its IoU arithmetic is small, so neither memory nor the ALUs bound
// it; its length is the chain of dependent tile phases (one per tile until
// `enough` survivors exist) and the serial greedy walk inside each tile.
//
// Design: the image's boxes live in shared memory (N x 16 B: 128 KB at
// N=8192), with invalid rows parked at (-1e8, -1e8, -1e8, -1e8) as the plain
// version does. Tiles run in order. Each phase
//   1. sweeps the tile against the compact list of survivors so far (never
//      more than `enough` + one tile when a budget is set), all threads in
//      parallel, several threads per box;
//   2. builds the tile's IoU > thresh bit matrix (row j: later boxes k that j
//      suppresses), skipping rows and columns already suppressed;
//   3. resolves the tile with one warp walking it in order: a bit set per
//      removed box, one shuffle per box, OR in the row of each survivor.
// Step 3 is the unique greedy solution, the same keep mask the plain
// fixpoint reaches. The phase loop stops at tile granularity once `enough`
// boxes survive; later tiles keep their `valid` value, as in the plain
// version. The IoU is computed in the plain version's order and this file is
// built with --fmad=false, so no multiply-add is contracted and every
// comparison iou > thresh matches the plain version bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr float FAR = -1e8f;

__device__ __forceinline__ float iou_p1(float4 a, float4 b) {
  const float x1 = fmaxf(a.x, b.x);
  const float y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z);
  const float y2 = fminf(a.w, b.w);
  const float iw = fmaxf(0.f, x2 - x1 + 1.f);
  const float ih = fmaxf(0.f, y2 - y1 + 1.f);
  const float inter = iw * ih;
  const float area_a = (a.z - a.x + 1.f) * (a.w - a.y + 1.f);
  const float area_b = (b.z - b.x + 1.f) * (b.w - b.y + 1.f);
  return inter / (area_a + area_b - inter);
}

// Shared memory: boxes[N] float4 | mask[T*T/32] u32 | kept[N] u16 |
// keep[N] u8 | cand[T] u8
size_t smem_bytes(int N, int T) {
  return (size_t)N * 16 + (size_t)T * (T / 32) * 4 + (size_t)N * 2 + (size_t)N + T;
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, const bool* __restrict__ valid,
           bool* __restrict__ keep_out, int N, int T, float thresh, int enough) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box_s = reinterpret_cast<float4*>(smem);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(box_s + N);
  const int words = T / 32;
  uint16_t* kept_s = reinterpret_cast<uint16_t*>(mask_s + T * words);
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(kept_s + N);
  uint8_t* cand_s = keep_s + N;
  __shared__ int nkept;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float4* bb = boxes + (size_t)b * N;
  const bool* vb = valid + (size_t)b * N;

  for (int k = tid; k < N; k += THREADS) {
    const bool v = vb[k];
    box_s[k] = v ? bb[k] : make_float4(FAR, FAR, FAR, FAR);
    keep_s[k] = v;
  }
  if (tid == 0) nkept = 0;
  __syncthreads();

  const int per_box = THREADS >= T ? THREADS / T : 1;
  for (int off = 0; off < N; off += T) {
    const int done = nkept;
    if (enough > 0 && done >= enough) break;  // uniform: read after a barrier

    // 1. candidates of this tile: valid and not suppressed by a survivor.
    for (int k = tid; k < T; k += THREADS) cand_s[k] = keep_s[off + k];
    __syncthreads();
    for (int e = tid; e < T * per_box; e += THREADS) {
      const int k = e % T, part = e / T;
      if (!cand_s[k]) continue;
      const float4 bk = box_s[off + k];
      for (int q = part; q < done; q += per_box) {
        if (iou_p1(box_s[kept_s[q]], bk) > thresh) {
          cand_s[k] = 0;  // benign race: every writer stores 0
          break;
        }
      }
    }
    __syncthreads();

    // 2. bit matrix: bit k of row j set when j < k, both candidates, and
    //    iou(j, k) > thresh.
    for (int e = tid; e < T * words; e += THREADS) {
      const int j = e / words, w = e % words;
      uint32_t bits = 0;
      if (cand_s[j]) {
        const float4 bj = box_s[off + j];
        for (int t = 0; t < 32; ++t) {
          const int k = w * 32 + t;
          if (k > j && cand_s[k] && iou_p1(bj, box_s[off + k]) > thresh) bits |= 1u << t;
        }
      }
      mask_s[e] = bits;
    }
    __syncthreads();

    // 3. greedy walk of the tile by warp 0; lane w holds removed-word w.
    if (tid < 32) {
      uint32_t removed = 0;
      int n = done;
      for (int j = 0; j < T; ++j) {
        bool alive = false;
        if (cand_s[j]) {
          const uint32_t word = __shfl_sync(0xffffffffu, removed, j >> 5);
          alive = !((word >> (j & 31)) & 1u);
          if (alive && lane < words) removed |= mask_s[j * words + lane];
        }
        if (lane == 0) {
          keep_s[off + j] = alive;
          if (alive) kept_s[n] = (uint16_t)(off + j);
        }
        n += alive;
      }
      if (lane == 0) nkept = n;
    }
    __syncthreads();
  }

  for (int k = tid; k < N; k += THREADS) keep_out[(size_t)b * N + k] = keep_s[k];
}

}  // namespace

extern "C" size_t frcnn_nms_smem_bytes(int N, int T) { return smem_bytes(N, T); }

extern "C" int frcnn_nms_keep_mask(const void* boxes, const void* valid, void* keep, int B, int N,
                                   int T, float thresh, int enough, void* stream) {
  const size_t smem = smem_bytes(N, T);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const bool*)valid, (bool*)keep, N, T, thresh, enough);
  return (int)cudaGetLastError();
}
