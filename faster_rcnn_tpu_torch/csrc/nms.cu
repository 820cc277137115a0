// Keep mask of exact greedy NMS over score-sorted boxes, blocked by tiles,
// one thread-block cluster per image.
//
// Replaces: faster_rcnn_tpu/ops/nms_pallas.py _kernel (pallas_call at :153,
// entry nms_keep_mask_pallas :129), which equals faster_rcnn_tpu/ops/nms.py
// _blocked_keep_mask (:137). The port runs every NMS of its paths through
// it: the train step's proposals (B, 6144) at IoU 0.7 with an `enough`
// budget of 2000, the detect call's proposals (B, 8192) at IoU 0.7 and its
// final class-offset NMS (B, 384) at IoU 0.5, both with a budget of 300.
//
// What bounds it on the H100: it moves only a few MB and its IoU arithmetic
// is small (tens of millions of pairs), so neither memory nor the ALUs bound
// it; its length is the chain of dependent tile phases (one per tile until
// `enough` survivors exist), each a sweep, a bit matrix and a serial walk.
// At the train step's shape (16 x 6144, tile 512, clusters of 6) a phase
// takes about 48 K cycles: the sweep and the bit matrix (the slowest
// block's) about 33 K, the walk about 12 K, loads, copies and barriers the
// rest (clock64 stamps in a copy of this kernel, NVIDIA H100 80GB HBM3).
//
// Design. Image b runs on a cluster of C blocks (C <= 8, chosen by the
// wrapper so that the B clusters run in one wave where the card can hold
// them). The survivors so far are a list of boxes (not indices) spread
// round-robin: block r holds survivors q = r, r + C, ... in its own shared
// memory, so no block stages all N boxes. Invalid rows are parked at
// (-1e8, -1e8, -1e8, -1e8) as in the plain version. Each phase, every block
// loads the tile's T boxes from global memory and
//   1. sweeps the tile's valid candidates against its share of the
//      survivors and ORs the suppressed bits (a ballot per warp) into the
//      leader's (rank 0's) T-bit mask through distributed shared memory: an
//      OR does not depend on order;
//   2. computes its share of the tile's bit matrix, IoU > thresh for j < k,
//      as column words: word a of column k holds rows j = 32a + t. The
//      matrix is cut into 32 x 32 blocks (a <= w), spread over the blocks
//      of the cluster, one per warp; lane t takes column k = 32w + t against
//      the block's 32 rows and stores its word into the leader's shared
//      memory;
//   cluster barrier
//   3. one warp of the leader resolves the tile one 32-candidate word at a
//      time: lane t's candidate k is live if valid, not swept, and not
//      suppressed by a survivor of an earlier word (its column words ANDed
//      with those words' survivors); the word's survivors are then the
//      fixpoint of kept = ballot(live && !(column word & kept)), which is
//      reached within 32 steps and is the greedy answer (bit t depends only
//      on bits below it). It writes the tile's keep bytes and the
//      survivors' tile positions;
//   cluster barrier
//   4. every block copies its round-robin share of the new survivors' boxes.
// Steps 1 and 2 first test 32 pairs at a time, without a divide, for an
// overlap (iw > 0 and ih > 0), and take the exact IoU only for the pairs
// that overlap (a lane's loop over its set bits), so a warp pays for the
// divides of its busiest lane, not of every pair any lane overlaps. The
// survivor count is the same in every block, so the `enough` test is
// uniform; tiles never reached keep their `valid` value, as in the plain
// version. The IoU is computed in the plain version's order and this file
// is built with --fmad=false, so no multiply-add is contracted and every
// comparison iou > thresh matches the plain version bit for bit. The
// pre-test holds only for thresh >= 0: where !(inter > 0) the quotient is
// 0, -0 or NaN, none of which is > thresh; below 0 every pair takes the
// divide.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float FAR = -1e8f;

__device__ __forceinline__ float inter_p1(float4 a, float4 b) {
  const float x1 = fmaxf(a.x, b.x);
  const float y1 = fmaxf(a.y, b.y);
  const float x2 = fminf(a.z, b.z);
  const float y2 = fminf(a.w, b.w);
  const float iw = fmaxf(0.f, x2 - x1 + 1.f);
  const float ih = fmaxf(0.f, y2 - y1 + 1.f);
  return iw * ih;
}

__device__ __forceinline__ bool iou_gt(float4 a, float4 b, float thresh) {
  const float inter = inter_p1(a, b);
  const float area_a = (a.z - a.x + 1.f) * (a.w - a.y + 1.f);
  const float area_b = (b.z - b.x + 1.f) * (b.w - b.y + 1.f);
  return inter / (area_a + area_b - inter) > thresh;
}

// Whether the pair overlaps: x2 - x1 > -1 and y2 - y1 > -1, that is iw > 0
// and ih > 0 (d + 1 rounds to a value > 0 exactly when d > -1; a NaN d
// fails, and its iw is 0). Wherever inter > 0, both hold.
__device__ __forceinline__ uint32_t overlaps(float4 a, float4 b) {
  return fminf(a.z, b.z) - fmaxf(a.x, b.x) > -1.f && fminf(a.w, b.w) - fmaxf(a.y, b.y) > -1.f;
}

__device__ __forceinline__ bool bit(const uint32_t* words, int k) {
  return (words[k >> 5] >> (k & 31)) & 1u;
}

// Survivor boxes one block of a C-block cluster holds at most, rounded up
// to runs of 32 (the sweep's; FAR boxes pad the last run): the survivor
// count never passes N, nor enough - 1 + T when a budget is set (a phase
// starts only below the budget).
int capacity(int N, int T, int enough, int C) {
  const int most = enough > 0 && enough - 1 + T < N ? enough - 1 + T : N;
  return ((most + C - 1) / C + 31) / 32 * 32;
}

// Dynamic shared memory of every block: survivors[capacity] float4 |
// tile[T] float4 | column words[T/32][T] u32 | sup[T/32] u32 |
// valid bits[T/32] u32 | kept[T/32] u32 | new survivors[T] u16. Only the
// leader's column words, sup, kept and list are used.
size_t smem_bytes(int N, int T, int enough, int C) {
  const size_t words = T / 32;
  return (size_t)capacity(N, T, enough, C) * 16 + (size_t)T * 16 + (size_t)T * words * 4 +
         3 * words * 4 + (size_t)T * 2;
}

__global__ void __launch_bounds__(THREADS, 1)
nms_kernel(const float4* __restrict__ boxes, const bool* __restrict__ valid,
           bool* __restrict__ keep_out, int N, int T, float thresh, int enough, int cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int W = T >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float4* surv_s = reinterpret_cast<float4*>(smem);
  float4* tile_s = surv_s + cap;
  uint32_t* col_s = reinterpret_cast<uint32_t*>(tile_s + T);
  uint32_t* sup_s = col_s + W * T;
  uint32_t* vbits_s = sup_s + W;
  uint32_t* kept_s = vbits_s + W;
  uint16_t* list_s = reinterpret_cast<uint16_t*>(kept_s + W);
  __shared__ int n_new_s;
  // the leader's buffers, as every block of the cluster addresses them
  uint32_t* col_l = cluster.map_shared_rank(col_s, 0);
  uint32_t* sup_l = cluster.map_shared_rank(sup_s, 0);
  const uint16_t* list_l = cluster.map_shared_rank(list_s, 0);
  const int* n_new_l = cluster.map_shared_rank(&n_new_s, 0);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)(blockIdx.x / C) * N;
  const float4* bb = boxes + base;
  const bool* vb = valid + base;
  bool* kb = keep_out + base;
  const bool skip = thresh >= 0.f;
  const int per_box = THREADS / T;  // threads per candidate in the sweep
  const int blocks = W * (W + 1) / 2;  // 32 x 32 blocks (a <= w) of the bit matrix

  if (tid < W) sup_s[tid] = 0;
  cluster.sync();  // every block runs, and the leader's mask of suppressed bits is clear

  int total = 0;  // survivors so far: the same in every block of the cluster
  int off = 0;
  for (; off < N; off += T) {
    if (enough > 0 && total >= enough) break;
    if (tid < T) {
      const bool v = vb[off + tid];
      tile_s[tid] = v ? bb[off + tid] : make_float4(FAR, FAR, FAR, FAR);
      const uint32_t bits = __ballot_sync(FULL, v);
      if (lane == 0) vbits_s[tid >> 5] = bits;
    }
    __syncthreads();

    // 1. the sweep: thread (k, part) takes this block's survivors in runs
    //    of 32 from 32 * part on, every 32 * per_box.
    if (tid < T * per_box) {  // whole warps: T is a multiple of 32
      const int k = tid % T, part = tid / T;
      const int mine = (total - r + C - 1) / C;
      bool sup = false;
      if (bit(vbits_s, k)) {
        const float4 bk = tile_s[k];
        for (int q0 = 32 * part; q0 < mine && !sup; q0 += 32 * per_box) {
          uint32_t maybe = mine - q0 >= 32 ? ~0u : (1u << (mine - q0)) - 1u;  // not the padding
          if (skip) {
            maybe = 0;
#pragma unroll
            for (int t = 0; t < 32; ++t) maybe |= overlaps(surv_s[q0 + t], bk) << t;
          }
          for (; maybe && !sup; maybe &= maybe - 1)
            sup = iou_gt(surv_s[q0 + __ffs(maybe) - 1], bk, thresh);
        }
      }
      const uint32_t bits = __ballot_sync(FULL, sup);
      if (lane == 0 && bits) atomicOr(sup_l + (k >> 5), bits);
    }

    // 2. the bit matrix: block u (row-major over a <= w) on block u % C of
    //    the cluster, warp u / C; lane t holds column k = 32w + t.
    for (int u = warp * C + r; u < blocks; u += C * WARPS) {
      int a = 0, x = u;
      while (x >= W - a) x -= W - a++;
      const int k = ((a + x) << 5) + lane;
      uint32_t word = 0;
      if (bit(vbits_s, k)) {
        const float4 bk = tile_s[k];
        const float4* rows = tile_s + (a << 5);
        uint32_t maybe = ~0u;
        if (skip) {
          maybe = 0;
#pragma unroll
          for (int t = 0; t < 32; ++t) maybe |= overlaps(rows[t], bk) << t;
        }
        if (x == 0) maybe &= (1u << lane) - 1u;  // the diagonal block: rows j < k
        for (; maybe; maybe &= maybe - 1) {
          const int t = __ffs(maybe) - 1;
          if (iou_gt(rows[t], bk, thresh)) word |= 1u << t;
        }
      }
      col_l[a * T + k] = word;
    }
    cluster.sync();

    // 3. the walk, by warp 0 of the leader; kept_s[v] holds the survivors
    //    of word v once it is resolved.
    if (r == 0 && warp == 0) {
      int n = 0;
      for (int w = 0; w < W; ++w) {
        const int k = (w << 5) + lane;
        uint32_t hit = 0;
        for (int v = 0; v < w; ++v) hit |= col_s[v * T + k] & kept_s[v];
        const bool live = bit(vbits_s, k) && !bit(sup_s, k) && !hit;
        const uint32_t col = col_s[w * T + k];
        uint32_t kept = __ballot_sync(FULL, live), prev;
        do {
          prev = kept;
          kept = __ballot_sync(FULL, live && !(col & kept));
        } while (kept != prev);
        if (lane == 0) kept_s[w] = kept;
        __syncwarp();
        const bool alive = (kept >> lane) & 1u;
        kb[off + k] = alive;
        if (alive) list_s[n + __popc(kept & ((1u << lane) - 1u))] = (uint16_t)k;
        n += __popc(kept);
      }
      if (lane < W) sup_s[lane] = 0;
      if (lane == 0) n_new_s = n;
    }
    cluster.sync();

    // 4. this block's share of the new survivors: global survivor g =
    //    total + i goes to block g % C, at position g / C.
    //    FAR boxes, which overlap no candidate, pad the last run of 32.
    const int n_new = *n_new_l;
    for (int i = (r - total % C + C) % C + tid * C; i < n_new; i += THREADS * C)
      surv_s[(total + i) / C] = tile_s[list_l[i]];
    total += n_new;
    const int mine = (total - r + C - 1) / C;
    if (tid < (32 - mine % 32) % 32) surv_s[mine + tid] = make_float4(FAR, FAR, FAR, FAR);
    __syncthreads();
  }

  // tiles never reached keep their valid value, as in the plain version
  for (int k = off + r * THREADS + tid; k < N; k += C * THREADS) kb[k] = vb[k];
  cluster.sync();  // the leader's shared memory lives until every block is done with it
}

cudaError_t configure(int B, int N, int T, int enough, int C, void* stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = smem_bytes(N, T, enough, C);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" size_t frcnn_nms_smem_bytes(int N, int T, int enough, int C) {
  return smem_bytes(N, T, enough, C);
}

// Clusters of C blocks that can run on the card at once at these shapes
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int frcnn_nms_max_active_clusters(int N, int T, int enough, int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(1, N, T, enough, C, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, nms_kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// boxes (B, N, 4) f32, valid (B, N) bool -> keep (B, N) bool, on clusters of
// C blocks (1 <= C <= 8); T a multiple of 32 in [32, 1024] that divides N.
extern "C" int frcnn_nms_keep_mask(const void* boxes, const void* valid, void* keep, int B, int N,
                                   int T, float thresh, int enough, int C, void* stream) {
  if (C < 1 || C > 8 || T < 32 || T > THREADS || T % 32 || N % T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(B, N, T, enough, C, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, (const float4*)boxes, (const bool*)valid,
                           (bool*)keep, N, T, thresh, enough, capacity(N, T, enough, C));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
