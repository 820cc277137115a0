// ResNet stem convolution: 7x7, stride 2, Flax SAME padding, 3 -> 64
// channels, NHWC, f32 accumulation, no bias (Conv1 adds it afterwards).
//
// Replaces: faster_rcnn_tpu/ops/conv1_pallas.py _kernel_v2 (pallas_call at
// :262, entry conv1_pallas_v2 :277), and with it the v1 lowering _kernel
// (:136, conv1_pallas :150), which computes the same function.
//
// What bounds it on the H100: at B=16, 608x1504 it reads an 87.8 MB bf16
// canvas and writes a 468.2 MB bf16 map, 0.166 ms at 3.35 TB/s; its 68.8
// GFLOP take 0.070 ms at the bf16 tensor-core peak, so with the products on
// tensor cores the bytes bound it. As f32 FMAs on the CUDA cores (67 TFLOP/s)
// the same work takes at least 1.03 ms.
//
// Two entries:
//
// frcnn_conv1_bf16 (the detection path and the train step; kitti_config
// computes in bf16) is an implicit GEMM on the tensor cores: M = output
// pixels, N = 64 channels, K = (dy, dx, c). For a fixed dy the 7 x 3 taps
// (dx, c) of output column x are 21 contiguous bf16 values of the NHWC input
// row, from element 6x - 6 + kk, kk = 3dx + c. So K is cut into 7 segments
// of 24 (kk 21..23, the dx = 7 of the 8x8 round-up, take zero weights), 168
// deep, k = 24*dy + kk: 10 m16n8k16 steps and one m16n8k8 step of mma.sync
// bf16 with f32 accumulation. Each 8-wide block m of K (k = 8m .. 8m+7) lies
// in one tap row, dy = m / 3, at kk = 8*(m % 3) .. +7, so the A fragments are
// read straight from the staged input rows: no im2col.
//   - Block: TY output rows x TX output columns x 64 channels, 8 warps. Warp
//     w owns channels 32*(w&1) .. +31 and the 16-pixel tiles (w>>1) and
//     (w>>1)+4 of each output row.
//   - Weights: packed once per block into shared memory as Wt[n][k] (zeros
//     at kk >= 21); each warp then keeps the B fragments of its 4 n-tiles
//     for all 21 K blocks in 84 registers.
//   - Staging: input rows as bf16 in a ring of 16 slots (slot = (iy+2) & 15),
//     word j of a slot holding row elements 6*x0 - 6 + 2j and +1. Each word
//     is one cp.async of 4 bytes with zero-fill where the pair lies outside
//     the image (SAME: 2 rows and columns before, 3 after). 6*x0 - 6 and 3W
//     are even and a row starts at a multiple of 4 bytes, so every pair is
//     wholly inside or outside the image and no shifted base is needed. The
//     two rows of the next output row are copied while this one computes.
//   - A fragments: 32-bit shared loads; for block m lane (g, t) reads word
//     3*(px+g) + t + 4*(m % 3) of tap row m / 3 (+24 for row g+8): 3g + t
//     spans 25 banks, so no conflicts. In the blocks m % 3 == 2 (kk 16..23)
//     lanes t = 3 (kk 22, 23) and the upper half of t = 2 (kk 21) are
//     zeroed, so a padding tap multiplies a zero weight by zero and a value
//     outside the 7x7 window cannot reach the output.
//   - Output: each tile's 16 pixels x 32 channels are rounded to bf16 once,
//     transposed through a per-warp shared buffer (16-byte chunks XOR-
//     swizzled by pixel, conflict-free both ways) and written as streaming
//     16-byte stores, 64 contiguous bytes per pixel.
//
// frcnn_conv1_f32 keeps a direct convolution on the CUDA cores: a bf16
// tensor-core product is not an f32 convolution, and TF32 would miss the
// f32 limits (1e-5 of max|ref| in tests/test_torch_gpu.py, the B=2 f32
// whole-path comparison in chip_smoke.py). No main path runs it. One block
// computes TY_F x TX_F outputs; weights as f32 in shared memory, input rows
// in a ring of 8 slots as per-channel even/odd planes, 4 pixels x 16
// channels per thread.
#include "common.cuh"

namespace {

constexpr int KS = 7;
constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int TAPS = KS * KS * CIN;  // 147

// ---------------------------------------------------------------- bf16 (mma)

constexpr int KSEG = 24;                   // taps (dx, c) per input row, 21 rounded up
constexpr int KWORDS = KS * KSEG / 2;      // bf16 pairs of one weight column: 84
constexpr int KBLOCKS = KS * KSEG / 8;     // 8-deep blocks of K: 21
constexpr int TILE = 16;                   // output pixels of one mma tile (M)
constexpr int TX = 128;                    // output columns per block
constexpr int TY = 16;                     // output rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS = 16;                  // ring of staged input rows
constexpr int ROW_WORDS = 3 * TX + 12;     // staged words per row (3*TX + 9 are read)
constexpr int OUT_WORDS = TILE * 16;       // one warp's 16 pixels x 32 channels
constexpr size_t SMEM =
    (size_t)(COUT * KWORDS + SLOTS * ROW_WORDS + WARPS * OUT_WORDS) * sizeof(uint32_t);

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A (16x16, row) * B (16x8, col) + D; bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D = A (16x8, row) * B (8x8, col) + D
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 2)
conv1_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) uint32_t smem_u32[];
  uint32_t* w_s = smem_u32;                           // [n][KWORDS]
  uint32_t* ring = w_s + COUT * KWORDS;               // [slot][ROW_WORDS]
  uint32_t* o_s = ring + SLOTS * ROW_WORDS;           // [warp][OUT_WORDS]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int ny = min(TY, Ho - y0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nh = warp & 1;  // channels 32*nh .. 32*nh + 31
  const int row_elems = 3 * W;
  const __nv_bfloat16* xb = x + (size_t)b * H * row_elems;

  // input row iy (>= -2) -> its ring slot; zeros outside the image
  auto stage = [&](int iy) {
    uint32_t* dst = ring + ((iy + 2) & (SLOTS - 1)) * ROW_WORDS;
    const bool row_in = iy >= 0 && iy < H;
    const __nv_bfloat16* src_row = xb + (size_t)(row_in ? iy : 0) * row_elems;
    for (int j = tid; j < ROW_WORDS; j += THREADS) {
      const int e = 6 * x0 - 6 + 2 * j;  // even: the pair (e, e+1) is in or out as a whole
      const bool in = row_in && e >= 0 && e < row_elems;
      cp_async4(dst + j, in ? (const void*)(src_row + e) : (const void*)x, in ? 4 : 0);
    }
  };

  for (int dy = 0; dy < KS; ++dy) stage(2 * y0 - 2 + dy);
  cp_async_commit();

  // Wt[n][k/2] as bf16 pairs, k = 24*dy + kk; HWIO w[dy][dx][c][n] = w[(21*dy + kk)*64 + n]
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  for (int i = tid; i < COUT * KWORDS; i += THREADS) {
    const int n = i & (COUT - 1), kw = i >> 6;
    const int dy = kw / (KSEG / 2), kk = 2 * (kw % (KSEG / 2));
    const uint32_t lo = kk < KS * CIN ? wu[(KS * CIN * dy + kk) * COUT + n] : 0u;
    const uint32_t hi = kk + 1 < KS * CIN ? wu[(KS * CIN * dy + kk + 1) * COUT + n] : 0u;
    w_s[n * KWORDS + kw] = lo | (hi << 16);
  }
  __syncthreads();

  // B fragments of n-tiles j (columns 32*nh + 8j + g): K block m holds k 8m + 2t, +1
  uint32_t bf[4][KBLOCKS];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < KBLOCKS; ++m)
      bf[j][m] = w_s[(32 * nh + 8 * j + g) * KWORDS + 4 * m + t];
  // K blocks m % 3 == 2 hold kk = 16 + 2t, 17 + 2t; kk >= 21 is padding
  const uint32_t kmask = t < 2 ? 0xFFFFFFFFu : (t == 2 ? 0x0000FFFFu : 0u);
  uint32_t* obuf = o_s + warp * OUT_WORDS;

  for (int r = 0; r < ny; ++r) {
    const int oy = y0 + r;
    if (r + 1 < ny) {  // the next output row's two new input rows
      stage(2 * oy + 5);
      stage(2 * oy + 6);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // rows 2oy-2 .. 2oy+4 staged by every thread

#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
      const int px = TILE * ((warp >> 1) + 4 * q);  // tile's first column in the block
      if (x0 + px >= Wo) break;                     // uniform across the warp
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      // K block m: rows g and g + 8 of the tile, from tap row m / 3
      auto a_block = [&](int m, uint32_t& lo, uint32_t& hi) {
        const uint32_t* row = ring + ((2 * oy + m / 3) & (SLOTS - 1)) * ROW_WORDS +
                              3 * (px + g) + t + 4 * (m % 3);
        lo = row[0];
        hi = row[24];
        if (m % 3 == 2) {
          lo &= kmask;
          hi &= kmask;
        }
      };
#pragma unroll
      for (int s = 0; s < KBLOCKS / 2; ++s) {
        uint32_t a0, a1, a2, a3;
        a_block(2 * s, a0, a1);
        a_block(2 * s + 1, a2, a3);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_k16(acc[j], a0, a1, a2, a3, bf[j][2 * s], bf[j][2 * s + 1]);
      }
      {
        uint32_t a0, a1;
        a_block(KBLOCKS - 1, a0, a1);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_k8(acc[j], a0, a1, bf[j][KBLOCKS - 1]);
      }
      // C: (pixel g, channels 8j+2t, +1) and (pixel g+8, ...) -> obuf[pixel][chunk ^ swz]
      const int swz = (g >> 1) & 3;  // the same for pixel g + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        obuf[16 * g + 4 * (j ^ swz) + t] = pack_bf16x2(acc[j][0], acc[j][1]);
        obuf[16 * (g + 8) + 4 * (j ^ swz) + t] = pack_bf16x2(acc[j][2], acc[j][3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = (lane >> 2) + 8 * i, c = lane & 3;
        const int ox = x0 + px + p;
        const uint4 v =
            *reinterpret_cast<const uint4*>(obuf + 16 * p + 4 * (c ^ ((p >> 1) & 3)));
        if (ox < Wo)
          __stcs(reinterpret_cast<uint4*>(out + (((size_t)b * Ho + oy) * Wo + ox) * COUT +
                                          32 * nh + 8 * c), v);
      }
      __syncwarp();  // the buffer's reads finish before the next tile writes it
    }
  }
}

// ---------------------------------------------------------------- f32 (CUDA cores)

constexpr int LX = 64;                      // column threads per channel group
constexpr int PX = 4;                       // output columns per thread
constexpr int TX_F = LX * PX;               // output columns per block: 256
constexpr int TY_F = 8;                     // output rows per block
constexpr int GROUP = 16;                   // output channels per thread
constexpr int NGROUP = COUT / GROUP;        // 4
constexpr int THREADS_F = LX * NGROUP;      // 256
constexpr int SPAN = 2 * TX_F + KS - 2;     // staged input columns: 517
constexpr int HALF = (SPAN + 1) / 2;        // columns of one parity: 259
constexpr int PLANE = 2 * HALF;             // one (row, channel) plane
constexpr int SLOTS_F = 8;                  // ring of staged input rows
constexpr size_t SMEM_F = (size_t)(TAPS * COUT + SLOTS_F * CIN * PLANE) * sizeof(float);

__global__ void __launch_bounds__(THREADS_F, 2)
conv1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                   // [tap][64]
  float* in_s = smem + TAPS * COUT;    // [slot][c][parity][HALF]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY_F;
  const int x0 = blockIdx.x * TX_F;
  const int tid = threadIdx.x;
  const int lx = tid % LX;
  const int g = tid / LX;  // warp-uniform: LX is a multiple of 32
  const float* xb = x + (size_t)b * H * W * CIN;

  // w is HWIO (dy, dx, c, m): index ((dy*7+dx)*3+c)*64+m == tap*64+m.
  for (int i = tid; i < TAPS * COUT; i += THREADS_F) w_s[i] = w[i];

  // input row iy (>= -2) -> its ring slot, zeros outside the image
  auto stage = [&](int iy) {
    float* dst = in_s + ((iy + SLOTS_F) % SLOTS_F) * CIN * PLANE;
    const bool row_in = iy >= 0 && iy < H;
    for (int i = tid; i < SPAN * CIN; i += THREADS_F) {
      const int c = i % CIN;  // c fastest: consecutive threads, consecutive addresses
      const int j = i / CIN;
      const int ix = 2 * x0 - 2 + j;
      float v = 0.f;
      if (row_in && ix >= 0 && ix < W) v = xb[((size_t)iy * W + ix) * CIN + c];
      dst[c * PLANE + (j & 1) * HALF + (j >> 1)] = v;
    }
  };

  for (int r = 0; r < TY_F; ++r) {
    const int oy = y0 + r;
    if (oy >= Ho) break;  // uniform across the block
    __syncthreads();      // weights written / previous row's reads finished
    if (r == 0) {
      for (int dy = 0; dy < KS; ++dy) stage(2 * oy - 2 + dy);
    } else {
      stage(2 * oy + 3);  // rows 2y-2 .. 2y+2 are staged already
      stage(2 * oy + 4);
    }
    __syncthreads();

    float acc[PX][GROUP];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int k = 0; k < GROUP; ++k) acc[p][k] = 0.f;
    for (int dy = 0; dy < KS; ++dy) {
      const float* rows = in_s + ((2 * oy - 2 + dy + SLOTS_F) % SLOTS_F) * CIN * PLANE;
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
          // staged column of output column xl and tap dx: 2*xl + dx
          const float* row = rows + c * PLANE + (dx & 1) * HALF + (dx >> 1) + lx;
          float v[PX];
#pragma unroll
          for (int p = 0; p < PX; ++p) v[p] = row[p * LX];
          const float4* wr = reinterpret_cast<const float4*>(
              &w_s[((dy * KS + dx) * CIN + c) * COUT + g * GROUP]);
#pragma unroll
          for (int q = 0; q < GROUP / 4; ++q) {
            const float4 wv = wr[q];
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              acc[p][4 * q + 0] += v[p] * wv.x;
              acc[p][4 * q + 1] += v[p] * wv.y;
              acc[p][4 * q + 2] += v[p] * wv.z;
              acc[p][4 * q + 3] += v[p] * wv.w;
            }
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int ox = x0 + lx + p * LX;
      if (ox >= Wo) continue;
      float* o = out + (((size_t)b * Ho + oy) * Wo + ox) * COUT + g * GROUP;
#pragma unroll
      for (int q = 0; q < GROUP / 4; ++q)
        reinterpret_cast<float4*>(o)[q] =
            make_float4(acc[p][4 * q], acc[p][4 * q + 1], acc[p][4 * q + 2], acc[p][4 * q + 3]);
    }
  }
}

}  // namespace

extern "C" int frcnn_conv1_bf16(const void* x, const void* w, void* out, int B, int H, int W,
                                void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t err = cudaFuncSetAttribute(conv1_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + TX - 1) / TX, (Ho + TY - 1) / TY, B);
  conv1_mma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int frcnn_conv1_f32(const void* x, const void* w, void* out, int B, int H, int W,
                               void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t err = cudaFuncSetAttribute(conv1_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_F);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + TX_F - 1) / TX_F, (Ho + TY_F - 1) / TY_F, B);
  conv1_f32_kernel<<<grid, THREADS_F, SMEM_F, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, H, W);
  return (int)cudaGetLastError();
}
