// ResNet stem convolution: 7x7, stride 2, Flax SAME padding, 3 -> 64
// channels, NHWC, f32 accumulation, no bias (Conv1 adds it afterwards).
//
// Replaces: faster_rcnn_tpu/ops/conv1_pallas.py _kernel_v2 (pallas_call at
// :262, entry conv1_pallas_v2 :277), and with it the v1 lowering _kernel
// (:136, conv1_pallas :150), which computes the same function.
//
// What bounds it on the H100: at B=16, 608x1504 it reads an 87.8 MB bf16
// canvas and writes a 468.2 MB bf16 map, 0.166 ms at 3.35 TB/s; its 68.8
// GFLOP take 0.070 ms at the bf16 tensor-core peak, so it is memory-bound
// if the products run on tensor cores. This version does them as f32 FMAs
// on the CUDA cores (67 TFLOP/s peak, about 1 ms for the same work), so in
// practice the FMA rate bounds it; moving the 147-deep contraction onto
// tensor cores is the next step for this kernel.
//
// Design: one block computes TY output rows x TX output columns x 64
// channels. The 7*7*3*64 weights are converted to f32 once per block and kept
// in shared memory (37.6 KB). Output row y needs input rows 2y-2 .. 2y+4
// (zero outside the image = SAME padding of 2 before and 3 after); they are
// staged in shared memory as f32, 2*TX+5 columns wide, in a ring of 8 row
// slots (slot = row mod 8), so the next output row stages only its 2 new
// input rows. Each staged row keeps one plane per channel with even and odd
// columns apart. Thread (lx, g) accumulates 16 output channels of the PX
// columns lx, lx+LX, ... in registers, so each weight read feeds PX pixels;
// a warp shares g, so its weight reads are shared-memory broadcasts, and its
// input reads hit consecutive words (no bank conflicts). Each thread stores
// its 16 channels per pixel as contiguous 16-byte vectors.
#include "common.cuh"

namespace {

constexpr int KS = 7;
constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int TAPS = KS * KS * CIN;   // 147
constexpr int LX = 64;                // column threads per channel group
constexpr int PX = 4;                 // output columns per thread
constexpr int TX = LX * PX;           // output columns per block: 256
constexpr int TY = 8;                 // output rows per block
constexpr int GROUP = 16;             // output channels per thread
constexpr int NGROUP = COUT / GROUP;  // 4
constexpr int THREADS = LX * NGROUP;  // 256
constexpr int SPAN = 2 * TX + KS - 2; // staged input columns: 517
constexpr int HALF = (SPAN + 1) / 2;  // columns of one parity: 259
constexpr int PLANE = 2 * HALF;       // one (row, channel) plane
constexpr int SLOTS = 8;              // ring of staged input rows
constexpr size_t SMEM = (size_t)(TAPS * COUT + SLOTS * CIN * PLANE) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
conv1_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
             int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                   // [tap][64]
  float* in_s = smem + TAPS * COUT;    // [slot][c][parity][HALF]

  const int Ho = H / 2, Wo = W / 2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int tid = threadIdx.x;
  const int lx = tid % LX;
  const int g = tid / LX;  // warp-uniform: LX is a multiple of 32
  const T* xb = x + (size_t)b * H * W * CIN;

  // w is HWIO (dy, dx, c, m): index ((dy*7+dx)*3+c)*64+m == tap*64+m.
  for (int i = tid; i < TAPS * COUT; i += THREADS) w_s[i] = to_f32(w[i]);

  // input row iy (>= -2) -> its ring slot, zeros outside the image
  auto stage = [&](int iy) {
    float* dst = in_s + ((iy + SLOTS) % SLOTS) * CIN * PLANE;
    const bool row_in = iy >= 0 && iy < H;
    for (int i = tid; i < SPAN * CIN; i += THREADS) {
      const int c = i % CIN;  // c fastest: consecutive threads, consecutive addresses
      const int j = i / CIN;
      const int ix = 2 * x0 - 2 + j;
      float v = 0.f;
      if (row_in && ix >= 0 && ix < W) v = to_f32(xb[((size_t)iy * W + ix) * CIN + c]);
      dst[c * PLANE + (j & 1) * HALF + (j >> 1)] = v;
    }
  };

  for (int r = 0; r < TY; ++r) {
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
      const float* rows = in_s + ((2 * oy - 2 + dy + SLOTS) % SLOTS) * CIN * PLANE;
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

    constexpr int VN = Vec16<T>::N;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int ox = x0 + lx + p * LX;
      if (ox >= Wo) continue;
      T* o = out + (((size_t)b * Ho + oy) * Wo + ox) * COUT + g * GROUP;
#pragma unroll
      for (int q = 0; q < GROUP / VN; ++q) {
        Vec16<T> pk;
#pragma unroll
        for (int k = 0; k < VN; ++k) pk.v()[k] = from_f32<T>(acc[p][q * VN + k]);
        reinterpret_cast<uint4*>(o)[q] = pk.raw;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t err = cudaFuncSetAttribute(conv1_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + TX - 1) / TX, (Ho + TY - 1) / TY, B);
  conv1_kernel<T><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frcnn_conv1_bf16(const void* x, const void* w, void* out, int B, int H, int W,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w, out, B, H, W, stream);
}

extern "C" int frcnn_conv1_f32(const void* x, const void* w, void* out, int B, int H, int W,
                               void* stream) {
  return launch<float>(x, w, out, B, H, W, stream);
}
