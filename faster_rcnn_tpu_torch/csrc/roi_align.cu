// RoI align: TF1-bilinear crop-and-resize of integer feature-space ROIs
// [x1, y1, x2, y2] to P x P cells, NHWC in, (B, R, P, P, C) out; and its
// backward, the 4-tap scatter-add of the pooled cotangent into the map.
//
// Replaces: faster_rcnn_tpu/ops/roi_align_pallas.py _kernel (pallas_call at
// :178, driven by _forward :104, entry roi_align_pallas :195). Its backward
// (_bwd :213) is no Pallas kernel there: XLA's transpose of the einsum form
// roi_align_einsum, computed in f32 and cast to the feature dtype. The
// backward kernel below is its counterpart.
//
// What bounds it on the H100: at B=16, 300 ROIs, a 38x94x1024 bf16 map it
// must read the 117.1 MB feature map once and write 481.7 MB of pooled
// features, 0.179 ms at 3.35 TB/s; the interpolation arithmetic is
// negligible. It is memory-bound, and the output write dominates.
//
// Design: the TPU kernel recast the resize as dense matmuls for the MXU and
// sorted ROIs by y1 to skip chunks; none of that is needed here. One block
// computes one output row i of one ROI: it works out the row taps once, then
// for each output column j the column taps, and its threads run along the
// channels with 16-byte vector loads from the NHWC map, so neighbouring
// threads read neighbouring addresses and each tap read is one coalesced
// sweep of C values. Interpolation is f32; the store is T (bf16 or f32).
// The tap arithmetic repeats faster_rcnn_tpu/ops/roi_align.py _tap_weights
// and the gather form roi_align: crop/P first, then i*(crop/P), floor, the
// crop-1 clamp of the upper tap, then the [0, limit-1] clamp.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois, T* __restrict__ out,
                 int H, int W, int C, int R, int P) {
  const int b = blockIdx.y;
  const int r = blockIdx.x / P;
  const int i = blockIdx.x % P;
  const float* roi = rois + ((size_t)b * R + r) * 4;
  const float x1 = roi[0], y1 = roi[1];
  const float crop_w = roi[2] - x1, crop_h = roi[3] - y1;
  const Taps ty = taps(i, y1, crop_h, P, H);

  constexpr int VN = Vec16<T>::N;
  const int nvec = C / VN;
  const T* fb = feat + (size_t)b * H * W * C;
  const uint4* rowA = reinterpret_cast<const uint4*>(fb + (size_t)ty.lo * W * C);
  const uint4* rowB = reinterpret_cast<const uint4*>(fb + (size_t)ty.hi * W * C);
  T* ob = out + ((((size_t)b * R + r) * P + i) * P) * C;

  for (int j = 0; j < P; ++j) {
    const Taps tx = taps(j, x1, crop_w, P, W);
    const size_t a = (size_t)tx.lo * nvec, bo = (size_t)tx.hi * nvec;
    uint4* o = reinterpret_cast<uint4*>(ob + (size_t)j * C);
    for (int v = threadIdx.x; v < nvec; v += THREADS) {
      Vec16<T> f00, f01, f10, f11, res;
      f00.raw = rowA[a + v];
      f01.raw = rowA[bo + v];
      f10.raw = rowB[a + v];
      f11.raw = rowB[bo + v];
#pragma unroll
      for (int k = 0; k < VN; ++k) {
        const float p00 = to_f32(f00.v()[k]), p01 = to_f32(f01.v()[k]);
        const float p10 = to_f32(f10.v()[k]), p11 = to_f32(f11.v()[k]);
        const float top = p00 + (p01 - p00) * tx.frac;
        const float bot = p10 + (p11 - p10) * tx.frac;
        res.v()[k] = from_f32<T>(top + (bot - top) * ty.frac);
      }
      o[v] = res.raw;
    }
  }
}

template <typename T>
int launch(const void* feat, const void* rois, void* out, int B, int H, int W, int C, int R,
           int P, void* stream) {
  dim3 grid(R * P, B);
  roi_align_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)feat, (const float*)rois, (T*)out, H, W, C, R, P);
  return (int)cudaGetLastError();
}

// Backward. What bounds it: at B=16, R=64 (the train step) it must read the
// 102.8 MB bf16 cotangent and write the 117.0 MB bf16 gradient of the map,
// 0.066 ms at 3.35 TB/s. The sampler draws ROIs with replacement, so ROIs
// repeat and overlap and no block owns a part of the map: every tap is an
// f32 atomic add into a zeroed f32 copy of the map, which one pass then
// rounds to the feature dtype (the JAX VJP also sums in f32 and rounds
// once). The f32 scratch and the atomics are this design's cost beyond the
// bound; the order of the atomic adds varies from run to run, so the result
// is not bit-deterministic. One block takes one output row i of one ROI, as
// the forward does; its threads run along the channels, so each warp's
// atomics land on 32 consecutive floats. A tap whose weight is zero is
// skipped.
template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_bwd_kernel(const T* __restrict__ grad, const float* __restrict__ rois,
                     float* __restrict__ dfeat, int H, int W, int C, int R, int P) {
  const int b = blockIdx.y;
  const int r = blockIdx.x / P;
  const int i = blockIdx.x % P;
  const float* roi = rois + ((size_t)b * R + r) * 4;
  const float x1 = roi[0], y1 = roi[1];
  const float crop_w = roi[2] - x1, crop_h = roi[3] - y1;
  const Taps ty = taps(i, y1, crop_h, P, H);
  const float wy[2] = {1.f - ty.frac, ty.frac};
  float* rows[2] = {dfeat + ((size_t)b * H + ty.lo) * W * C,
                    dfeat + ((size_t)b * H + ty.hi) * W * C};
  const T* gb = grad + ((((size_t)b * R + r) * P + i) * P) * C;

  for (int j = 0; j < P; ++j) {
    const Taps tx = taps(j, x1, crop_w, P, W);
    const float wx[2] = {1.f - tx.frac, tx.frac};
    const int xs[2] = {tx.lo, tx.hi};
    const T* g = gb + (size_t)j * C;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (wy[a] == 0.f) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (wx[e] == 0.f) continue;
        const float w = wy[a] * wx[e];
        float* dst = rows[a] + (size_t)xs[e] * C;
        for (int c = threadIdx.x; c < C; c += THREADS) atomicAdd(dst + c, to_f32(g[c]) * w);
      }
    }
  }
}

// f32 -> bf16, four values a thread a step (n is a multiple of 4).
__global__ void f32_to_bf16_kernel(const float4* __restrict__ in, __nv_bfloat162* __restrict__ out,
                                   size_t n4) {
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < n4;
       v += (size_t)gridDim.x * blockDim.x) {
    const float4 f = in[v];
    out[2 * v] = __floats2bfloat162_rn(f.x, f.y);
    out[2 * v + 1] = __floats2bfloat162_rn(f.z, f.w);
  }
}

template <typename T>
int launch_bwd(const void* grad, const void* rois, void* dfeat32, void* dfeat, int B, int H, int W,
               int C, int R, int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)B * H * W * C;
  cudaError_t err = cudaMemsetAsync(dfeat32, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R * P, B);
  roi_align_bwd_kernel<T><<<grid, THREADS, 0, s>>>((const T*)grad, (const float*)rois,
                                                   (float*)dfeat32, H, W, C, R, P);
  if (dfeat != dfeat32) {
    f32_to_bf16_kernel<<<132 * 8, 256, 0, s>>>((const float4*)dfeat32, (__nv_bfloat162*)dfeat,
                                               n / 4);
  }
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

// dfeat32: a (B, H, W, C) f32 scratch, zeroed here; dfeat: the bf16 result.
extern "C" int frcnn_roi_align_bwd_bf16(const void* grad, const void* rois, void* dfeat32,
                                        void* dfeat, int B, int H, int W, int C, int R, int P,
                                        void* stream) {
  return launch_bwd<__nv_bfloat16>(grad, rois, dfeat32, dfeat, B, H, W, C, R, P, stream);
}

// The f32 result is accumulated in place: dfeat32 and dfeat are one buffer.
extern "C" int frcnn_roi_align_bwd_f32(const void* grad, const void* rois, void* dfeat32,
                                       void* dfeat, int B, int H, int W, int C, int R, int P,
                                       void* stream) {
  return launch_bwd<float>(grad, rois, dfeat32, dfeat, B, H, W, C, R, P, stream);
}

extern "C" const char* frcnn_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
