// Frozen epilogue: what follows a ResNet convolution, in one pass over its
// NHWC output. In this order, each step rounded to the map's dtype T as the
// separate PyTorch passes it replaces round it:
//   1. + the conv's bias (T), where the conv has one: cuDNN adds it in a pass
//      of its own after the product, so the conv is called without it;
//   2. the frozen batch norm, (f32(a) - mean) * inv + bias, as
//      FrozenAffine.forward: the centring (f32), then addcmul, which
//      PyTorch's CUDA kernel computes as one FMA, the product unrounded;
//   3. the channel scale of the Caffe-style ResNet-101, f32(b) * scale +
//      bias, the same affine with zero mean;
//   4. + the block's shortcut (T), on a block's last branch;
//   5. the ReLU as F.relu computes it: max(v, 0), a NaN kept as it is.
//
// Replaces no pallas_call: faster_rcnn_tpu/models/layers.py _frozen_affine is
// plain jnp, and XLA fuses it, the bias, the residual add and the ReLU into
// the convolution's consumers on the TPU. Eager PyTorch runs each step as a
// pass of its own over the map, and the batch norm's f32 temporaries twice.
//
// What bounds it on the H100: bytes; it does a few operations a byte. Each
// element is read once, the shortcut once where there is one, and written
// once: at bf16 4 bytes an element, 6 with a shortcut. Stage 2's
// (16, 152, 376, 256) map is 0.936 GB, 0.279 ms at 3.35 TB/s; stage 5's
// (4800, 7, 7, 2048) with its shortcut 2.890 GB, 0.863 ms.
//
// Design: one thread handles 16 bytes of a pixel's channels (8 bf16 or 4
// f32), neighbouring threads neighbouring vectors, in a grid-stride loop over
// the map, two vectors in flight a thread. The grid's thread count is a
// multiple of the vectors a pixel holds, so a thread keeps one channel group
// throughout: it reads that group's per-channel constants once, through the
// read-only path, into registers. The variants (bias, scale, shortcut, ReLU)
// are template parameters, chosen once a launch, not per element. The grid
// is as many blocks as the card holds at once.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, bool BIAS, bool SCALE, bool RES, bool RELU>
struct Epilogue {
  static constexpr int N = Vec16<T>::N;
  float cb[BIAS ? N : 1], mu[N], iv[N], bb[N], sc[SCALE ? N : 1], sb[SCALE ? N : 1];

  __device__ __forceinline__ void load(const T* conv_bias, const float* mean, const float* inv,
                                       const float* bn_bias, const float* scale,
                                       const float* scale_bias, int c0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (BIAS) cb[j] = to_f32(conv_bias[c0 + j]);
      mu[j] = __ldg(mean + c0 + j);
      iv[j] = __ldg(inv + c0 + j);
      bb[j] = __ldg(bn_bias + c0 + j);
      if constexpr (SCALE) {
        sc[j] = __ldg(scale + c0 + j);
        sb[j] = __ldg(scale_bias + c0 + j);
      }
    }
  }

  __device__ __forceinline__ Vec16<T> apply(const Vec16<T>& y, const Vec16<T>& r) const {
    Vec16<T> out;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = to_f32(y.v()[j]);
      if constexpr (BIAS) v = rounded<T>(__fadd_rn(v, cb[j]));
      v = rounded<T>(__fmaf_rn(__fsub_rn(v, mu[j]), iv[j], bb[j]));
      if constexpr (SCALE) v = rounded<T>(__fmaf_rn(v, sc[j], sb[j]));
      if constexpr (RES) v = __fadd_rn(v, to_f32(r.v()[j]));
      T t = from_f32<T>(v);
      if (RELU && !isnan(v)) t = from_f32<T>(fmaxf(to_f32(t), 0.0f));
      out.v()[j] = t;
    }
    return out;
  }
};

template <typename T>
__device__ __forceinline__ Vec16<T> load16(const T* p, int64_t v) {
  Vec16<T> out;
  out.raw = __ldcs(reinterpret_cast<const uint4*>(p) + v);
  return out;
}

template <typename T, bool BIAS, bool SCALE, bool RES, bool RELU>
__global__ void __launch_bounds__(THREADS)
    frozen_epilogue_kernel(const T* __restrict__ y, const T* __restrict__ conv_bias,
                           const float* __restrict__ mean, const float* __restrict__ inv,
                           const float* __restrict__ bn_bias, const float* __restrict__ scale,
                           const float* __restrict__ scale_bias, const T* __restrict__ shortcut,
                           T* __restrict__ out, int64_t nvec, int cvec) {
  using E = Epilogue<T, BIAS, SCALE, RES, RELU>;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (v >= nvec) return;
  E e;
  // stride is a multiple of cvec: every vector this thread visits holds
  // these channels
  e.load(conv_bias, mean, inv, bn_bias, scale, scale_bias, (int)(v % cvec) * E::N);
  uint4* o = reinterpret_cast<uint4*>(out);
  Vec16<T> r0, r1;
  for (; v + stride < nvec; v += 2 * stride) {
    const Vec16<T> y0 = load16(y, v), y1 = load16(y, v + stride);
    if constexpr (RES) {
      r0 = load16(shortcut, v);
      r1 = load16(shortcut, v + stride);
    }
    o[v] = e.apply(y0, r0).raw;
    o[v + stride] = e.apply(y1, r1).raw;
  }
  if (v < nvec) {
    const Vec16<T> y0 = load16(y, v);
    if constexpr (RES) r0 = load16(shortcut, v);
    o[v] = e.apply(y0, r0).raw;
  }
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

template <typename T, bool BIAS, bool SCALE, bool RES, bool RELU>
int launch(const void* y, const void* conv_bias, const void* mean, const void* inv,
           const void* bn_bias, const void* scale, const void* scale_bias, const void* shortcut,
           void* out, int64_t n, int c, cudaStream_t stream) {
  auto kernel = frozen_epilogue_kernel<T, BIAS, SCALE, RES, RELU>;
  static int per_sm = 0;  // resident blocks an SM: the same on every card of a host
  cudaError_t err;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int N = Vec16<T>::N;
  const int64_t nvec = n / N;
  const int cvec = c / N;
  int64_t blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  // round the grid's threads up to a multiple of cvec (see the kernel)
  const int64_t q = cvec / gcd_int(cvec, THREADS);
  blocks = (blocks + q - 1) / q * q;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)y, (const T*)conv_bias, (const float*)mean, (const float*)inv,
      (const float*)bn_bias, (const float*)scale, (const float*)scale_bias, (const T*)shortcut,
      (T*)out, nvec, cvec);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, void*, int64_t, int, cudaStream_t);

template <typename T, int I>
constexpr Launch variant() {
  return launch<T, (I & 1) != 0, (I & 2) != 0, (I & 4) != 0, (I & 8) != 0>;
}

template <typename T>
int dispatch(const void* y, const void* conv_bias, const void* mean, const void* inv,
             const void* bn_bias, const void* scale, const void* scale_bias,
             const void* shortcut, void* out, long long n, int c, int relu, void* stream) {
  static const Launch table[16] = {
      variant<T, 0>(),  variant<T, 1>(),  variant<T, 2>(),  variant<T, 3>(),
      variant<T, 4>(),  variant<T, 5>(),  variant<T, 6>(),  variant<T, 7>(),
      variant<T, 8>(),  variant<T, 9>(),  variant<T, 10>(), variant<T, 11>(),
      variant<T, 12>(), variant<T, 13>(), variant<T, 14>(), variant<T, 15>()};
  const int i = (conv_bias != nullptr) | (scale != nullptr) << 1 | (shortcut != nullptr) << 2 |
                (relu != 0) << 3;
  return table[i](y, conv_bias, mean, inv, bn_bias, scale, scale_bias, shortcut, out, n, c,
                  (cudaStream_t)stream);
}

}  // namespace

// y, shortcut and out: n elements of (..., c) NHWC, 16-byte aligned, c a
// multiple of the 16-byte vector; conv_bias (c,) of the map's dtype; mean,
// inv, bn_bias, scale, scale_bias (c,) f32. A null conv_bias, scale (with
// scale_bias) or shortcut leaves its step out.
extern "C" int frcnn_frozen_epilogue_bf16(const void* y, const void* conv_bias, const void* mean,
                                          const void* inv, const void* bn_bias, const void* scale,
                                          const void* scale_bias, const void* shortcut, void* out,
                                          long long n, int c, int relu, void* stream) {
  return dispatch<__nv_bfloat16>(y, conv_bias, mean, inv, bn_bias, scale, scale_bias, shortcut,
                                 out, n, c, relu, stream);
}

extern "C" int frcnn_frozen_epilogue_f32(const void* y, const void* conv_bias, const void* mean,
                                         const void* inv, const void* bn_bias, const void* scale,
                                         const void* scale_bias, const void* shortcut, void* out,
                                         long long n, int c, int relu, void* stream) {
  return dispatch<float>(y, conv_bias, mean, inv, bn_bias, scale, scale_bias, shortcut, out, n, c,
                         relu, stream);
}
