// Shared helpers for the port's CUDA kernels (plain C interface, bound with
// ctypes from faster_rcnn_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T as one vector: 8 bf16 or 4 f32. (No union: __nv_bfloat16 has
// a non-trivial constructor.)
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(&raw); }
  __device__ __forceinline__ const T* v() const { return reinterpret_cast<const T*>(&raw); }
};
