// Element helpers shared by the kernels in this directory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// the `dtype` argument of every C entry point
constexpr int DTYPE_F32 = 0, DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// One 16-byte vector of T: 8 bf16 or 4 float.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* f) {
  unpack_vec<T>(*reinterpret_cast<const uint4*>(src), f);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* f) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(f[i]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
