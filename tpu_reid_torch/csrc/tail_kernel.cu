// Hand-written Hopper (sm_90a) kernel for the CLS tail: ln_post + proj.
//
// Replaces tpu_reid/ops/fused_tail.py::_tail_pallas (Pallas kernel
// _tail_kernel). Per CLS row: LayerNorm with fp32 statistics and an fp32
// affine, y cast to the working type and stored, then p = y @ proj with fp32
// accumulation, cast. (The Pallas kernel rounds the LN affine to the working
// type first; this kernel follows the plain composition _tail_xla instead.)
//
// What bounds it on the H100: at the main path's (128, 768) x (768, 512) per
// pass the work is 0.1 GFLOP over ~1.3 MB of operands, well under a
// microsecond at either peak, so launch latency and a single partial wave of
// blocks dominate. Design: one block per
// (16 rows, 128 output columns); the 16 normalised rows stay in shared memory
// as fp32 copies of the rounded values, each thread owns one output column and
// walks proj's rows (coalesced across the block) with plain FMA. Only the
// blocks of the first column tile store y.

#include "common.cuh"

namespace {

constexpr int TB = 16, TAIL_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
ln_proj_tail_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                    const float* __restrict__ ln_b, const T* __restrict__ proj,
                    T* __restrict__ y, T* __restrict__ p, int B, int D, int E) {
  extern __shared__ __align__(16) float ys[];  // [TB][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * TB;

  for (int r = warp; r < TB; r += TAIL_THREADS / 32) {
    const int row = row0 + r;
    float* yr = ys + r * D;
    if (row >= B) {
      for (int c = lane; c < D; c += 32) yr[c] = 0.f;
      continue;
    }
    const T* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float v = to_f(xr[c]);
      yr[c] = v;
      s += v;
    }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = yr[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
    for (int c = lane; c < D; c += 32) {
      const T t = from_f<T>((yr[c] - mean) * rstd * ln_g[c] + ln_b[c]);
      yr[c] = to_f(t);
      if (blockIdx.x == 0) y[(size_t)row * D + c] = t;
    }
  }
  __syncthreads();

  const int e = blockIdx.x * TAIL_THREADS + tid;
  if (e >= E) return;
  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;
  for (int k = 0; k < D; ++k) {
    const float w = to_f(proj[(size_t)k * E + e]);
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = fmaf(ys[r * D + k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < TB; ++r)
    if (row0 + r < B) p[(size_t)(row0 + r) * E + e] = from_f<T>(acc[r]);
}

template <typename T>
int launch_tail(const void* x, const float* ln_g, const float* ln_b, const void* proj,
                void* y, void* p, int B, int D, int E, cudaStream_t stream) {
  const int bytes = TB * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((E + TAIL_THREADS - 1) / TAIL_THREADS, (B + TB - 1) / TB);
  ln_proj_tail_kernel<T><<<grid, TAIL_THREADS, bytes, stream>>>(
      static_cast<const T*>(x), ln_g, ln_b, static_cast<const T*>(proj), static_cast<T*>(y),
      static_cast<T*>(p), B, D, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D), proj (D, E), y (B, D), p (B, E) in the working type; ln_g/ln_b
// (D,) fp32.
int ln_proj_tail(const void* x, const void* ln_g, const void* ln_b, const void* proj,
                 void* y, void* p, int B, int D, int E, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  if (dtype == DTYPE_BF16) return launch_tail<bf16>(x, g, b, proj, y, p, B, D, E, st);
  if (dtype == DTYPE_F32) return launch_tail<float>(x, g, b, proj, y, p, B, D, E, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
