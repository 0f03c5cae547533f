// Hand-written Hopper (sm_90a) kernel for the min-sum contraction of
// k-reciprocal re-ranking:
//
//   t[i, j] = sum_c min(a[i, c] * sa[i], b[j, c] * sb[j])      (fp32 out)
//
// Replaces tpu_reid/ops/minsum.py::minsum_tiled (Pallas kernel
// _minsum_kernel). The operands are row-quantized: fp8 e4m3fn, bf16 or fp32
// values with one fp32 scale per row; each value is dequantized once, when
// its tile is staged, with the same single fp32 product as the plain version
// (ops/minsum.py::minsum_reference), so only the order of the fp32 sums
// differs from it.
//
// What bounds it on the H100: min is no product, so the tensor cores cannot
// help. Every (i, j, c) costs one fminf and one fadd on the CUDA cores:
// 2 * Na * Nb * C instructions over 132 SMs x 128 fp32 lanes x 1.98 GHz
// = 33.5e12 per second. The operands are re-read once per output tile and
// do not bind: each staged value feeds 2 * 128 * 64 / 192 = 85 instructions.
// Design: one block of 256 threads owns a 128x64 output tile and walks C in
// steps of 32. Each step stages the a and b tiles, dequantized, as fp32 in
// shared memory laid out C-major (16-byte vector loads of 16 fp8, 8 bf16 or
// 4 fp32 values when the rows allow them, element loads otherwise). Each
// thread owns an 8x4 micro-tile (rows {4ty..4ty+3, 64+4ty..}, columns
// {4tx..4tx+3}, so the shared-memory reads of a quarter warp are
// contiguous) and does one fminf and one fadd per element per C value into
// a partial sum that is added to the running total once per step: the fp32
// sum is two levels of 32 and C/32 terms, not one chain of C (at C = 20480
// the one chain was measured 4.3e-5 off the plain version, relative to its
// max). The output is stored once at the end: no read-modify-write across C
// steps. Ragged edges are bounds-checked; past the end of C the a tile holds
// +FLT_MAX and the b tile 0, so min() adds exactly 0 whatever the sign of
// the data.

#include <cfloat>
#include <cuda_fp8.h>

#include "common.cuh"

typedef __nv_fp8_e4m3 fp8;

__device__ __forceinline__ float to_f(fp8 v) { return static_cast<float>(v); }

namespace {

// operand dtype codes of this library's entry point (its own, fp8 included)
constexpr int OPERAND_F32 = 0, OPERAND_BF16 = 1, OPERAND_FP8_E4M3 = 2;

constexpr int TM = 128;      // output rows per block
constexpr int TN = 64;       // output columns per block
constexpr int TK = 32;       // C values per step
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 4 outputs each

// Stage rows [r0, r0 + ROWS) x C values [c0, c0 + TK) of src, dequantized,
// into dst[k][r]. Rows past R load as 0 (their outputs are never stored); C
// values past C load as `pad`.
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           const float* __restrict__ scale,
                                           float (*dst)[ROWS], int r0, int R, int c0,
                                           int C, float pad, int tid) {
  if constexpr (VEC) {
    // C % VE == 0 and src is 16-byte aligned: a vector is all in or all out
    constexpr int VE = 16 / sizeof(T);
    constexpr int TOTAL = ROWS * (TK / VE);
#pragma unroll
    for (int v = tid; v < TOTAL; v += THREADS) {
      const int r = v % ROWS, part = v / ROWS;  // a warp covers 32 rows
      const int row = r0 + r, c = c0 + part * VE;
      float f[VE];
      if (row < R && c < C) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)row * C + c);
        const T* e = reinterpret_cast<const T*>(&u);
        const float s = scale[row];
#pragma unroll
        for (int i = 0; i < VE; ++i) f[i] = to_f(e[i]) * s;
      } else {
        const float fill = row < R ? pad : 0.f;
#pragma unroll
        for (int i = 0; i < VE; ++i) f[i] = fill;
      }
#pragma unroll
      for (int i = 0; i < VE; ++i) dst[part * VE + i][r] = f[i];
    }
  } else {
#pragma unroll
    for (int e = tid; e < ROWS * TK; e += THREADS) {
      const int r = e % ROWS, k = e / ROWS;
      const int row = r0 + r, c = c0 + k;
      float f = 0.f;
      if (row < R) f = c < C ? to_f(src[(size_t)row * C + c]) * scale[row] : pad;
      dst[k][r] = f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
minsum_kernel(const T* __restrict__ a, const float* __restrict__ sa,
              const T* __restrict__ b, const float* __restrict__ sb,
              float* __restrict__ out, int Na, int Nb, int C) {
  __shared__ __align__(16) float As[TK][TM];
  __shared__ __align__(16) float Bs[TK][TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += TK) {
    stage_tile<T, VEC, TM>(a, sa, As, row0, Na, c0, C, FLT_MAX, tid);
    stage_tile<T, VEC, TN>(b, sb, Bs, col0, Nb, c0, C, 0.f, tid);
    __syncthreads();
    float part[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float av[8], bv[4];
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] += fminf(av[i], bv[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  const int col = col0 + tx * 4;
  const bool vec_out = Nb % 4 == 0 && col + 4 <= Nb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= Na) continue;
    float* o = out + (size_t)row * Nb + col;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < Nb) o[j] = acc[i][j];
    }
  }
}

template <typename T>
int launch_minsum(const void* a, const float* sa, const void* b, const float* sb,
                  float* out, int Na, int Nb, int C, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  const bool vec = C % VE == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((Nb + TN - 1) / TN, (Na + TM - 1) / TM);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (vec)
    minsum_kernel<T, true><<<grid, THREADS, 0, stream>>>(ta, sa, tb, sb, out, Na, Nb, C);
  else
    minsum_kernel<T, false><<<grid, THREADS, 0, stream>>>(ta, sa, tb, sb, out, Na, Nb, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (Na, C), b (Nb, C) row-major in the operand type `dtype`; sa (Na,),
// sb (Nb,) fp32 row scales; out (Na, Nb) fp32. Na, Nb > 0.
int minsum(const void* a, const void* sa, const void* b, const void* sb, void* out,
           int Na, int Nb, int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fsa = static_cast<const float*>(sa);
  const float* fsb = static_cast<const float*>(sb);
  float* o = static_cast<float*>(out);
  if (Na <= 0 || Nb <= 0 || C < 0 || (Na + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == OPERAND_FP8_E4M3)
    return launch_minsum<fp8>(a, fsa, b, fsb, o, Na, Nb, C, st);
  if (dtype == OPERAND_BF16) return launch_minsum<bf16>(a, fsa, b, fsb, o, Na, Nb, C, st);
  if (dtype == OPERAND_F32) return launch_minsum<float>(a, fsa, b, fsb, o, Na, Nb, C, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
