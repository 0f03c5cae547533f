// Hand-written Hopper (sm_90a) kernels for the CLS tail: ln_post + proj.
//
// Replaces tpu_reid/ops/fused_tail.py::_tail_pallas (Pallas kernel
// _tail_kernel). Per CLS row: LayerNorm with fp32 statistics and an fp32
// affine, y cast to the working type and stored, then p = y @ proj with fp32
// accumulation from the rounded y, cast. (The Pallas kernel rounds the LN
// affine to the working type first; these kernels follow the plain
// composition _tail_xla instead.)
//
// What bounds it on the H100: at the main path's (128, 768) x (768, 512) the
// work is 0.1 GFLOP over ~1.3 MB of operands, well under a microsecond at
// either peak, so the kernel's time is latency: how long one block takes from
// its first load to its last store, since a few dozen blocks fill no card.
//
// bf16, ln_proj_tail_bf16_kernel: one block of two warpgroups per (32 rows,
// 64 output columns): 32 blocks at B=128 and 128 at B=512, one wave of the
// card's 132 SMs. Thread 0 of each warpgroup asks TMA at once for its share
// of the block's (D, 64) slice of proj, as it is stored, into a ring of
// twelve [64 k-rows][128 bytes] swizzled stages (the whole slice for D <= 768;
// a wider D refills a stage once the wgmmas that read it are done). Meanwhile
// the eight warps normalise four rows each, all four in flight together,
// round to bf16 and write the row panel in the swizzled layout wgmma reads;
// the blocks of the first column tile also store y. A wgmma tile has 64 rows:
// the panel's upper 32 are left as they are, since a row of the product
// depends on no other row, and their sums are never stored. Then the
// warpgroups split the K blocks of 64 between them (even and odd), each a
// chain of wgmma m64n64k16 steps with A and B from shared memory, and add
// their two fp32 partial sums through shared memory (over the panel, which
// nobody reads any more). The product runs on the tensor cores and proj
// arrives in bulk.
//
// fp32 (and what the bf16 kernel does not take: D not a multiple of 64, E not
// a multiple of 8), ln_proj_tail_kernel: one block per (16 rows, 128 output
// columns); the 16 normalised rows stay in shared memory as fp32 copies of
// the rounded values, each thread owns one output column and walks proj's
// rows with plain FMA. It was the bf16 path too before the kernel above, and
// is timed beside it as such.
//
// Measured times stand in PERF.md.

#include "hopper.cuh"

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

// ---- bf16: LayerNorm panel in shared memory, proj by TMA, wgmma ------------

constexpr int TW_ROWS = 32;       // rows of x per block: the lower half of the wgmma tile
constexpr int TW_COLS = 64, TW_THREADS = 256;
constexpr int TW_KB = 64 * 128;   // one K block: [64 rows][128 bytes], panel or proj slice
constexpr int TW_STAGES = 12;     // proj K blocks in flight: all of D = 768
constexpr int TW_MAX_D = 1024;    // 16 panel blocks and the ring fill the SM's shared memory
constexpr int TW_NV = TW_MAX_D / 256;  // 16-byte chunks of a row per lane

__host__ __device__ constexpr int tail_bf16_smem(int D) {
  // 1024 for the alignment of the base; the panel; the ring; its barriers
  return 1024 + D / 64 * TW_KB + TW_STAGES * TW_KB + 8 * TW_STAGES;
}

__global__ void __launch_bounds__(TW_THREADS, 1)
ln_proj_tail_bf16_kernel(const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ x,
                         const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                         bf16* __restrict__ y, bf16* __restrict__ p, int B, int D, int E) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* panel = smem_raw + (base - raw);
  const int nkb = D / 64, nchunks = D / 8;
  const uint32_t ring = base + nkb * TW_KB, full = ring + TW_STAGES * TW_KB;
  const int n0 = blockIdx.x * TW_COLS, m0 = blockIdx.y * TW_ROWS;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TW_STAGES; ++s) mbar_init(full + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // K block kb of the proj slice (rows 64 kb .., columns n0 ..; columns past E
  // arrive as zeros) into stage kb % TW_STAGES. Warpgroup w takes the blocks
  // kb = w, w + 2, ...: a stage (TW_STAGES is even) belongs to one warpgroup.
  auto fetch = [&](int kb) {
    const int s = kb % TW_STAGES;
    mbar_arrive_expect_tx(full + 8 * s, TW_KB);
    tma_load_2d(ring + s * TW_KB, &map_w, full + 8 * s, n0, 64 * kb);
  };
  if (tid == 0)
    for (int kb = wg; kb < nkb && kb < TW_STAGES; kb += 2) fetch(kb);

  // ---- LayerNorm: warp w of 8 takes rows 4w .. 4w + 3, all four in flight at
  // once and each step of their chains (loads, the two reductions, the
  // affine) taken for the four together, since a block has too few warps to
  // hide one row's latencies under another warp's work. A lane owns the
  // 16-byte chunks lane, lane + 32, ... of every row, so its gamma and beta
  // stay in registers. Two-pass fp32 statistics; rows past B are zero.
  {
    constexpr int RG = TW_ROWS / 8;
    const int r0 = (wg * 4 + warp) * RG;
    uint4 u[RG][TW_NV];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      const int m = m0 + r0 + rr;
#pragma unroll
      for (int i = 0; i < TW_NV; ++i) {
        const int c = lane + 32 * i;
        u[rr][i] = (m < B && c < nchunks)
                       ? *reinterpret_cast<const uint4*>(x + (size_t)m * D + 8 * c)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float gm[TW_NV][8], bt[TW_NV][8];
#pragma unroll
    for (int i = 0; i < TW_NV; ++i) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (c < nchunks) {
          a = *reinterpret_cast<const float4*>(ln_g + 8 * c + e);
          b = *reinterpret_cast<const float4*>(ln_b + 8 * c + e);
        }
        gm[i][e] = a.x, gm[i][e + 1] = a.y, gm[i][e + 2] = a.z, gm[i][e + 3] = a.w;
        bt[i][e] = b.x, bt[i][e + 1] = b.y, bt[i][e + 2] = b.z, bt[i][e + 3] = b.w;
      }
    }
    auto sum4 = [](float (&t)[RG]) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) t[rr] += __shfl_xor_sync(0xffffffffu, t[rr], o);
    };
    float mean[RG], rstd[RG];
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      mean[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < TW_NV; ++i) {
        float f[8];
        unpack_vec<bf16>(u[rr][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) mean[rr] += f[e];
      }
    }
    sum4(mean);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      mean[rr] /= D;
      rstd[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < TW_NV; ++i) {
        if (lane + 32 * i >= nchunks) continue;
        float f[8];
        unpack_vec<bf16>(u[rr][i], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) rstd[rr] += (f[e] - mean[rr]) * (f[e] - mean[rr]);
      }
    }
    sum4(rstd);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      rstd[rr] = rsqrtf(rstd[rr] / D + 1e-5f);
      const int r = r0 + rr, m = m0 + r;
#pragma unroll
      for (int i = 0; i < TW_NV; ++i) {
        const int c = lane + 32 * i;
        if (c >= nchunks) continue;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (m < B) {
          float f[8];
          unpack_vec<bf16>(u[rr][i], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean[rr]) * rstd[rr] * gm[i][e] + bt[i][e];
          packed = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                              pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
          if (blockIdx.x == 0) *reinterpret_cast<uint4*>(y + (size_t)m * D + 8 * c) = packed;
        }
        *reinterpret_cast<uint4*>(panel + (size_t)(c >> 3) * TW_KB + r * 128 +
                                  (((c & 7) ^ (r & 7)) << 4)) = packed;
      }
    }
  }
  fence_proxy_async();
  __syncthreads();

  // ---- p tile = panel @ proj slice: this warpgroup's K blocks ----------------
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
  for (int kb = wg; kb < nkb; kb += 2) {
    const int s = kb % TW_STAGES;
    mbar_wait(full + 8 * s, (kb / TW_STAGES) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_m64n64k16_tb(acc, wgmma_desc(base + kb * TW_KB + 32 * j, 16, 1024),
                         wgmma_desc(ring + s * TW_KB + 2048 * j, 16, 1024), 1);
    wgmma_commit();
    if (nkb > TW_STAGES && kb >= 2) {
      // the K block before this one has been read: its stage takes the block
      // TW_STAGES further on
      wgmma_wait<1>();
      if (tid == 0 && kb - 2 + TW_STAGES < nkb) fetch(kb - 2 + TW_STAGES);
    }
  }
  wgmma_wait<0>();
  wgmma_settle(acc);

  // ---- the two partial sums, cast, 16-byte stores ----------------------------
  __syncthreads();  // nobody reads the panel any more
  float* red = reinterpret_cast<float*>(panel);  // [32][128]
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * 128 + tid] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += red[i * 128 + tid];
  const int g = lane >> 2, q = lane & 3;
  if (16 * warp >= TW_ROWS) return;  // accumulator rows the panel does not hold
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = m0 + 16 * warp + g + 8 * hr;
#pragma unroll
    for (int j0 = 0; j0 < TW_COLS / 8; j0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_bf16(acc[4 * (j0 + i) + 2 * hr], acc[4 * (j0 + i) + 2 * hr + 1]);
      quad_transpose(v, q);
      const int n = n0 + 8 * (j0 + q);
      if (m < B && n < E)
        *reinterpret_cast<uint4*>(p + (size_t)m * E + n) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

int launch_tail_bf16(const void* x, const float* ln_g, const float* ln_b, const void* proj,
                     void* y, void* p, int B, int D, int E, cudaStream_t stream) {
  if (B == 0) return 0;
  if (D <= 0 || D % 64 != 0 || D > TW_MAX_D || E <= 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_w;  // proj (D, E) row-major, box of 64 K rows x 64 columns
  const uint64_t dims[2] = {(uint64_t)E, (uint64_t)D};
  const uint64_t strides[1] = {(uint64_t)E * sizeof(bf16)};
  const uint32_t box[2] = {(uint32_t)TW_COLS, 64u};
  int rc = encode_bf16_map(&map_w, proj, 2, dims, strides, box);
  if (rc != 0) return rc;
  const int smem = tail_bf16_smem(D);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_tail_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((E + TW_COLS - 1) / TW_COLS, (B + TW_ROWS - 1) / TW_ROWS);
  ln_proj_tail_bf16_kernel<<<grid, TW_THREADS, smem, stream>>>(
      map_w, static_cast<const bf16*>(x), ln_g, ln_b, static_cast<bf16*>(y),
      static_cast<bf16*>(p), B, D, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D), proj (D, E), y (B, D), p (B, E) in the working type; ln_g/ln_b
// (D,) fp32. fma != 0: the FMA kernel whatever the type (fp32 always takes it).
int ln_proj_tail(const void* x, const void* ln_g, const void* ln_b, const void* proj,
                 void* y, void* p, int B, int D, int E, int dtype, int fma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  if (dtype == DTYPE_BF16)
    return fma ? launch_tail<bf16>(x, g, b, proj, y, p, B, D, E, st)
               : launch_tail_bf16(x, g, b, proj, y, p, B, D, E, st);
  if (dtype == DTYPE_F32) return launch_tail<float>(x, g, b, proj, y, p, B, D, E, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
