// Hand-written Hopper (sm_90a) kernels for the CLS tail: ln_post + proj.
//
// Replaces tpu_reid/ops/fused_tail.py::_tail_pallas (Pallas kernel
// _tail_kernel). Per CLS row: LayerNorm with fp32 statistics and an fp32
// affine (epsilon an argument: CLIP's 1e-5, EVA02's 1e-6), y cast to the
// working type and stored, then p = y @ proj with fp32 accumulation from the
// rounded y, plus the head's fp32 bias where it has one (EVA02), cast. (The Pallas kernel rounds the LN
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
// the blocks of the first column tile also store y. The panel holds the
// block's 32 rows per K block of 64 ([32 rows][128 bytes], 4 KB), so D up to
// 2048 (EVA02-CLIP-E/14's 1792) fits beside the ring. A wgmma tile has 64
// rows: its upper 32 read whatever lies 4 KB further on (the next K block's
// rows, or the ring's first stage after the last one), which is harmless,
// since a row of the product depends on no other row and those rows' sums
// are never stored. A lane holds NV 16-byte chunks of each row in flight
// (NV = 4 up to D = 1024, four rows at once; NV = 8 up to 2048, two rows at
// once, with gamma and beta read in the last pass instead of held in
// registers beside the rows, so neither instance spills). Then the
// warpgroups split the K blocks of 64 between them (even and odd), each a
// chain of wgmma m64n64k16 steps with A and B from shared memory, and add
// their two fp32 partial sums through shared memory (over the panel, which
// nobody reads any more). The product runs on the tensor cores and proj
// arrives in bulk.
//
// fp32, ln_proj_tail_tf32x3_kernel: every product fp32-accurate by 3xTF32 on
// wgmma (each operand split once into hi = tf32(x), lo = tf32(x - hi); per
// k8 step lo*hi + hi*lo + hi*hi into one fp32 accumulator), as the fp32 block
// kernels do. 64 x 64 output tiles alone would give 8 blocks at the training
// shape (B=64, E=512), so K is split too: a cluster of 8 blocks shares one
// (64 rows, 64 columns) tile, each block taking 1/8 of D (96 columns at
// D = 768): 64 blocks at B=64, 128 at B=128, two to an SM. Thread 0 asks TMA
// at once for the block's (K slice, 64 columns) of proj, as it is stored;
// meanwhile two warpgroups normalise their rows' K slice. The statistics are
// over the whole row, two-pass: each pass's partial sums are stored into
// every block of the cluster (st.async, counted on the receiver's mbarrier),
// and every block adds the eight in rank order. tf32 wgmma reads shared
// operands K-major only and proj is stored N-major, so the operands are
// swapped: p^T = proj^T y^T, proj^T from registers (a thread may load any
// layout: one 8-byte load per two A values), the split y panel as the B
// operand (its rows are K-contiguous, K-major as written), N = 64 rows; the
// warpgroups take half of the k8 steps each. Their two partial tiles are
// added in shared memory, and the eight blocks' tiles through the other
// blocks' shared memory in rank order, each block storing an eighth of the
// tile's rows: no atomics, the same bits on every launch. What the time goes
// to is a chain of latencies (x's loads, two exchanges, the product, one
// exchange), not bytes or operations: PERF.md has the breakdown.
//
// ln_proj_tail_kernel, the FMA kernel (both types, outside the wgmma kernels'
// domains: bf16 D not a multiple of 64 or E not of 8, fp32 D not a multiple of
// 32 or past 1024 or E not of 4, a base off 16 bytes): one block per (16 rows, 128 output
// columns); the 16 normalised rows stay in shared memory as fp32 copies of
// the rounded values, each thread owns one output column and walks proj's
// rows with plain FMA. It was the route of both types before the wgmma
// kernels, and is timed beside them as such.
//
// Measured times stand in PERF.md.

#include "hopper.cuh"

namespace {

constexpr int TB = 16, TAIL_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
ln_proj_tail_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                    const float* __restrict__ ln_b, const T* __restrict__ proj,
                    const float* __restrict__ bias, T* __restrict__ y, T* __restrict__ p, int B,
                    int D, int E, float eps) {
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
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
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
  for (int r = 0; r < TB; ++r) {
    float v = acc[r];
    if (bias != nullptr) v += bias[e];
    if (row0 + r < B) p[(size_t)(row0 + r) * E + e] = from_f<T>(v);
  }
}

template <typename T>
int launch_tail(const void* x, const float* ln_g, const float* ln_b, const void* proj,
                const float* bias, void* y, void* p, int B, int D, int E, float eps,
                cudaStream_t stream) {
  const int bytes = TB * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((E + TAIL_THREADS - 1) / TAIL_THREADS, (B + TB - 1) / TB);
  ln_proj_tail_kernel<T><<<grid, TAIL_THREADS, bytes, stream>>>(
      static_cast<const T*>(x), ln_g, ln_b, static_cast<const T*>(proj), bias,
      static_cast<T*>(y), static_cast<T*>(p), B, D, E, eps);
  return (int)cudaGetLastError();
}

// ---- bf16: LayerNorm panel in shared memory, proj by TMA, wgmma ------------

constexpr int TW_ROWS = 32;       // rows of x per block: the lower half of the wgmma tile
constexpr int TW_COLS = 64, TW_THREADS = 256;
constexpr int TW_KB = 64 * 128;   // one K block of the proj slice: [64 rows][128 bytes]
constexpr int TW_PB = TW_ROWS * 128;  // one K block of the panel: [32 rows][128 bytes]
constexpr int TW_STAGES = 12;     // proj K blocks in flight: all of D = 768
constexpr int TW_MAX_D = 2048;    // 32 panel blocks and the ring fill the SM's shared memory
constexpr int TW_NV_NARROW = 4;   // 16-byte chunks of a row per lane up to D = 1024

__host__ __device__ constexpr int tail_bf16_smem(int D) {
  // 1024 for the alignment of the base; the panel; the ring; its barriers
  return 1024 + D / 64 * TW_PB + TW_STAGES * TW_KB + 8 * TW_STAGES;
}
static_assert(tail_bf16_smem(TW_MAX_D) <= 232448, "the widest row's panel fits a block");

// NV: 16-byte chunks of a row per lane (D <= 256 NV); RG: rows of a warp in
// flight at once (of its TW_ROWS / 8)
template <int NV, int RG>
__global__ void __launch_bounds__(TW_THREADS, 1)
ln_proj_tail_bf16_kernel(const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ x,
                         const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                         const float* __restrict__ bias, bf16* __restrict__ y,
                         bf16* __restrict__ p, int B, int D, int E, float eps) {
  constexpr bool GB_REGS = NV <= TW_NV_NARROW;  // gamma and beta held in registers
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* panel = smem_raw + (base - raw);
  const int nkb = D / 64, nchunks = D / 8;
  const uint32_t ring = base + nkb * TW_PB, full = ring + TW_STAGES * TW_KB;
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

  // ---- LayerNorm: warp w of 8 takes rows 4w .. 4w + 3, RG of them in flight at
  // once (all four up to D = 1024; two and two past it, where four rows of
  // NV = 8 chunks would not fit the registers) and each step of their chains
  // (loads, the two reductions, the affine) taken for those together, since a
  // block has too few warps to hide one row's latencies under another warp's
  // work. A lane owns the 16-byte chunks lane, lane + 32, ... of every row, so
  // its gamma and beta stay in registers (up to D = 1024). Two-pass fp32
  // statistics; rows past B are zero.
  {
    constexpr int RW = TW_ROWS / 8;  // rows of a warp
    static_assert(RW % RG == 0, "a warp's rows in whole groups");
    // gamma and beta of chunk i, 8 values each
    auto load_gb = [&](int i, float (&g)[8], float (&b)[8]) {
      const int c = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bb = a;
        if (c < nchunks) {
          a = *reinterpret_cast<const float4*>(ln_g + 8 * c + e);
          bb = *reinterpret_cast<const float4*>(ln_b + 8 * c + e);
        }
        g[e] = a.x, g[e + 1] = a.y, g[e + 2] = a.z, g[e + 3] = a.w;
        b[e] = bb.x, b[e + 1] = bb.y, b[e + 2] = bb.z, b[e + 3] = bb.w;
      }
    };
    float gm[GB_REGS ? NV : 1][8], bt[GB_REGS ? NV : 1][8];
    if constexpr (GB_REGS) {
#pragma unroll
      for (int i = 0; i < NV; ++i) load_gb(i, gm[i], bt[i]);
    }
    auto sum4 = [](float (&t)[RG]) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) t[rr] += __shfl_xor_sync(0xffffffffu, t[rr], o);
    };
#pragma unroll
    for (int rh = 0; rh < RW; rh += RG) {
      const int r0 = (wg * 4 + warp) * RW + rh;
      uint4 u[RG][NV];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int m = m0 + r0 + rr;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = lane + 32 * i;
          u[rr][i] = (m < B && c < nchunks)
                         ? *reinterpret_cast<const uint4*>(x + (size_t)m * D + 8 * c)
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
      float mean[RG], rstd[RG];
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        mean[rr] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
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
        for (int i = 0; i < NV; ++i) {
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
        rstd[rr] = rsqrtf(rstd[rr] / D + eps);
        const int r = r0 + rr, m = m0 + r;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = lane + 32 * i;
          if (c >= nchunks) continue;
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);
          if (m < B) {
            float f[8], g[8], b[8];
            if constexpr (GB_REGS) {
#pragma unroll
              for (int e = 0; e < 8; ++e) g[e] = gm[i][e], b[e] = bt[i][e];
            } else {
              load_gb(i, g, b);
            }
            unpack_vec<bf16>(u[rr][i], f);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean[rr]) * rstd[rr] * g[e] + b[e];
            packed = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
            if (blockIdx.x == 0) *reinterpret_cast<uint4*>(y + (size_t)m * D + 8 * c) = packed;
          }
          *reinterpret_cast<uint4*>(panel + (size_t)(c >> 3) * TW_PB + r * 128 +
                                    (((c & 7) ^ (r & 7)) << 4)) = packed;
        }
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
      wgmma_m64n64k16_tb(acc, wgmma_desc(base + kb * TW_PB + 32 * j, 16, 1024),
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
      for (int i = 0; i < 4; ++i) {
        float a0 = acc[4 * (j0 + i) + 2 * hr], a1 = acc[4 * (j0 + i) + 2 * hr + 1];
        // the head's bias of columns nc, nc + 1 (E % 8 == 0: both or neither below E)
        const int nc = n0 + 8 * (j0 + i) + 2 * q;
        if (bias != nullptr && nc < E) a0 += bias[nc], a1 += bias[nc + 1];
        v[i] = pack_bf16(a0, a1);
      }
      quad_transpose(v, q);
      const int n = n0 + 8 * (j0 + q);
      if (m < B && n < E)
        *reinterpret_cast<uint4*>(p + (size_t)m * E + n) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

int launch_tail_bf16(const void* x, const float* ln_g, const float* ln_b, const void* proj,
                     const float* bias, void* y, void* p, int B, int D, int E, float eps,
                     cudaStream_t stream) {
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
  auto kernel = D <= 256 * TW_NV_NARROW ? ln_proj_tail_bf16_kernel<TW_NV_NARROW, TW_ROWS / 8>
                                        : ln_proj_tail_bf16_kernel<TW_MAX_D / 256, TW_ROWS / 16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((E + TW_COLS - 1) / TW_COLS, (B + TW_ROWS - 1) / TW_ROWS);
  kernel<<<grid, TW_THREADS, smem, stream>>>(map_w, static_cast<const bf16*>(x), ln_g, ln_b,
                                             bias, static_cast<bf16*>(y), static_cast<bf16*>(p),
                                             B, D, E, eps);
  return (int)cudaGetLastError();
}

// ---- fp32: 3xTF32 on wgmma, K split over a cluster of 8 blocks ---------------

constexpr int TF_RANKS = 8;      // blocks of a cluster: each takes 1/8 of the K blocks
constexpr int TF_ROWS = 64;      // rows of x per block: the wgmma's N
constexpr int TF_COLS = 64;      // columns of p per block: the wgmma's M (rows of proj^T)
constexpr int TF_THREADS = 256;  // two warpgroups: each takes half of the rank's k8 steps
constexpr int TF_KB = 32;        // one K block: 32 fp32 = one 128-byte swizzle row
constexpr int TF_MAX_D = 1024;   // a lane of a rank owns one 16-byte chunk of its columns
constexpr int TF_MAX_KB = (TF_MAX_D / TF_KB + TF_RANKS - 1) / TF_RANKS;  // K blocks of a rank
constexpr int TF_PROJ_TILE = TF_KB * 128;  // 4 KB: 32 K rows x 32 columns of proj, as stored
constexpr int TF_TILE = TF_ROWS * 128;     // 8 KB: 64 rows x 32 K of y, K-major, hi or lo
constexpr int TF_KB_BYTES = 2 * TF_PROJ_TILE + 2 * TF_TILE;  // per K block: proj; y split
constexpr int TF_SLAB = TF_ROWS / TF_RANKS;  // rows of the tile that one rank sums and stores
constexpr int TF_RED = TF_RANKS * TF_SLAB * TF_COLS * 4;  // 16 KB: the 8 ranks' slabs
constexpr int TF_SUMS = 2 * TF_RANKS * TF_ROWS * 4;       // 4 KB: 8 ranks' row sums, 2 passes
constexpr int TF_RW = TF_ROWS / (TF_THREADS / 32);        // rows per warp in the LayerNorm

__host__ __device__ constexpr int tail_tf32_smem(int kb_max) {
  // 1024 for the alignment of the base; per K block of the rank its proj
  // slice and the split y tiles; the partial slabs; the row sums; four barriers
  return 1024 + kb_max * TF_KB_BYTES + TF_RED + TF_SUMS + 4 * 8;
}
static_assert(tail_tf32_smem(TF_MAX_KB) <= 232448, "the widest row's slices fit a block");

// t[i]: this lane's partial sum of row row0 + i of its warp. Returns the
// warp's total of row (lane >> 2) & 7, by a reduce-scatter: each of the first
// three levels keeps the half of the rows its lane bit picks and adds the
// partner lane's copy of that half; the last two add over the four lanes that
// share a row. 9 shuffles instead of 40 for a butterfly of every row.
__device__ __forceinline__ float warp_row_sums(const float (&t)[TF_RW], int lane) {
  static_assert(TF_RW == 8, "three halving levels");
  float a[4], b[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (hi16 ? t[i + 4] : t[i]) + __shfl_xor_sync(0xffffffffu, hi16 ? t[i] : t[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (hi8 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, hi8 ? a[i] : a[i + 2], 8);
  float c = (hi4 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// One pass of the statistics, first half: the warp's row sums over this
// rank's columns (warp_row_sums) go into slot [rank][row] of `sums` in every
// rank's shared memory (st.async, counted on that rank's barrier `bar`): the
// four lanes of a row store it to two ranks each.
__device__ __forceinline__ void push_row_sums(const float (&t)[TF_RW], float* sums, uint32_t bar,
                                              uint32_t rank, int row0, int lane) {
  const float mine = warp_row_sums(t, lane);
  const uint32_t slot = smem_addr(sums + rank * TF_ROWS + row0 + ((lane >> 2) & 7));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t dst = (lane & 3) + 4 * i;
    st_async(cluster_map(slot, dst), mine, cluster_map(bar, dst));
  }
}

// Second half: once all eight ranks' sums have landed, the total of row
// row0 + ((lane >> 2) & 7), its eight partial sums added in rank order: every
// rank holds the same totals.
__device__ __forceinline__ float row_total(const float* sums, uint32_t bar, int row0, int lane) {
  mbar_wait(bar, 0);
  float tot = 0.f;
#pragma unroll
  for (int r = 0; r < TF_RANKS; ++r) tot += sums[r * TF_ROWS + row0 + ((lane >> 2) & 7)];
  return tot;
}

__global__ void __cluster_dims__(TF_RANKS, 1, 1) __launch_bounds__(TF_THREADS, 2)
ln_proj_tail_tf32x3_kernel(const __grid_constant__ CUtensorMap map_p,
                           const float* __restrict__ x, const float* __restrict__ ln_g,
                           const float* __restrict__ ln_b, const float* __restrict__ bias,
                           float* __restrict__ y, float* __restrict__ p, int B, int D, int E,
                           float eps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const int nkb = D / TF_KB, kb_max = (nkb + TF_RANKS - 1) / TF_RANKS;
  // K block i of the rank: proj tiles (2i + h: columns 32h ..) at base, the
  // split y tiles (2i: hi, 2i + 1: lo) at panel
  const uint32_t panel = base + kb_max * 2 * TF_PROJ_TILE;
  float* const red = reinterpret_cast<float*>(sbase + kb_max * TF_KB_BYTES);  // [8][8][64]
  float* const sums = red + TF_RED / 4;                                       // [2][8][64]
  // TMA's proj slice; the row sums of passes 0 and 1, and the partial slabs,
  // each complete once all eight ranks' bytes have landed
  const uint32_t bar_proj = smem_addr(sums + TF_SUMS / 4), bar_sums = bar_proj + 8,
                 bar_red = bar_proj + 24;
  const uint32_t rank = cluster_ctarank();
  // this rank's K blocks [kb0, kb0 + nkr): every K block belongs to one rank
  const int kb0 = (int)rank * nkb / TF_RANKS, nkr = ((int)rank + 1) * nkb / TF_RANKS - kb0;
  const int m0 = (int)(blockIdx.x / TF_RANKS) * TF_ROWS, n0 = blockIdx.y * TF_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, row0 = TF_RW * warp;

  // ---- LayerNorm of the rank's K columns of the block's 64 rows. Warp w takes
  // rows 8w .. 8w + 7, all eight in flight; lane l owns the 16-byte chunk l of
  // the rank's columns. The loads go out first, under the set-up.
  const bool live = lane < 8 * nkr;
  const int kc = kb0 * TF_KB + 4 * lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v[TF_RW], g4 = zero, b4 = zero;
#pragma unroll
  for (int rr = 0; rr < TF_RW; ++rr) {
    const int m = m0 + row0 + rr;
    v[rr] = (live && m < B) ? *reinterpret_cast<const float4*>(x + (size_t)m * D + kc) : zero;
  }
  if (live) {
    g4 = *reinterpret_cast<const float4*>(ln_g + kc);
    b4 = *reinterpret_cast<const float4*>(ln_b + kc);
  }
  // thread 0: the barriers, then TMA's copy of the rank's slice of proj, as
  // it is stored: K block i, columns n0 + 32 h .. at proj tile 2 i + h
  // (columns past E arrive as zeros)
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bar_proj + 8 * i, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(bar_sums, TF_RANKS * TF_ROWS * 4);
    mbar_arrive_expect_tx(bar_sums + 8, TF_RANKS * TF_ROWS * 4);
    mbar_arrive_expect_tx(bar_red, TF_RED);
    if (nkr > 0) {
      mbar_arrive_expect_tx(bar_proj, nkr * 2 * TF_PROJ_TILE);
      for (int i = 0; i < nkr; ++i)
        for (int h = 0; h < 2; ++h)
          tma_load_2d(base + (2 * i + h) * TF_PROJ_TILE, &map_p, bar_proj, n0 + 32 * h,
                      (kb0 + i) * TF_KB);
    }
  }
  __syncthreads();
  cluster_arrive();  // this block's barriers are ready for the other ranks' stores

  // Two-pass fp32 statistics over the whole row: the mean, then the sum of
  // squared deviations from it, each pass exchanged between the ranks
  // (push_row_sums, row_total). Lane 4r derives row r's mean and rstd, and the
  // warp reads them by shuffle.
  float t[TF_RW], mean[TF_RW], rstd[TF_RW];
#pragma unroll
  for (int rr = 0; rr < TF_RW; ++rr) t[rr] = (v[rr].x + v[rr].y) + (v[rr].z + v[rr].w);
  cluster_wait();  // every rank's barriers are ready
  push_row_sums(t, sums, bar_sums, rank, row0, lane);
  const float mu = row_total(sums, bar_sums, row0, lane) / D;
#pragma unroll
  for (int rr = 0; rr < TF_RW; ++rr) {
    mean[rr] = __shfl_sync(0xffffffffu, mu, 4 * rr);
    const float a0 = v[rr].x - mean[rr], a1 = v[rr].y - mean[rr], a2 = v[rr].z - mean[rr],
                a3 = v[rr].w - mean[rr];
    t[rr] = live ? (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3) : 0.f;
  }
  push_row_sums(t, sums + TF_RANKS * TF_ROWS, bar_sums + 8, rank, row0, lane);
  const float rs =
      rsqrtf(row_total(sums + TF_RANKS * TF_ROWS, bar_sums + 8, row0, lane) / D + eps);
#pragma unroll
  for (int rr = 0; rr < TF_RW; ++rr) rstd[rr] = __shfl_sync(0xffffffffu, rs, 4 * rr);
  // y: stored by the blocks of the first column tile (each element once), and
  // split into hi and lo into the y tiles: K block i of the rank, row n, chunk
  // c at n * 128 + ((c ^ (n & 7)) << 4) of tile 2i (hi) / 2i + 1 (lo): rows of
  // 32 K values, the K-major B operand of wgmma. Rows past B are zeros.
  if (live) {
    unsigned char* const pt = sbase + (panel - base) + (lane / 8) * 2 * TF_TILE;
#pragma unroll
    for (int rr = 0; rr < TF_RW; ++rr) {
      const int n = row0 + rr, m = m0 + n;
      uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
      if (m < B) {
        float4 o;
        o.x = (v[rr].x - mean[rr]) * rstd[rr] * g4.x + b4.x;
        o.y = (v[rr].y - mean[rr]) * rstd[rr] * g4.y + b4.y;
        o.z = (v[rr].z - mean[rr]) * rstd[rr] * g4.z + b4.z;
        o.w = (v[rr].w - mean[rr]) * rstd[rr] * g4.w + b4.w;
        if (blockIdx.y == 0) *reinterpret_cast<float4*>(y + (size_t)m * D + kc) = o;
        tf32_split(o.x, hi.x, lo.x);
        tf32_split(o.y, hi.y, lo.y);
        tf32_split(o.z, hi.z, lo.z);
        tf32_split(o.w, hi.w, lo.w);
      }
      const int off = n * 128 + (((lane % 8) ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(pt + off) = hi;
      *reinterpret_cast<uint4*>(pt + TF_TILE + off) = lo;
    }
  }
  fence_proxy_async();
  __syncthreads();

  // ---- the partial product p^T (64 columns x 64 rows) = proj^T y^T: tf32
  // wgmma reads shared operands K-major only and proj is stored N-major, so
  // A = proj^T comes from registers (a thread may load any layout) and B is the
  // y panel. Row g of warp w's 16 A rows stands for column e = 16w + 2g of the
  // slice and row g + 8 for e + 1, so a[0], a[1] (and a[2], a[3]) are one
  // 8-byte load. lo*hi, hi*lo, hi*hi per k8 step; the rank's 4 nkr k8 steps
  // are halved between the warpgroups; one wait at the end. The steps are
  // unrolled, each under a condition that is the same for the whole block,
  // with registers of their own: a loop around the wgmmas, with its wait after
  // the loop, makes ptxas wait after every wgmma (the accumulators pass
  // through the loop's back edge).
  const int wg = threadIdx.x / 128, g = lane >> 2, q = lane & 3;
  const int e_loc = 16 * (warp % 4) + 2 * g, half = e_loc / 32, ce = e_loc % 32;
  float acc[32];
  uint32_t ah[2 * TF_MAX_KB][4], al[2 * TF_MAX_KB][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (nkr > 0) mbar_wait(bar_proj, 0);
#pragma unroll
  for (int st = 0; st < 2 * TF_MAX_KB; ++st) {
    if (st >= 2 * nkr) break;
    const int s = 2 * nkr * wg + st, i = s / 4, k8 = s % 4;
    const unsigned char* pt = sbase + (2 * i + half) * TF_PROJ_TILE + 4 * (ce & 3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int k = 8 * k8 + q + 4 * hf;
      const float2 f =
          *reinterpret_cast<const float2*>(pt + k * 128 + (((ce >> 2) ^ (k & 7)) << 4));
      tf32_split(f.x, ah[st][2 * hf], al[st][2 * hf]);
      tf32_split(f.y, ah[st][2 * hf + 1], al[st][2 * hf + 1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 2 * TF_MAX_KB; ++st) {
    if (st >= 2 * nkr) break;
    const int s = 2 * nkr * wg + st, i = s / 4, k8 = s % 4;
    const uint32_t yh = panel + i * 2 * TF_TILE + 32 * k8, yl = yh + TF_TILE;
    wgmma_m64n64k8_tf32_ra(acc, al[st], wgmma_desc(yh, 16, 1024), 1);
    wgmma_m64n64k8_tf32_ra(acc, ah[st], wgmma_desc(yl, 16, 1024), 1);
    wgmma_m64n64k8_tf32_ra(acc, ah[st], wgmma_desc(yh, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_settle(acc);
#pragma unroll
  for (int st = 0; st < 2 * TF_MAX_KB; ++st) {
    wgmma_settle(ah[st]);
    wgmma_settle(al[st]);
  }

  // ---- warpgroup 1's partial tile added to warpgroup 0's (through the y
  // tiles, which no wgmma reads any more), then the eight ranks' partial
  // tiles summed in rank order. acc[4j + 2hr + c] is column e_loc + hr, row
  // 8j + 2q + c: rank j sums rows 8j .. 8j + 7, so warpgroup 0 stores its row
  // 8j + 2q + c, columns e_loc, e_loc + 1, into slab [this rank][2q + c] of
  // rank j (st.async, counted on rank j's barrier).
  float* const part = reinterpret_cast<float*>(sbase + (panel - base));  // [32][128]
  const int tid = threadIdx.x % 128;
  __syncthreads();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i * 128 + tid] = acc[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i * 128 + tid];
    const uint32_t slab = smem_addr(red + (rank * TF_SLAB + 2 * q) * TF_COLS + e_loc);
#pragma unroll
    for (int j = 0; j < TF_RANKS; ++j) {
      const uint32_t bar = cluster_map(bar_red, j);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        st_async(cluster_map(slab + c * TF_COLS * 4, j), acc[4 * j + c], acc[4 * j + 2 + c], bar);
    }
  }
  mbar_wait(bar_red, 0);
  {
    const int row = threadIdx.x / 32, col = 2 * (threadIdx.x % 32);
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < TF_RANKS; ++r) {
      const float2 u = *reinterpret_cast<const float2*>(red + (r * TF_SLAB + row) * TF_COLS + col);
      s.x += u.x, s.y += u.y;
    }
    const int m = m0 + TF_SLAB * (int)rank + row, n = n0 + col;
    // the head's bias (E % 4 == 0: n + 1 < E where n < E)
    if (bias != nullptr && n < E) s.x += bias[n], s.y += bias[n + 1];
    if (m < B && n < E) *reinterpret_cast<float2*>(p + (size_t)m * E + n) = s;
  }
}

int launch_tail_tf32x3(const void* x, const float* ln_g, const float* ln_b, const void* proj,
                       const float* bias, void* y, void* p, int B, int D, int E, float eps,
                       cudaStream_t stream) {
  if (B == 0) return 0;
  if (D <= 0 || D % TF_KB != 0 || D > TF_MAX_D || E <= 0 || E % 4 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_p;  // proj (D, E) row-major fp32, box of 32 K rows x 32 columns
  const uint64_t dims[2] = {(uint64_t)E, (uint64_t)D};
  const uint64_t strides[1] = {(uint64_t)E * sizeof(float)};
  const uint32_t box[2] = {32u, (uint32_t)TF_KB};
  int rc = encode_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_128B, proj,
                      2, dims, strides, box);
  if (rc != 0) return rc;
  const int smem = tail_tf32_smem((D / TF_KB + TF_RANKS - 1) / TF_RANKS);
  cudaError_t err = cudaFuncSetAttribute(ln_proj_tail_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(TF_RANKS * ((B + TF_ROWS - 1) / TF_ROWS), (E + TF_COLS - 1) / TF_COLS);
  ln_proj_tail_tf32x3_kernel<<<grid, TF_THREADS, smem, stream>>>(
      map_p, static_cast<const float*>(x), ln_g, ln_b, bias, static_cast<float*>(y),
      static_cast<float*>(p), B, D, E, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D), proj (D, E), y (B, D), p (B, E) in the working type; ln_g/ln_b
// (D,) fp32; bias (E,) fp32, the head's bias added to p before the cast, or
// null; eps the LayerNorm's epsilon. fma != 0: the FMA kernel whatever the
// type; else the wgmma kernel of the type (bf16, or 3xTF32 in fp32).
int ln_proj_tail(const void* x, const void* ln_g, const void* ln_b, const void* proj,
                 const void* bias, void* y, void* p, int B, int D, int E, float eps, int dtype,
                 int fma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* hb = static_cast<const float*>(bias);
  if (dtype == DTYPE_BF16)
    return fma ? launch_tail<bf16>(x, g, b, proj, hb, y, p, B, D, E, eps, st)
               : launch_tail_bf16(x, g, b, proj, hb, y, p, B, D, E, eps, st);
  if (dtype == DTYPE_F32)
    return fma ? launch_tail<float>(x, g, b, proj, hb, y, p, B, D, E, eps, st)
               : launch_tail_tf32x3(x, g, b, proj, hb, y, p, B, D, E, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
