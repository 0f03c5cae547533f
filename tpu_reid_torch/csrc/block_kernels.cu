// Hand-written Hopper (sm_90a) kernels for one pre-norm CLIP block.
//
// Replaces the four Pallas kernels of tpu_reid/ops/: fused_block
// (fused_attention.py, _whole_block_kernel and its attention core
// _attention_heads), fused_mha (fused_attention.py, _kernel), fused_mlp
// (fused_attention.py, _mlp_kernel) and mha_core (attention.py,
// _attn_kernel). The TPU kernels keep a whole block's (or half-block's)
// weights, about 14 MB in bf16, resident in VMEM; an SM has 227 KB of shared
// memory, so they become launches of three kernels:
//
//   ln_gemm             [LN ->] GEMM + bias [+ QuickGELU]: LN1 -> qkv, LN2 ->
//                       c_fc. LayerNorm statistics in fp32, fp32 affine, the
//                       normalised rows rounded to the working type on the
//                       way into shared memory; with a deep-prompt plane,
//                       spliced rows are read from the plane instead. Without
//                       LN parameters the rows are read as they are (fused_mha
//                       without pre-LN).
//   mha_core            softmax attention for any S, dh = 64 (bf16: whole score
//                       rows for S <= 256, a loop over key tiles beyond; fp32:
//                       key tiles for every S) on
//                       q, k and v given as three base pointers and one row
//                       stride (elements between consecutive tokens): views
//                       into a packed (B, S, 3D) qkv buffer (stride 3D) and
//                       contiguous (B, S, H, 64) tensors (stride H*64) both
//                       run without a copy. Writes (B, S, H*64); exact or
//                       fast (exp2 with a saturating clamp) softmax, both
//                       normalised late by the row reciprocal (the Pallas
//                       _attn_kernel divides instead: the two differ by at
//                       most an fp32 ulp before the cast).
//   gemm_bias_residual  out-proj / c_proj GEMM, bias [+ residual] in fp32,
//                       then the cast. The out-proj residual applies the same
//                       deep-prompt splice as ln_gemm's row load; without a
//                       residual it is fused_mha's no-LN out-projection.
//
// fused_block = fused_mlp(fused_mha(x)) is five launches: ln_gemm, mha_core,
// gemm_bias_residual (fused_mha with pre-LN), ln_gemm(gelu),
// gemm_bias_residual (fused_mlp).
//
// What bounds them on the H100: the four GEMMs are ~97% of the block's
// operations (2*S*(4*D^2 + 2*D*hid) per image), so at ViT-B width the block
// is bound by tensor-core rate, not by the ~1 GB of activations it moves per
// 64 images; attention alone is bound by its bytes (qkv in, heads out). What
// the bf16 kernels do about it (helpers in hopper.cuh):
//
//   * One GEMM kernel, gemm_bf16_kernel, behind ln_gemm and
//     gemm_bias_residual: wgmma m64n128k16 with fp32 accumulators in
//     registers, both operands read from 128-byte-swizzled shared tiles, W
//     brought in by TMA as it is stored ((K, N) row-major: wgmma takes the
//     transposed B operand) into a ring of four stages guarded by mbarriers,
//     one producer thread and two consumer warpgroups (setmaxnreg hands the
//     producer's registers over). TMA's zero fill covers the ragged M, N and
//     K edges; stores are masked.
//   * With LayerNorm a block keeps a panel of 128 rows over the whole K
//     (64 rows where K > 768) in shared memory: its consumers read each row
//     once, take the two-pass fp32 statistics once, normalise once, round to
//     bf16 and write the panel in the swizzled layout wgmma reads; then the
//     block walks N tiles while only W streams in. The K loop holds no
//     LayerNorm arithmetic, and the normalised rows never reach device
//     memory. The two consumer warpgroups take every other N tile over all
//     the panel's rows, so one's epilogue runs under the other's mainloop.
//     Blocks take equal contiguous ranges of the (row panel, N tile) list, so
//     the last wave is not ragged; a range that enters a new panel
//     normalises it.
//   * Without LayerNorm the A tiles come by TMA too, 256 rows per block
//     (each consumer warpgroup two 64-row accumulators of every stage), and
//     blocks walk the output tiles, so the ring fills for the next tile
//     under a tile's epilogue.
//   * Epilogues add the bias, take QuickGELU or the spliced residual in
//     fp32 with the row's source decided once per row, and exchange column
//     pairs inside each quad so that bias, residual and output move as
//     16-byte vectors.
//   * attention_bf16_kernel: persistent blocks walk the (image, head)
//     pairs. Q, K and V of a head arrive once by TMA from the strided views
//     (a 3-D map over (B, S, row stride), box of 64 columns at column h*64,
//     rows past S zero-filled) into one of two buffers, the next head under
//     the work on this one; two warpgroups take the 64-row query tiles in
//     turn. Both products are wgmma: Q K^T for all keys at once from shared
//     operands, so a thread holds two whole score rows in registers; P V
//     with the probabilities fed from registers and V as the transposed B
//     operand. An additive mask of up to 32 KB (S <= 90: the text tower) is
//     staged in shared memory once per block.
//   * attention_long_bf16_kernel (S > 256): one block per (128 query rows,
//     head, image); K and V tiles of 64 keys stream through a TMA ring, the
//     softmax runs online over the tiles; its notes stand above it.
//
// The fp32 route (the training CLIs' default dtype: every forward of every
// training step) runs two kernels of its own, both 3xTF32 on wgmma: each
// operand split once into hi = tf32(x) and lo = tf32(x - hi), each k8 step
// lo*hi + hi*lo + hi*hi into one fp32 accumulator, so every product keeps
// ~22 of fp32's 24 mantissa bits at a third of the TF32 tensor-core rate
// (165 TF/s dense against the CUDA cores' 67 TF/s of fp32 FMA). What bounds
// them is that rate: the least time of an fp32-accurate product on this card
// is three TF32 passes.
//
//   * gemm_tf32x3_kernel behind ln_gemm and gemm_bias_residual; tf32 wgmma
//     reads its shared operands K-major only, so a splitter warpgroup
//     writes each TMA-loaded W tile transposed and split, while the
//     consumers take A from registers (LayerNorm and splice applied there,
//     before the split); its notes stand above it.
//   * attention_tf32x3_kernel: mha_core for every S, flash-style over key
//     tiles of 64 with an online softmax; its notes stand above it.
//
// Measured times stand in PERF.md.
//
// bf16 rounding points mirror the Pallas kernel: LN output cast back to the
// working type, qkv cast after the bias, probabilities cast before p@v, the
// head output cast after the reciprocal, x1 cast after the residual, the MLP
// hidden activation cast after QuickGELU. In the bf16 kernels QuickGELU's and
// the softmax's exponentials are ex2.approx (and QuickGELU's division
// rcp.approx), about 2 ulp of fp32, far below a bf16 rounding.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <type_traits>

#include "hopper.cuh"


namespace {

// ---------------------------------------------------------------------------
// GEMM with LayerNorm prologue / bias, QuickGELU or residual epilogue
// ---------------------------------------------------------------------------

constexpr int LN_MAX_K = 1024;  // LayerNorm width the kernels take
constexpr int EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2;

struct GemmArgs {
  const void* a;       // (M, K) row-major, T
  const void* w;       // (K, N) row-major, T
  const void* bias;    // (N,), T
  const void* res;     // (M, N), T; EPI_RESIDUAL only
  const void* plane;   // (S, K) with LN, else (S, N); rows spliced in, or null
  const float* pmask;  // (S,): row s of each sequence comes from the plane if > 0
  const float* ln_g;   // (K,) fp32 LayerNorm scale; null: no LN prologue
  const float* ln_b;   // (K,) fp32 LayerNorm bias
  void* out;           // (M, N), T
  int M, N, K, S, epi;
};

// ---- bf16: TMA-fed wgmma; with LN, a normalised row panel resident in shared memory ----
//
// Threads: two consumer warpgroups, then one producer warpgroup of which one
// thread issues TMA loads; all blocks are persistent, one per SM. Shared
// memory (from a 1024-byte aligned base): with LN the panel, ceil(K / 64)
// k-blocks of [ROWS rows][128 bytes]; the ring of four stages, each [A tile:
// 256 rows x 128 bytes, without LN only][W tile: two [BK rows][128 bytes]
// halves, columns n0.. and n0 + 64..]; then the barriers. With LN a stage is
// 32 rows of W (8 KB): four stages are what fits beside a 192 KB panel, and
// the W stream is bound by that ring's depth over the L2 latency. Without LN
// a stage is 64 deep (48 KB).

constexpr int TBN = 128;     // output tile width: one wgmma m64n128k16 per 64 rows
constexpr int SMEM_MAX = 232448;

// MT: 64-row accumulators per consumer warpgroup
template <bool LN, int MT>
struct GemmShape {
  static constexpr int BK = LN ? 32 : 64;        // rows of W per stage
  static constexpr int STAGES = 4;               // ring depth
  static constexpr int ROWS = LN ? 64 * MT : 128 * MT;  // rows of the block's tile
  static constexpr int A_STAGE = LN ? 0 : ROWS * 128;
  static constexpr int W_HALF = BK * 128;
  static constexpr int STAGE = A_STAGE + 2 * W_HALF;
  static constexpr int THREADS = 384;            // two consumer warpgroups and the producer's
  __host__ __device__ static int panel_bytes(int K) {
    return LN ? (K + 63) / 64 * ROWS * 128 : 0;
  }
  // 1024 for the alignment of the base, 256 for the barriers
  __host__ __device__ static int smem_bytes(int K) {
    return 1024 + panel_bytes(K) + STAGES * STAGE + 256;
  }
};

// The LN prologue: the 8 consumer warps share the panel's ROWS rows, RG rows
// at a time per warp (their loads in flight together, and the next rows'
// while these are normalised; one row at a time for the wide 64-row panel,
// whose rows take more registers). A lane owns the
// 16-byte chunks lane, lane + 32, ... of every row, so its gamma/beta stay in
// registers. Statistics in two passes in fp32; rows past M are zero.
template <int MT>
__device__ __forceinline__ void ln_panel_rows(const GemmArgs& g, int m0, unsigned char* panel,
                                              int warp, int lane) {
    constexpr int ROWS = 64 * MT, PER_WARP = ROWS / 8, NV = MT == 2 ? 3 : 4, RG = MT;
  const int nchunks = g.K / 8;
  float gm[NV][8], bt[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (c < nchunks) {
        a = *reinterpret_cast<const float4*>(g.ln_g + 8 * c + e);
        b = *reinterpret_cast<const float4*>(g.ln_b + 8 * c + e);
      }
      gm[i][e] = a.x, gm[i][e + 1] = a.y, gm[i][e + 2] = a.z, gm[i][e + 3] = a.w;
      bt[i][e] = b.x, bt[i][e + 1] = b.y, bt[i][e + 2] = b.z, bt[i][e + 3] = b.w;
    }
  }
  // the rows r0 .. r0 + RG - 1 of the panel, as loaded (zero past M or K)
  auto load_rows = [&](int r0, uint4 (&u)[RG][NV], bool (&live)[RG]) {
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      const int m = m0 + r0 + rr;
      const bf16* p = nullptr;
      if (m < g.M) {
        p = static_cast<const bf16*>(g.a) + (size_t)m * g.K;
        if (g.plane != nullptr) {
          const int s = m % g.S;
          if (g.pmask[s] > 0.f) p = static_cast<const bf16*>(g.plane) + (size_t)s * g.K;
        }
      }
      live[rr] = p != nullptr;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        u[rr][i] = (p != nullptr && c < nchunks) ? *reinterpret_cast<const uint4*>(p + 8 * c)
                                                 : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  const int r_end = (warp + 1) * PER_WARP;
  uint4 u[RG][NV], u_next[RG][NV];
  bool live[RG], live_next[RG];
  load_rows(warp * PER_WARP, u, live);
  for (int r0 = warp * PER_WARP; r0 < r_end; r0 += RG) {
    // the next rows' loads fly while these rows are normalised
    if (r0 + RG < r_end) load_rows(r0 + RG, u_next, live_next);
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      float f[NV][8], s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        unpack_vec<bf16>(u[rr][i], f[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[i][e];
      }
      const float mean = warp_sum(s) / g.K;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i >= nchunks) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          f[i][e] -= mean;
          v += f[i][e] * f[i][e];
        }
      }
      const float rstd = rsqrtf(warp_sum(v) / g.K + 1e-5f);
      const int r = r0 + rr;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c >= nchunks) continue;
        unsigned char* dst = panel + (size_t)(c >> 3) * (ROWS * 128) + r * 128 +
                             (((c & 7) ^ (r & 7)) << 4);
        if (live[rr]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[i][e] = f[i][e] * rstd * gm[i][e] + bt[i][e];
          store_vec<bf16>(reinterpret_cast<bf16*>(dst), f[i]);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
      live[rr] = live_next[rr];
#pragma unroll
      for (int i = 0; i < NV; ++i) u[rr][i] = u_next[rr][i];
    }
  }
}

// The bias of the 8 columns lane q stores in each of the epilogue's four
// rounds: columns n0 + 8 * (4 * round + q) ..., zero past N. Without LN it is
// loaded at the start of a tile so that the epilogue never waits for it.
__device__ __forceinline__ void load_tile_bias(const GemmArgs& g, int n0, int q,
                                               uint4 (&bias4)[4]) {
#pragma unroll
  for (int jq = 0; jq < 4; ++jq) {
    const int n = n0 + 8 * (4 * jq + q);
    bias4[jq] = n < g.N ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.bias) + n)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Where the residual of output row m comes from: the prompt plane where the
// row's position in its sequence is spliced, else the residual; null past M.
__device__ __forceinline__ const bf16* residual_row(const GemmArgs& g, int m) {
  if (m >= g.M) return nullptr;
  const int s = m % g.S;
  return (g.plane != nullptr && g.pmask[s] > 0.f)
             ? static_cast<const bf16*>(g.plane) + (size_t)s * g.N
             : static_cast<const bf16*>(g.res) + (size_t)m * g.N;
}

// MT 64 x 128 accumulators -> out: bias, then QuickGELU (fp32) or the spliced
// residual, the cast, and 16-byte stores. row0: the first of this warp's 16
// rows in accumulator 0 (accumulator mt: + 64 mt); res: the residual source
// of the thread's rows g and g + 8 of each accumulator (residual_row, taken
// once per row at the start of the tile). The four lanes of a quad exchange
// their column pairs (in fp32, before any arithmetic) so that each owns 8
// consecutive columns of a row: bias, residual and output then move as
// 16-byte vectors.
template <int EPI, int MT, bool BIAS_LOADED>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& g, const float (&acc)[MT][64],
                                              const uint4 (&bias4)[4],
                                              const bf16* (&res)[MT][2], int row0, int n0,
                                              int lane) {
  const int gq = lane >> 2, q = lane & 3;
  // the residual of (accumulator mt, row half hr) is asked for one such unit
  // before it is used
  auto load_residual = [&](int mt, int hr, uint4 (&r4)[4]) {
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      const int n = n0 + 8 * (4 * jq + q);
      r4[jq] = (res[mt][hr] != nullptr && n < g.N)
                   ? *reinterpret_cast<const uint4*>(res[mt][hr] + n)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 res_now[4] = {}, res_next[4] = {};
  if (EPI == EPI_RESIDUAL) load_residual(0, 0, res_now);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (EPI == EPI_RESIDUAL && 2 * mt + hr + 1 < 2 * MT)
        load_residual((2 * mt + hr + 1) / 2, (2 * mt + hr + 1) % 2, res_next);
      const int m = row0 + 64 * mt + gq + 8 * hr;
      bf16* dst = static_cast<bf16*>(g.out) + (size_t)m * g.N;
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) {
        // x[2i], x[2i + 1]: columns n0 + 8 * (4 * jq + q) + 2i, + 1 of the row
        float lo[4], hi[4], x[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = acc[mt][4 * (4 * jq + i) + 2 * hr];
          hi[i] = acc[mt][4 * (4 * jq + i) + 2 * hr + 1];
        }
        quad_transpose(lo, q);
        quad_transpose(hi, q);
        const int n = n0 + 8 * (4 * jq + q);
        uint4 b4 = bias4[jq];
        if (!BIAS_LOADED)
          b4 = n < g.N ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.bias) + n)
                       : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t b[4] = {b4.x, b4.y, b4.z, b4.w};
        const uint32_t r[4] = {res_now[jq].x, res_now[jq].y, res_now[jq].z, res_now[jq].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 bb = unpack_bf16(b[i]);
          x[2 * i] = lo[i] + bb.x;
          x[2 * i + 1] = hi[i] + bb.y;
          if (EPI == EPI_RESIDUAL) {
            const float2 rr = unpack_bf16(r[i]);
            x[2 * i] += rr.x;
            x[2 * i + 1] += rr.y;
          }
        }
        if (EPI == EPI_GELU) {
          // x * sigmoid(1.702 x) = x / (1 + 2^(-1.702 log2(e) x)), a stage at a
          // time over the 8 values so that their chains overlap
          float e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = ex2_approx(x[i] * (-1.702f * 1.4426950408889634f));
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = rcp_approx(1.f + e[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] *= e[i];
        }
        if (m < g.M && n < g.N)
          *reinterpret_cast<uint4*>(dst + n) =
              make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                         pack_bf16(x[6], x[7]));
      }
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) res_now[jq] = res_next[jq];
    }
}

template <bool LN, int MT, int EPI>
__global__ void __launch_bounds__(GemmShape<LN, MT>::THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const GemmArgs g) {
  using Sh = GemmShape<LN, MT>;
  constexpr int BK = Sh::BK, ROWS = Sh::ROWS, STAGE = Sh::STAGE, G_STAGES = Sh::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t ring = base + Sh::panel_bytes(g.K);
  const uint32_t full = ring + G_STAGES * STAGE, empty = full + 8 * G_STAGES;
  // with LN: order + 8w lets warpgroup w into its next mainloop; panel_free:
  // nobody reads the panel any more; panel_done: all its rows are written
  const uint32_t order = empty + 8 * G_STAGES, panel_free = order + 16, panel_done = order + 24;

  // Output tiles are numbered row tile by row tile, N fastest. With LN block c
  // of G takes the contiguous range [c T / G, (c + 1) T / G) of the T tiles: a
  // range spans a few row panels, each normalised when the range enters it,
  // and every SM gets the same number of tiles (to within one). Without LN
  // the block takes tiles c, c + G, ...
  const int n_tiles = (g.N + TBN - 1) / TBN;
  const long long all_tiles = (long long)((g.M + ROWS - 1) / ROWS) * n_tiles;
  const long long first = LN ? all_tiles * blockIdx.x / gridDim.x : 0;
  const int total = LN ? (int)(all_tiles * (blockIdx.x + 1) / gridDim.x - first) : (int)all_tiles;
  auto tile = [&](int i, int& m0, int& n0) {
    const long long t = LN ? first + i : (long long)blockIdx.x + (long long)i * gridDim.x;
    if (LN ? i >= total : t >= total) return false;
    m0 = (int)(t / n_tiles) * ROWS;
    n0 = (int)(t % n_tiles) * TBN;
    return true;
  };
  const int nk = (g.K + BK - 1) / BK;
  if (total <= 0) return;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, LN ? 1 : 2);
    }
    mbar_init(order, 1);
    mbar_init(order + 8, 1);
    mbar_init(panel_free, 256);
    mbar_init(panel_done, 256);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  int m0 = 0, n0 = 0;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; tile(i, m0, n0); ++i) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, STAGE);
        const uint32_t dst = ring + s * STAGE;
        if (!LN) tma_load_2d(dst, &map_a, full + 8 * s, kt * BK, m0);
        tma_load_2d(dst + Sh::A_STAGE, &map_w, full + 8 * s, n0, kt * BK);
        tma_load_2d(dst + Sh::A_STAGE + Sh::W_HALF, &map_w, full + 8 * s, n0 + 64, kt * BK);
        if (++s == G_STAGES) s = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumers: [LN panel,] wgmma over the ring, epilogue ---------------
    // Without LN the two warpgroups share every stage (128 rows each). With
    // LN each takes every other N tile over all the panel's rows, so one's
    // epilogue runs under the other's mainloop and the W stream never stops.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32;
    int it = 0;  // stages gone by since the kernel began: stage it % G_STAGES
    int panels = 0;  // row panels normalised so far
    for (int i = 0; tile(i, m0, n0); ++i) {
      if (LN && (i == 0 || n0 == 0)) {
        // a new row panel: once neither warpgroup reads the old one, both
        // write their halves of the new one
        if (i > 0) {
          mbar_arrive(panel_free);
          mbar_wait(panel_free, (panels - 1) & 1);
        }
        ln_panel_rows<MT>(g, m0, smem_raw + (base - raw), wg * 4 + warp, lane);
        fence_proxy_async();
        mbar_arrive(panel_done);
        mbar_wait(panel_done, panels & 1);
        ++panels;
      }
      if (LN && (i & 1) != wg) {
        it += nk;
        continue;
      }
      // a full barrier tells neighbouring fills apart, no more: wait for the
      // other warpgroup to have drained its tile before looking at this one's
      // (its tiles 0, 1, 2, ... of these waits end phases 0, 1, 0, ... of the barrier)
      if (LN && i > 0) mbar_wait(order + 8 * wg, ((i - 1) >> 1) & 1);
      // cleared, although the first wgmma of a tile overwrites it: the compiler
      // then keeps no accumulator alive from one tile to the next
      float acc[MT][64];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[mt][e] = 0.f;
      // without LN the epilogue is not hidden: its bias is asked for here; with
      // LN it runs under the other warpgroup's mainloop and loads its own
      uint4 bias4[4] = {};
      if (!LN) load_tile_bias(g, n0, lane & 3, bias4);
      const int row0 = m0 + (LN ? 0 : wg * MT * 64) + warp * 16;
      const bf16* res[MT][2] = {};
      if (EPI == EPI_RESIDUAL) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            res[mt][hr] = residual_row(g, row0 + 64 * mt + (lane >> 2) + 8 * hr);
      }
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % G_STAGES;
        mbar_wait(full + 8 * s, (it / G_STAGES) & 1);
        wgmma_fence();
        const uint32_t stage = ring + s * STAGE;
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const uint64_t db = wgmma_desc(stage + Sh::A_STAGE + j * 2048, Sh::W_HALF, 1024);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a = LN ? base + (kt >> 1) * (ROWS * 128) + mt * 8192 +
                                        ((kt & 1) * 2 + j) * 32
                                  : stage + (wg * MT + mt) * 8192 + j * 32;
            wgmma_m64n128k16_tb(acc[mt], wgmma_desc(a, 16, 1024), db, (kt | j) != 0);
          }
        }
        wgmma_commit();
        if (kt > 0) {  // the stage before this one has been read
          wgmma_wait<1>();
          if (tid == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_settle(acc[mt]);
      if (tid == 0) mbar_arrive(empty + 8 * prev);
      if (LN && i + 1 < total && tid == 0) mbar_arrive(order + 8 * (wg ^ 1));
      gemm_epilogue<EPI, MT, !LN>(g, acc, bias4, res, row0, n0, lane);
    }
  }
}

// ---- fp32: 3xTF32 on wgmma ---------------------------------------------------
//
// fp32 in, fp32 out, every product fp32-accurate: each operand is split once,
// as it reaches the tensor cores, into hi = tf32(x) and lo = tf32(x - hi),
// and every k8 step adds lo*hi, hi*lo, then hi*hi into one fp32 accumulator
// (only lo*lo, about 2^-22 of a product, is dropped): three TF32 passes, a
// third of the tensor cores' TF32 rate and ~2.5x the CUDA cores' fp32 rate.
//
// Block tile 128 x 128, k-stages of 32 (one 128-byte row of fp32), 384
// threads: two consumer warpgroups (64 rows each) and a splitter warpgroup
// whose thread 0 also issues the TMA loads. A k-stage arrives raw in a ring
// of TG_RAW stages: the A tile (128 rows x 32, 128-byte swizzle) and the W
// tile (32 rows x 128 columns as W is stored, (K, N) row-major: N-major).
// tf32 wgmma reads both shared operands K-major only, so the splitter writes
// each W tile transposed, split into hi and lo, in the 128-byte swizzle
// (one 128-byte row per output column), into a double-buffered split ring;
// W changes every training step, so no copy of it is made beforehand. The
// consumers take A from registers: each thread reads its fragment of the
// raw A tile, applies the LayerNorm (fp32 statistics and affine, before the
// split) or takes a spliced row from the prompt plane, and splits it; the
// next stage's values are read while the tensor cores work on this one.
//
// LayerNorm: a row panel's statistics are taken once, two-pass in fp32, when
// a block enters the panel (each warp its 16 rows, two at a time). Blocks
// take chunks of up to three consecutive N tiles of one panel, chunk c,
// c + G, ... (without LayerNorm chunks of one tile), so that the ~20 panels
// in flight stay in L2 while the statistics are paid once per chunk.
// Epilogue in fp32: bias, QuickGELU or the spliced residual, read one by
// one (any address: FP32_SCALAR_OPERANDS in ops/fused_attention.py).

constexpr int TG_BM = 128, TG_BN = 128, TG_BK = 32, TG_RAW = 4, TG_THREADS = 384;
constexpr int TG_TILE = TG_BM * TG_BK * 4;        // 16 KB: an A tile, a W tile, a split half
constexpr int TG_RAW_STAGE = 2 * TG_TILE;         // [A | W]
constexpr int TG_SPLIT_STAGE = 2 * TG_TILE;       // [hi | lo]
constexpr int TG_LN_BYTES = (2 * LN_MAX_K + 3 * TG_BM) * 4;  // gamma, beta; row statistics
constexpr int TG_SMEM = 1024 + TG_RAW * TG_RAW_STAGE + 2 * TG_SPLIT_STAGE + TG_LN_BYTES +
                        8 * (2 * TG_RAW + 4);

// a shared-memory word read where it is used: the compiler keeps no copy of
// it in a register across the K loop
__device__ __forceinline__ float lds_volatile(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_addr(p)));
  return v;
}

// where a block's tiles lie: chunks of consecutive N tiles of one row panel
struct TileOrder {
  int n_tiles, cpp;  // N tiles; chunks per panel
  long long n_chunks;
  __device__ TileOrder(const GemmArgs& g, bool ln) {
    n_tiles = (g.N + TG_BN - 1) / TG_BN;
    cpp = ln ? (n_tiles + 2) / 3 : n_tiles;
    n_chunks = (long long)((g.M + TG_BM - 1) / TG_BM) * cpp;
  }
  // the N tiles [nt0, nt1) of chunk c (never empty: cpp <= n_tiles)
  __device__ void tiles(long long c, int& nt0, int& nt1) const {
    const int j = (int)(c % cpp);
    nt0 = j * n_tiles / cpp;
    nt1 = (j + 1) * n_tiles / cpp;
  }
};

// A walk over a block's k-stages in order: (chunk, N tile, k-stage)
struct StageWalk {
  long long c;
  int nt, nt1, kt;
  __device__ bool start(const TileOrder& o) {
    c = blockIdx.x;
    kt = 0;
    if (c >= o.n_chunks) return false;
    o.tiles(c, nt, nt1);
    return true;
  }
  __device__ bool next(const TileOrder& o, int nk) {
    if (++kt < nk) return true;
    kt = 0;
    if (++nt < nt1) return true;
    c += gridDim.x;
    if (c >= o.n_chunks) return false;
    o.tiles(c, nt, nt1);
    return true;
  }
};

// fp32 epilogue value of output (m, n): + bias, then QuickGELU or + residual
// (already the spliced row's)
template <int EPI>
__device__ __forceinline__ float tg_epi(float v, float bias, const float* res_row, int n) {
  v += bias;
  if (EPI == EPI_GELU) return v / (1.f + expf(-1.702f * v));
  if (EPI == EPI_RESIDUAL) v += res_row[n];
  return v;
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(TG_THREADS, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base, split = ring + TG_RAW * TG_RAW_STAGE;
  float* const ln_s = reinterpret_cast<float*>(gbase + TG_RAW * TG_RAW_STAGE +
                                               2 * TG_SPLIT_STAGE);  // [gamma | beta]
  // per tile row of the current panel: mean, rstd, and (as a float) the
  // position in its sequence where the row is spliced from the plane, or -1
  float* const row_mean = ln_s + 2 * LN_MAX_K;
  float* const row_rstd = row_mean + TG_BM;
  float* const row_plane = row_rstd + TG_BM;
  const uint32_t raw_full = split + 2 * TG_SPLIT_STAGE + TG_LN_BYTES;
  const uint32_t raw_empty = raw_full + 8 * TG_RAW, split_full = raw_empty + 8 * TG_RAW,
                 split_empty = split_full + 16;
  const TileOrder order(g, LN);
  const int nk = g.K / TG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_RAW; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_empty + 8 * s, TG_THREADS);  // every thread has read its part
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(split_full + 8 * s, 128);   // the splitters
      mbar_init(split_empty + 8 * s, 256);  // the consumers
    }
    mbar_init_fence();
  }
  if (LN) {
    for (int k = threadIdx.x; k < g.K; k += TG_THREADS) {
      ln_s[k] = g.ln_g[k];
      ln_s[LN_MAX_K + k] = g.ln_b[k];
    }
  }
  __syncthreads();
  if (blockIdx.x >= order.n_chunks) return;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 2) {
    // ---- splitters: W tiles transposed and split; thread 0 keeps the raw ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    StageWalk pw;
    bool pmore = false;
    long long issued = 0;
    auto issue = [&]() {
      const int s = (int)(issued % TG_RAW);
      mbar_wait(raw_empty + 8 * s, (uint32_t)((issued / TG_RAW) & 1) ^ 1);
      mbar_arrive_expect_tx(raw_full + 8 * s, TG_RAW_STAGE);
      const int m0 = (int)(pw.c / order.cpp) * TG_BM, n0 = pw.nt * TG_BN;
      const uint32_t dst = ring + s * TG_RAW_STAGE;
      tma_load_2d(dst, &map_a, raw_full + 8 * s, pw.kt * TG_BK, m0);
      tma_load_2d(dst + TG_TILE, &map_w, raw_full + 8 * s, n0, pw.kt * TG_BK);
      ++issued;
      pmore = pw.next(order, nk);
    };
    if (tid == 0) {
      pmore = pw.start(order);
      for (int s = 0; s < TG_RAW && pmore; ++s) issue();
    }
    StageWalk sw;
    bool more = sw.start(order);
    for (long long it = 0; more; ++it, more = sw.next(order, nk)) {
      const int s = (int)(it % TG_RAW), sp = (int)(it & 1);
      mbar_wait(raw_full + 8 * s, (uint32_t)((it / TG_RAW) & 1));
      mbar_wait(split_empty + 8 * sp, (uint32_t)((it >> 1) & 1) ^ 1);
      // column n = tid of the W tile: 32 k values -> one swizzled 128-byte
      // row of hi and one of lo (chunk kc of row n at ((kc ^ (n & 7)) << 4))
      const float* wr = reinterpret_cast<const float*>(gbase + s * TG_RAW_STAGE + TG_TILE);
      unsigned char* hi = gbase + TG_RAW * TG_RAW_STAGE + sp * TG_SPLIT_STAGE + tid * 128;
      float v[TG_BK];
#pragma unroll
      for (int k = 0; k < TG_BK; ++k) v[k] = wr[k * TG_BN + tid];
#pragma unroll
      for (int kc = 0; kc < TG_BK / 4; ++kc) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(v[4 * kc + e], h[e], l[e]);
        const int off = (kc ^ (tid & 7)) << 4;
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(hi + TG_TILE + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      fence_proxy_async();
      mbar_arrive(split_full + 8 * sp);
      mbar_arrive(raw_empty + 8 * s);
      if (tid == 0 && pmore) issue();
    }
    return;
  }

  // ---- consumers: A fragments from the raw tile, three passes on wgmma ------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, q = lane & 3;
  const int r_loc = 64 * wg + 16 * warp + gq;  // tile row of the thread's first row
  uint32_t it = 0;
  for (long long c = blockIdx.x; c < order.n_chunks; c += gridDim.x) {
    const int m0 = (int)(c / order.cpp) * TG_BM;
    int nt0, nt1;
    order.tiles(c, nt0, nt1);
    // each warp its 16 rows of the panel: statistics, and where the
    // LayerNorm input is spliced from the prompt plane (in shared memory,
    // which only this warp reads: no register holds them over the K loop)
    if (LN) {
      const int nchunks = g.K / 4;
      for (int r0 = 0; r0 < 16; r0 += 2) {
        float4 u[2][LN_MAX_K / 128];
        const float* rp[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int m = m0 + 64 * wg + 16 * warp + r0 + rr;
          const float* p = nullptr;
          int spliced = -1;
          if (m < g.M) {
            p = static_cast<const float*>(g.a) + (size_t)m * g.K;
            if (g.plane != nullptr) {
              const int s = m % g.S;
              if (g.pmask[s] > 0.f) {
                p = static_cast<const float*>(g.plane) + (size_t)s * g.K;
                spliced = s;
              }
            }
          }
          rp[rr] = p;
          if (lane == 0) row_plane[64 * wg + 16 * warp + r0 + rr] = (float)spliced;
#pragma unroll
          for (int i = 0; i < LN_MAX_K / 128; ++i) {
            const int ch = lane + 32 * i;
            u[rr][i] = (p != nullptr && ch < nchunks)
                           ? *reinterpret_cast<const float4*>(p + 4 * ch)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float s1 = 0.f;
#pragma unroll
          for (int i = 0; i < LN_MAX_K / 128; ++i)
            s1 += (u[rr][i].x + u[rr][i].y) + (u[rr][i].z + u[rr][i].w);
          const float mu = warp_sum(s1) / g.K;
          float s2 = 0.f;
#pragma unroll
          for (int i = 0; i < LN_MAX_K / 128; ++i) {
            if (lane + 32 * i >= nchunks) continue;
            const float a0 = u[rr][i].x - mu, a1 = u[rr][i].y - mu, a2 = u[rr][i].z - mu,
                        a3 = u[rr][i].w - mu;
            s2 += (a0 * a0 + a1 * a1) + (a2 * a2 + a3 * a3);
          }
          const float rs = rsqrtf(warp_sum(s2) / g.K + 1e-5f);
          const bool live = rp[rr] != nullptr;
          if (lane == 0) {
            row_mean[64 * wg + 16 * warp + r0 + rr] = live ? mu : 0.f;
            row_rstd[64 * wg + 16 * warp + r0 + rr] = live ? rs : 0.f;
          }
        }
      }
      __syncwarp();
    }
    for (int nt = nt0; nt < nt1; ++nt) {
      const int n0 = nt * TG_BN;
      // A values of one k-stage, normalised: v[k8][i] becomes the register
      // operand of the k8 step (i = 0: row r_loc, column 8 k8 + q; 1: row
      // r_loc + 8; 2, 3: column + 4) once split. The next stage's are read
      // under this stage's tensor-core work; only 16 fp32 values wait in
      // registers (their split, 48 ALU operations, follows the wait).
      auto load_vals = [&](uint32_t st, int kt, float (&vals)[4][4]) {
        const int s = (int)(st % TG_RAW);
        mbar_wait(raw_full + 8 * s, (st / TG_RAW) & 1);
        const unsigned char* at = gbase + s * TG_RAW_STAGE;
        float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
        const float* sp_row[2] = {nullptr, nullptr};
        if (LN) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            mean[hr] = lds_volatile(row_mean + r_loc + 8 * hr);
            rstd[hr] = lds_volatile(row_rstd + r_loc + 8 * hr);
            const float sp = lds_volatile(row_plane + r_loc + 8 * hr);
            if (sp >= 0.f) sp_row[hr] = static_cast<const float*>(g.plane) + (size_t)sp * g.K;
          }
        }
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hr = i & 1, col = 8 * k8 + q + 4 * (i >> 1);
            const int row = r_loc + 8 * hr;
            float v = *reinterpret_cast<const float*>(
                at + row * 128 + (((col >> 2) ^ (row & 7)) << 4) + 4 * q);
            if (LN) {
              const int kg = kt * TG_BK + col;
              if (sp_row[hr] != nullptr) v = sp_row[hr][kg];
              v = (v - mean[hr]) * rstd[hr] * ln_s[kg] + ln_s[LN_MAX_K + kg];
            }
            vals[k8][i] = v;
          }
        }
        mbar_arrive(raw_empty + 8 * s);
      };
      // cleared at the top of the tile: no accumulator is alive across the
      // statistics of the next panel
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      float vals[4][4];
      uint32_t ch[4][4], cl[4][4];
      load_vals(it, 0, vals);
      for (int kt = 0; kt < nk; ++kt, ++it) {
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_split(vals[k8][i], ch[k8][i], cl[k8][i]);
        const int sp = (int)(it & 1);
        mbar_wait(split_full + 8 * sp, (it >> 1) & 1);
        const uint32_t bh = split + sp * TG_SPLIT_STAGE, bl = bh + TG_TILE;
        wgmma_fence();
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8) {
          wgmma_m64n128k8_tf32_ra(acc, cl[k8], wgmma_desc(bh + 32 * k8, 16, 1024), 1);
          wgmma_m64n128k8_tf32_ra(acc, ch[k8], wgmma_desc(bl + 32 * k8, 16, 1024), 1);
          wgmma_m64n128k8_tf32_ra(acc, ch[k8], wgmma_desc(bh + 32 * k8, 16, 1024), 1);
        }
        wgmma_commit();
        // the next stage's values while the tensor cores run
        if (kt + 1 < nk) load_vals(it + 1, kt + 1, vals);
        wgmma_wait<0>();
        wgmma_settle(acc);
#pragma unroll
        for (int k8 = 0; k8 < 4; ++k8) {
          wgmma_settle(ch[k8]);
          wgmma_settle(cl[k8]);
        }
        mbar_arrive(split_empty + 8 * sp);
      }
      // epilogue: acc[4j + 2hr + e] is row r_loc + 8 hr, column 8j + 2q + e
      float* out = static_cast<float*>(g.out);
      const float* bias = static_cast<const float*>(g.bias);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + r_loc + 8 * hr;
        if (m >= g.M) continue;
        const float* res_row = nullptr;
        if (EPI == EPI_RESIDUAL) {
          const int s = m % g.S;
          res_row = (g.plane != nullptr && g.pmask[s] > 0.f)
                        ? static_cast<const float*>(g.plane) + (size_t)s * g.N
                        : static_cast<const float*>(g.res) + (size_t)m * g.N;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n >= g.N) continue;  // N % 8 == 0: n + 1 < N too
          const float v0 = tg_epi<EPI>(acc[4 * j + 2 * hr], bias[n], res_row, n);
          const float v1 = tg_epi<EPI>(acc[4 * j + 2 * hr + 1], bias[n + 1], res_row, n + 1);
          *reinterpret_cast<float2*>(out + (size_t)m * g.N + n) = make_float2(v0, v1);
        }
      }
    }
  }
}

// 2-D map of a row-major (rows, cols) bf16 matrix, box (box_rows, 64 columns)
int matrix_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * sizeof(bf16)};
  const uint32_t box[2] = {64u, (uint32_t)box_rows};
  return encode_bf16_map(map, p, 2, dims, strides, box);
}

// SMs of the current device, cached per device
int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int counts[MAX_DEVICES] = {0};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < MAX_DEVICES && counts[dev] > 0) return counts[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < MAX_DEVICES) counts[dev] = n;
  return n;
}

template <bool LN, int MT, int EPI>
int launch_gemm_bf16(const GemmArgs& g, cudaStream_t stream) {
  using Sh = GemmShape<LN, MT>;
  if (g.M == 0) return 0;
  CUtensorMap map_a, map_w;
  int rc = matrix_map(&map_w, g.w, g.K, g.N, Sh::BK);
  if (rc != 0) return rc;
  if (LN)
    map_a = map_w;  // unused: the A panel is written by the block itself
  else if ((rc = matrix_map(&map_a, g.a, g.M, g.K, Sh::ROWS)) != 0)
    return rc;
  const int smem = Sh::smem_bytes(g.K);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gemm_bf16_kernel<LN, MT, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (g.N + TBN - 1) / TBN, row_tiles = (g.M + Sh::ROWS - 1) / Sh::ROWS;
  // persistent blocks: at most one per SM (shared memory allows no more)
  const int grid = (int)min((long long)row_tiles * n_tiles, (long long)sm_count());
  kernel<<<grid, Sh::THREADS, smem, stream>>>(map_a, map_w, g);
  return (int)cudaGetLastError();
}

template <bool LN, int EPI>
int launch_gemm_tf32x3(const GemmArgs& g, cudaStream_t stream) {
  if (g.M == 0) return 0;
  // A: (M, K), box of 32 columns (one 128-byte row) x 128 rows, swizzled as
  // the consumers read it; W: (K, N) as stored, box of 128 columns x 32 rows
  CUtensorMap map_a, map_w;
  const uint64_t a_dims[2] = {(uint64_t)g.K, (uint64_t)g.M}, a_strides[1] = {(uint64_t)g.K * 4};
  const uint32_t a_box[2] = {(uint32_t)TG_BK, (uint32_t)TG_BM};
  int rc = encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_128B, g.a, 2,
                      a_dims, a_strides, a_box);
  if (rc != 0) return rc;
  const uint64_t w_dims[2] = {(uint64_t)g.N, (uint64_t)g.K}, w_strides[1] = {(uint64_t)g.N * 4};
  const uint32_t w_box[2] = {(uint32_t)TG_BN, (uint32_t)TG_BK};
  if ((rc = encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, g.w,
                       2, w_dims, w_strides, w_box)) != 0)
    return rc;
  auto kernel = gemm_tf32x3_kernel<LN, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TG_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (g.N + TG_BN - 1) / TG_BN, cpp = LN ? (n_tiles + 2) / 3 : n_tiles;
  const long long chunks = (long long)((g.M + TG_BM - 1) / TG_BM) * cpp;
  // persistent blocks, one per SM (shared memory allows no more)
  const int grid = (int)min(chunks, (long long)sm_count());
  kernel<<<grid, TG_THREADS, TG_SMEM, stream>>>(map_a, map_w, g);
  return (int)cudaGetLastError();
}

template <bool LN>
int launch_gemm(const GemmArgs& g, bool is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    if constexpr (!LN) {
      if (g.epi == EPI_RESIDUAL) return launch_gemm_bf16<false, 2, EPI_RESIDUAL>(g, stream);
      if (g.epi == EPI_GELU) return launch_gemm_bf16<false, 2, EPI_GELU>(g, stream);
      return launch_gemm_bf16<false, 2, EPI_BIAS>(g, stream);
    } else {
      // a 128-row panel of K <= 768 fits beside the ring; wider rows take 64 rows
      if (g.epi == EPI_GELU)
        return g.K <= 768 ? launch_gemm_bf16<true, 2, EPI_GELU>(g, stream)
                          : launch_gemm_bf16<true, 1, EPI_GELU>(g, stream);
      return g.K <= 768 ? launch_gemm_bf16<true, 2, EPI_BIAS>(g, stream)
                        : launch_gemm_bf16<true, 1, EPI_BIAS>(g, stream);
    }
  }
  if (g.epi == EPI_GELU) return launch_gemm_tf32x3<LN, EPI_GELU>(g, stream);
  if constexpr (!LN) {
    if (g.epi == EPI_RESIDUAL) return launch_gemm_tf32x3<false, EPI_RESIDUAL>(g, stream);
  }
  return launch_gemm_tf32x3<LN, EPI_BIAS>(g, stream);
}

// ---------------------------------------------------------------------------
// mha_core for S <= 256: whole-row softmax attention, dh = 64. q, k and v:
// element (b, s, h, d) at base + (b*S + s)*ld + h*64 + d; out: (B, S, H*64)
// contiguous. bf16: one block per (head, image) on TMA-staged tiles; fp32: one
// block per (query tile of 64 rows, head, image), four warps of 16 query rows
// each, K and V of the head for the whole sequence in shared memory.
// ---------------------------------------------------------------------------

constexpr int DH = 64;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---- bf16: whole heads, TMA-staged operands, wgmma -----------------------------
//
// Persistent blocks of two warpgroups; a block walks the (image, head) pairs
// blockIdx.x, + gridDim.x, ... Shared memory (1024-byte aligned base): two
// buffers, each Q, K and V of one head as [rows64][128 bytes] swizzled tiles
// (rows64 = S rounded up to 64; rows past S arrive as zeros); the additive
// mask when it is staged; per buffer three barriers (Q and K landed; V
// landed; both warpgroups done). Thread 0 asks for the next head before the
// work on this one starts, so the load runs under it. Warpgroup w
// takes the 64-row query tiles w, w + 2. Per tile: S = Q K^T for all keys at
// once, in pieces of 64 keys (wgmma m64n64k16, both operands from shared
// memory), so a thread holds the whole of rows g and g + 8 of its warp's 16
// rows in up to 128 registers; the softmax there (reduced across the quad);
// then O = P V (wgmma m64n64k16, P from registers in bf16, V as the
// transposed B operand). Two waits on the tensor cores per tile.

constexpr int ATT_THREADS_BF16 = 256, ATT_PIECE = 64;
constexpr int ATT_MASK_SMEM = 32 * 1024;  // the largest mask staged beside the two buffers

__host__ __device__ inline int attention_bf16_tile_bytes(int S) { return round_up(S, 64) * 128; }

__global__ void __launch_bounds__(ATT_THREADS_BF16, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ mask, bf16* __restrict__ out, int B, int S,
                      int H, float scale, int fast, int stage_mask) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const int tile_bytes = attention_bf16_tile_bytes(S);
  const int mask_bytes = stage_mask ? round_up(S * S * 4, 16) : 0;
  float* smask = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * tile_bytes);
  // barriers of buffer u: bars + 8u (Q, K), + 16 + 8u (V), + 32 + 8u (drained)
  const uint32_t bars = base + 6 * tile_bytes + mask_bytes;
  const int D = H * DH, n_items = B * H;

  if (threadIdx.x == 0) {
    for (int u = 0; u < 2; ++u) {
      mbar_init(bars + 8 * u, 1);
      mbar_init(bars + 16 + 8 * u, 1);
      mbar_init(bars + 32 + 8 * u, 2);
    }
    mbar_init_fence();
  }
  if (stage_mask) {
    for (int i = threadIdx.x; i < S * S; i += ATT_THREADS_BF16) smask[i] = mask[i];
    mask = smask;
  }
  __syncthreads();

  // thread 0 asks for the block's head number i (pair w) once both warpgroups
  // have left the buffer it goes into
  auto request = [&](int i, int w) {
    const int u = i & 1, h = w % H, b = w / H;
    const uint32_t buf = base + u * 3 * tile_bytes;
    mbar_wait(bars + 32 + 8 * u, ((i >> 1) & 1) ^ 1);
    mbar_arrive_expect_tx(bars + 8 * u, 2 * tile_bytes);
    tma_load_3d(buf, &map_q, bars + 8 * u, h * DH, 0, b);
    tma_load_3d(buf + tile_bytes, &map_k, bars + 8 * u, h * DH, 0, b);
    mbar_arrive_expect_tx(bars + 16 + 8 * u, tile_bytes);
    tma_load_3d(buf + 2 * tile_bytes, &map_v, bars + 16 + 8 * u, h * DH, 0, b);
  };
  if (threadIdx.x == 0) request(0, blockIdx.x);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int n_pieces = (S + ATT_PIECE - 1) / ATT_PIECE;

  for (int it = 0, w = blockIdx.x; w < n_items; ++it, w += gridDim.x) {
    const int u = it & 1, h = w % H, b = w / H;
    const uint32_t phase = (it >> 1) & 1;
    const uint32_t sQ = base + u * 3 * tile_bytes, sK = sQ + tile_bytes, sV = sK + tile_bytes;
    // the next head loads under the work on this one
    if (threadIdx.x == 0 && w + gridDim.x < n_items) request(it + 1, w + gridDim.x);
    mbar_wait(bars + 8 * u, phase);
    bool v_ready = false;

    for (int qt = wg; qt * 64 < S; qt += 2) {
      const int row[2] = {qt * 64 + warp * 16 + g, qt * 64 + warp * 16 + g + 8};
      const float* mrow[2] = {nullptr, nullptr};
      if (mask != nullptr) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) mrow[hr] = mask + (size_t)min(row[hr], S - 1) * S;
      }

      // raw scores: key 64p + 8j + 2q + (e & 1) of row[e >> 1] in sc[p][4j + e]
      float sc[4][32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= n_pieces) continue;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          wgmma_m64n64k16(sc[p], wgmma_desc(sQ + qt * 8192 + 32 * ks, 16, 1024),
                          wgmma_desc(sK + p * 8192 + 32 * ks, 16, 1024), ks != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < 4; ++p) wgmma_settle(sc[p]);

      // logits s * scale + mask in place (the caller passes both in log2e units
      // when fast); padded columns hold -FLT_MAX: weight 0 below. Only the last
      // piece has padded columns, only the text tower a mask: the common piece
      // is one multiply per score.
      auto logits = [&](int p, auto masked, auto ragged) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = ATT_PIECE * p + 8 * (i >> 2) + 2 * q + (i & 1);
          float v = sc[p][i] * scale;
          if (decltype(masked)::value) v += mrow[(i >> 1) & 1][col];
          if (decltype(ragged)::value && col >= S) v = -3.402823466e38f;
          sc[p][i] = v;
        }
      };
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= n_pieces) continue;
        const bool ragged = ATT_PIECE * (p + 1) > S;
        if (mask != nullptr) {
          if (ragged) logits(p, std::true_type{}, std::true_type{});
          else logits(p, std::true_type{}, std::false_type{});
        } else {
          if (ragged) logits(p, std::false_type{}, std::true_type{});
          else logits(p, std::false_type{}, std::false_type{});
        }
      }

      // exact: the row max (two running maxima per row, then the quad), taken
      // into the exponent in log2e units
      float mx[2] = {0.f, 0.f};
      if (!fast) {
        float m2[2][2] = {{-3.402823466e38f, -3.402823466e38f},
                          {-3.402823466e38f, -3.402823466e38f}};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p >= n_pieces) continue;
#pragma unroll
          for (int i = 0; i < 32; ++i)
            m2[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(m2[(i >> 1) & 1][(i >> 2) & 1], sc[p][i]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mx[hr] = fmaxf(m2[hr][0], m2[hr][1]);
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
          mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        }
      }

      // probabilities, 2^min(v, 120) when fast and e^(v - max) = 2^((v - max)
      // log2(e)) when exact, their fp32 row sums (two running sums per row), and
      // the bf16 pairs that are the A operand of P V
      float d2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      uint32_t pk[4][16];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= n_pieces) continue;
        if (fast) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[p][i] = ex2_approx(fminf(sc[p][i], 120.f));
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[p][i] = ex2_approx((sc[p][i] - mx[(i >> 1) & 1]) * 1.4426950408889634f);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) d2[(i >> 1) & 1][(i >> 2) & 1] += sc[p][i];
#pragma unroll
        for (int i = 0; i < 16; ++i) pk[p][i] = pack_bf16(sc[p][2 * i], sc[p][2 * i + 1]);
      }
      float denom[2] = {d2[0][0] + d2[0][1], d2[1][0] + d2[1][1]};

      // O = P V: 16 keys per step; step ks of piece p takes pk[p][4ks .. 4ks + 3]
      if (!v_ready) {
        mbar_wait(bars + 16 + 8 * u, phase);
        v_ready = true;
      }
      float o[32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= n_pieces) continue;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t pa[4] = {pk[p][4 * ks], pk[p][4 * ks + 1], pk[p][4 * ks + 2],
                                  pk[p][4 * ks + 3]};
          wgmma_m64n64k16_ra_tb(o, pa, wgmma_desc(sV + (ATT_PIECE * p + 16 * ks) * 128, 16, 1024),
                                (p | ks) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_settle(o);
#pragma unroll
      for (int p = 0; p < 4; ++p) wgmma_settle(pk[p]);

      // scale by the row reciprocal, cast, 16-byte stores into (B, S, D)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 1);
        denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 2);
        if (fast) denom[hr] = fmaxf(denom[hr], 1e-30f);
        const float rc = 1.f / denom[hr];
#pragma unroll
        for (int j0 = 0; j0 < DH / 8; j0 += 4) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(o[4 * (j0 + i) + 2 * hr] * rc, o[4 * (j0 + i) + 2 * hr + 1] * rc);
          quad_transpose(v, q);
          if (row[hr] < S)
            *reinterpret_cast<uint4*>(out + ((size_t)b * S + row[hr]) * D + h * DH +
                                      8 * (j0 + q)) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    // this warpgroup has read the buffer for the last time
    if (tid == 0) mbar_arrive(bars + 32 + 8 * u);
  }
}

// 3-D map of one of q, k, v: element (b, s, column) at base + (b*S + s)*ld +
// column, H*64 columns; a box is one head (64 columns) of `rows` tokens of
// one image, tokens past S read as zeros
int head_map(CUtensorMap* map, const void* p, int B, int S, int H, int ld, int rows) {
  const uint64_t dims[3] = {(uint64_t)H * DH, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * sizeof(bf16), (uint64_t)S * ld * sizeof(bf16)};
  const uint32_t box[3] = {(uint32_t)DH, (uint32_t)rows, 1u};
  return encode_bf16_map(map, p, 3, dims, strides, box);
}

// ---------------------------------------------------------------------------
// mha_core for S > 256 (the vehicle geometry: 442 to 444 tokens): a loop over
// key tiles of 64, so that no whole row of scores lives in registers or shared
// memory. Same operands, same arithmetic and rounding points as the whole-row
// kernels above, which keep every S <= 256.
//
// Exact softmax: an online maximum. Each key tile raises the running row
// maximum m, and the output accumulator and the row sum are rescaled by
// e^(m_old - m_new) before the tile is added. The other way, a first pass over
// Q K^T for the maximum and a second for the probabilities, costs half again
// as many tensor-core operations and reads K twice; the rescale costs one
// multiply per accumulator element and tile. The probabilities of a tile are
// rounded to bf16 against the running maximum rather than the final one: a
// relative rounding, so the result stays within one bf16 rounding of the
// plain version's.
// Fast softmax: 2^min(s + mask, 120) needs no maximum, so the row sum and P V
// just accumulate over the tiles.
// Padded key columns (the last tile is ragged: 442 = 6 x 64 + 58; TMA fills
// the rows past S with zeros, which would score 0, not weigh 0) are set to
// -FLT_MAX and weigh 0. An additive mask is read tile by tile from device
// memory: a (444, 444) fp32 mask does not fit in shared memory.
// ---------------------------------------------------------------------------

// ---- bf16: TMA ring of K/V tiles, wgmma, two query tiles per block ---------
//
// One block per (128 query rows, head, image), the query tiles of a head
// adjacent in the grid so that its K and V stay in L2. Two warpgroups, each
// 64 query rows (a warpgroup whose rows all lie past S exits). Shared memory
// (1024-byte aligned base): Q, two [64 rows][128 bytes] swizzled tiles; a ring
// of ATL_STAGES stages, each the K tile and the V tile of 64 keys; the
// barriers (Q landed; per stage: filled, drained by every warpgroup). Thread 0
// fills the ring at the start and refills a stage once both warpgroups have
// left it. Per key tile and warpgroup: S = Q K^T (wgmma m64n64k16, operands
// from shared memory), the softmax step on the 2 x 16 scores a thread holds,
// O += P V (P from registers in bf16, V as the transposed B operand). About
// 83 KB of shared memory and 127 registers (ptxas, under a launch bound that
// asks for one block per SM), so two blocks share an SM and one block's waits
// hide under the other's work.

constexpr int ATL_THREADS = 256, ATL_STAGES = 4, ATL_TILE = 64 * 128;

__host__ __device__ constexpr int attention_long_bf16_smem() {
  return 1024 + 2 * ATL_TILE + ATL_STAGES * 2 * ATL_TILE + 8 * (1 + 2 * ATL_STAGES);
}

__global__ void __launch_bounds__(ATL_THREADS, 1)
attention_long_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const float* __restrict__ mask, bf16* __restrict__ out, int B,
                           int S, int H, float scale, int fast) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, ring = base + 2 * ATL_TILE;
  const uint32_t qbar = ring + ATL_STAGES * 2 * ATL_TILE, full = qbar + 8,
                 empty = full + 8 * ATL_STAGES;
  const int nq = (S + 127) / 128, D = H * DH;
  const int q0 = (int)(blockIdx.x % nq) * 128, h = (int)(blockIdx.x / nq) % H,
            b = (int)(blockIdx.x / nq) / H;
  const int n_tiles = (S + 63) / 64;
  const int active = q0 + 64 < S ? 2 : 1;  // warpgroups with a query row below S

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < ATL_STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, active);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0: key tile t (keys 64t ..; rows past S arrive as zeros) into its stage
  auto fill = [&](int t) {
    const int st = t % ATL_STAGES;
    const uint32_t dst = ring + st * 2 * ATL_TILE;
    mbar_arrive_expect_tx(full + 8 * st, 2 * ATL_TILE);
    tma_load_3d(dst, &map_k, full + 8 * st, h * DH, 64 * t, b);
    tma_load_3d(dst + ATL_TILE, &map_v, full + 8 * st, h * DH, 64 * t, b);
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qbar, active * ATL_TILE);
    for (int w = 0; w < active; ++w)
      tma_load_3d(sQ + w * ATL_TILE, &map_q, qbar, h * DH, q0 + 64 * w, b);
    for (int t = 0; t < n_tiles && t < ATL_STAGES; ++t) fill(t);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  if (wg >= active) return;  // no block-wide barrier follows
  const int g = lane >> 2, q = lane & 3;
  const int row[2] = {q0 + 64 * wg + 16 * warp + g, q0 + 64 * wg + 16 * warp + g + 8};
  const float* mrow[2] = {nullptr, nullptr};
  if (mask != nullptr) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mrow[hr] = mask + (size_t)min(row[hr], S - 1) * S;
  }
  const uint32_t sQw = sQ + wg * ATL_TILE;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-3.402823466e38f, -3.402823466e38f}, denom[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % ATL_STAGES;
    const uint32_t phase = (t / ATL_STAGES) & 1;
    const uint32_t sK = ring + st * 2 * ATL_TILE, sV = sK + ATL_TILE;
    mbar_wait(full + 8 * st, phase);

    // raw scores: key 64t + 8j + 2q + (e & 1) of row[e >> 1] in sc[4j + e]
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      wgmma_m64n64k16(sc, wgmma_desc(sQw + 32 * ks, 16, 1024),
                      wgmma_desc(sK + 32 * ks, 16, 1024), ks != 0);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(sc);

    // logits s * scale + mask in place (both in log2e units when fast); padded
    // columns hold -FLT_MAX: weight 0 below
    auto logits = [&](auto masked, auto ragged) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 64 * t + 8 * (i >> 2) + 2 * q + (i & 1);
        float v = sc[i] * scale;
        if (decltype(ragged)::value && col >= S) v = -3.402823466e38f;
        else if (decltype(masked)::value) v += mrow[(i >> 1) & 1][col];
        sc[i] = v;
      }
    };
    const bool ragged = 64 * (t + 1) > S;
    if (mask != nullptr) {
      if (ragged) logits(std::true_type{}, std::true_type{});
      else logits(std::true_type{}, std::false_type{});
    } else {
      if (ragged) logits(std::false_type{}, std::true_type{});
      else logits(std::false_type{}, std::false_type{});
    }

    if (fast) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ex2_approx(fminf(sc[i], 120.f));
    } else {
      // the running maximum (two partial maxima per row, then the quad), and
      // what the earlier tiles' sums shrink by
      float m2[2][2] = {{-3.402823466e38f, -3.402823466e38f},
                        {-3.402823466e38f, -3.402823466e38f}};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        m2[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(m2[(i >> 1) & 1][(i >> 2) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = fmaxf(m2[hr][0], m2[hr][1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, m_run[hr]);
        alpha[hr] = ex2_approx((m_run[hr] - mx) * 1.4426950408889634f);
        m_run[hr] = mx;
        denom[hr] *= alpha[hr];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[i] *= alpha[(i >> 1) & 1];
        sc[i] = ex2_approx((sc[i] - m_run[(i >> 1) & 1]) * 1.4426950408889634f);
      }
    }
    // fp32 row sums (two partial sums per row) and the bf16 pairs that are the
    // A operand of P V
    float d2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    uint32_t pk[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) d2[(i >> 1) & 1][(i >> 2) & 1] += sc[i];
#pragma unroll
    for (int i = 0; i < 16; ++i) pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    denom[0] += d2[0][0] + d2[0][1];
    denom[1] += d2[1][0] + d2[1][1];

    // O += P V: 16 keys per step, step ks takes pk[4ks .. 4ks + 3]
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {pk[4 * ks], pk[4 * ks + 1], pk[4 * ks + 2], pk[4 * ks + 3]};
      wgmma_m64n64k16_ra_tb(o, pa, wgmma_desc(sV + 16 * ks * 128, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(o);
    wgmma_settle(pk);

    // this warpgroup has left the stage; thread 0 refills it once all have
    if (tid == 0) mbar_arrive(empty + 8 * st);
    if (threadIdx.x == 0 && t + ATL_STAGES < n_tiles) {
      mbar_wait(empty + 8 * st, phase);
      fill(t + ATL_STAGES);
    }
  }

  // scale by the row reciprocal, cast, 16-byte stores into (B, S, D)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 1);
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 2);
    if (fast) denom[hr] = fmaxf(denom[hr], 1e-30f);
    const float rc = 1.f / denom[hr];
#pragma unroll
    for (int j0 = 0; j0 < DH / 8; j0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = pack_bf16(o[4 * (j0 + i) + 2 * hr] * rc, o[4 * (j0 + i) + 2 * hr + 1] * rc);
      quad_transpose(v, q);
      if (row[hr] < S)
        *reinterpret_cast<uint4*>(out + ((size_t)b * S + row[hr]) * D + h * DH +
                                  8 * (j0 + q)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---- fp32: one key-tile kernel for every S, 3xTF32 on wgmma -------------------
//
// One block per (128 query rows, head, image), the query tiles of a head
// adjacent in the grid so that its K and V stay in L2; two warpgroups of 64
// query rows (one whose rows all lie past S computes nothing but still
// splits and meets the barriers). The block splits Q once, from the strided
// view, into hi and lo K-major tiles (dh 64 = two 128-byte swizzled column
// blocks). K and V tiles of 64 keys come by TMA from the strided views into
// a ring of two raw stages (rows past S arrive as zeros); per tile all 256
// threads split K (K-major as stored) and V into hi and lo, V transposed
// (rows of the head dimension, 64 keys each: P V takes V as its K-major B
// operand), then both warpgroups run S = Q K^T and O += P V, each product
// three TF32 passes (lo*hi, hi*lo, hi*hi) on wgmma m64n64k8: Q and K from
// shared memory, P from registers, split there. P's register fragment holds
// keys 8j + 2q and 8j + 2q + 1 where the wgmma layout expects K columns q
// and q + 4, so the split of V stores the keys of each group of 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7: the sum over keys is the same, and no
// shuffle is needed. Online softmax in fp32 with late normalisation (expf
// when exact; exp2f(min(s, 120)) with the 1e-30 floor when fast), padded keys
// at -FLT_MAX, the additive (S, S) mask read tile by tile (the text tower's
// causal S = 77 takes it).

constexpr int TA_THREADS = 256, TA_KT = 64;
constexpr int TA_Q = 128 * 128;           // one column block of Q: 128 rows x 128 bytes
constexpr int TA_KV = 64 * 128;           // one column block of a K or Vt tile
constexpr int TA_RAW = 2 * 64 * 64 * 4;   // a raw stage: K tile | V tile, 64 x 64 fp32 each
constexpr int TA_SMEM = 1024 + 4 * TA_Q + 2 * TA_RAW + 8 * TA_KV + 16;

__global__ void __launch_bounds__(TA_THREADS, 1)
attention_tf32x3_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, int ld,
                        const float* __restrict__ mask, float* __restrict__ out, int S, int H,
                        float scale, int fast) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  // Q hi | Q lo (each two column blocks), the raw ring, K hi | K lo | Vt hi | Vt lo
  const uint32_t s_q = base, s_raw = base + 4 * TA_Q, s_kv = s_raw + 2 * TA_RAW;
  unsigned char* const g_q = gbase;
  unsigned char* const g_raw = gbase + 4 * TA_Q;
  unsigned char* const g_kv = g_raw + 2 * TA_RAW;
  const uint32_t bars = s_kv + 8 * TA_KV;  // raw stage landed, per stage
  const int nq = (S + 127) / 128, D = H * DH;
  const int q0 = (int)(blockIdx.x % nq) * 128, h = (int)(blockIdx.x / nq) % H,
            b = (int)(blockIdx.x / nq) / H;
  const int n_tiles = (S + TA_KT - 1) / TA_KT;
  const int tid_b = threadIdx.x;

  if (tid_b == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int t) {  // thread 0: key tile t into its raw stage
    const int st = t & 1;
    const uint32_t dst = s_raw + st * TA_RAW;
    mbar_arrive_expect_tx(bars + 8 * st, TA_RAW);
    tma_load_3d(dst, &map_k, bars + 8 * st, h * DH, TA_KT * t, b);
    tma_load_3d(dst + TA_RAW / 2, &map_v, bars + 8 * st, h * DH, TA_KT * t, b);
  };
  if (tid_b == 0) {
    for (int t = 0; t < n_tiles && t < 2; ++t) fill(t);
  }

  // Q: row r (query q0 + r), 16-byte chunk c (head columns 4c ..): split into
  // column block c / 8 of Q hi and Q lo, swizzled
  const size_t head = (size_t)b * S * ld + (size_t)h * DH;
  for (int u = tid_b; u < 128 * 16; u += TA_THREADS) {
    const int r = u >> 4, c = u & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) v = *reinterpret_cast<const float4*>(q + head + (size_t)(q0 + r) * ld + 4 * c);
    uint32_t hi[4], lo[4];
    tf32_split(v.x, hi[0], lo[0]);
    tf32_split(v.y, hi[1], lo[1]);
    tf32_split(v.z, hi[2], lo[2]);
    tf32_split(v.w, hi[3], lo[3]);
    const int off = (c >> 3) * TA_Q + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(g_q + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(g_q + 2 * TA_Q + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  const int wg = tid_b / 128, tid = tid_b % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, qq = lane & 3;
  const bool active = q0 + 64 * wg < S;
  const int row[2] = {q0 + 64 * wg + 16 * warp + gq, q0 + 64 * wg + 16 * warp + gq + 8};
  const float* mrow[2] = {nullptr, nullptr};
  if (mask != nullptr) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mrow[hr] = mask + (size_t)min(row[hr], S - 1) * S;
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-3.402823466e38f, -3.402823466e38f}, denom[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    mbar_wait(bars + 8 * st, (uint32_t)((t >> 1) & 1));
    __syncthreads();  // both warpgroups are done with the previous tile's split operands
    const unsigned char* kr = g_raw + st * TA_RAW;
    const float* vr = reinterpret_cast<const float*>(kr + TA_RAW / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // K: key n, chunk c of 4 head columns -> row n of K hi / K lo
      const int u = tid_b + TA_THREADS * i, n = u >> 4, c = u & 15;
      const float4 v = *reinterpret_cast<const float4*>(kr + n * 256 + 16 * c);
      uint32_t hi[4], lo[4];
      tf32_split(v.x, hi[0], lo[0]);
      tf32_split(v.y, hi[1], lo[1]);
      tf32_split(v.z, hi[2], lo[2]);
      tf32_split(v.w, hi[3], lo[3]);
      const int off = (c >> 3) * TA_KV + n * 128 + (((c & 7) ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(g_kv + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(g_kv + 2 * TA_KV + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      // Vt: head column d, key slots 4 sc .. 4 sc + 3 = keys 8 (sc / 2) + (sc & 1) + 0, 2, 4, 6
      const int d = tid_b & 63, sc = (tid_b >> 6) + 4 * i;
      const int k0 = 8 * (sc >> 1) + (sc & 1);
      float vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = vr[(k0 + 2 * e) * DH + d];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(vv[e], hi[e], lo[e]);
      const int voff = (sc >> 3) * TA_KV + d * 128 + (((sc & 7) ^ (d & 7)) << 4);
      *reinterpret_cast<uint4*>(g_kv + 4 * TA_KV + voff) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(g_kv + 6 * TA_KV + voff) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();
    __syncthreads();  // the split operands are complete; the raw stage is free
    if (tid_b == 0 && t + 2 < n_tiles) {
      fence_proxy_async();
      fill(t + 2);
    }
    if (!active) continue;

    // raw scores: key 64t + 8j + 2qq + (e & 1) of row[e >> 1] in sc[4j + e]
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks) {
      const uint32_t qa = s_q + (ks >> 2) * TA_Q + wg * 64 * 128 + 32 * (ks & 3);
      const uint32_t kb = s_kv + (ks >> 2) * TA_KV + 32 * (ks & 3);
      wgmma_m64n64k8_tf32(sc, wgmma_desc(qa + 2 * TA_Q, 16, 1024), wgmma_desc(kb, 16, 1024),
                          ks != 0);
      wgmma_m64n64k8_tf32(sc, wgmma_desc(qa, 16, 1024),
                          wgmma_desc(kb + 2 * TA_KV, 16, 1024), 1);
      wgmma_m64n64k8_tf32(sc, wgmma_desc(qa, 16, 1024), wgmma_desc(kb, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(sc);

    // logits s * scale + mask in place (both in log2e units when fast); padded
    // key columns hold -FLT_MAX: weight 0 below
    const bool ragged = TA_KT * (t + 1) > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = TA_KT * t + 8 * (i >> 2) + 2 * qq + (i & 1);
      float v = sc[i] * scale;
      if (ragged && col >= S) v = -3.402823466e38f;
      else if (mask != nullptr) v += mrow[(i >> 1) & 1][col];
      sc[i] = v;
    }
    if (fast) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = exp2f(fminf(sc[i], 120.f));
    } else {
      // the running maximum (two partial maxima per row, then the quad), and
      // what the earlier tiles' sums shrink by
      float m2[2][2] = {{-3.402823466e38f, -3.402823466e38f},
                        {-3.402823466e38f, -3.402823466e38f}};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        m2[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(m2[(i >> 1) & 1][(i >> 2) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = fmaxf(m2[hr][0], m2[hr][1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, m_run[hr]);
        alpha[hr] = expf(m_run[hr] - mx);
        m_run[hr] = mx;
        denom[hr] *= alpha[hr];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[i] *= alpha[(i >> 1) & 1];
        sc[i] = expf(sc[i] - m_run[(i >> 1) & 1]);
      }
    }
    // fp32 row sums (two partial sums per row), and P split into the
    // register fragments of P V: step j takes keys 8j .. 8j + 7 in the order
    // the split of V stored them
    float d2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 32; ++i) d2[(i >> 1) & 1][(i >> 2) & 1] += sc[i];
    denom[0] += d2[0][0] + d2[0][1];
    denom[1] += d2[1][0] + d2[1][1];
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tf32_split(sc[4 * j], ph[j][0], pl[j][0]);
      tf32_split(sc[4 * j + 2], ph[j][1], pl[j][1]);
      tf32_split(sc[4 * j + 1], ph[j][2], pl[j][2]);
      tf32_split(sc[4 * j + 3], ph[j][3], pl[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t vb = s_kv + 4 * TA_KV + (j >> 2) * TA_KV + 32 * (j & 3);
      wgmma_m64n64k8_tf32_ra(o, pl[j], wgmma_desc(vb, 16, 1024), 1);
      wgmma_m64n64k8_tf32_ra(o, ph[j], wgmma_desc(vb + 2 * TA_KV, 16, 1024), 1);
      wgmma_m64n64k8_tf32_ra(o, ph[j], wgmma_desc(vb, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(o);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wgmma_settle(ph[j]);
      wgmma_settle(pl[j]);
    }
  }
  if (!active) return;

  // scale by the row reciprocal, fp32 stores into (B, S, D)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 1);
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 2);
    if (fast) denom[hr] = fmaxf(denom[hr], 1e-30f);
    const float rc = 1.f / denom[hr];
    if (row[hr] >= S) continue;
    float* dst = out + ((size_t)b * S + row[hr]) * D + h * DH + 2 * qq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * hr] * rc, o[4 * j + 2 * hr + 1] * rc);
  }
}

// 3-D fp32 map of k or v: element (b, s, column) at base + (b*S + s)*ld +
// column, H*64 columns; a box is one head (64 columns) of 64 tokens of one
// image, tokens past S read as zeros; no swizzle (the block splits the tile)
int head_map_f32(CUtensorMap* map, const void* p, int B, int S, int H, int ld) {
  const uint64_t dims[3] = {(uint64_t)H * DH, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * sizeof(float), (uint64_t)S * ld * sizeof(float)};
  const uint32_t box[3] = {(uint32_t)DH, (uint32_t)TA_KT, 1u};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, p, 3, dims,
                    strides, box);
}

int launch_attention_tf32x3(const void* q, const void* k, const void* v, int ld,
                            const float* mask, void* out, int B, int S, int H, float scale,
                            int fast, cudaStream_t stream) {
  if (B == 0 || S == 0) return 0;
  const long long blocks = (long long)((S + 127) / 128) * H * B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int rc;
  if ((rc = head_map_f32(&mk, k, B, S, H, ld)) != 0) return rc;
  if ((rc = head_map_f32(&mv, v, B, S, H, ld)) != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(attention_tf32x3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TA_SMEM);
  if (e != cudaSuccess) return (int)e;
  attention_tf32x3_kernel<<<(unsigned)blocks, TA_THREADS, TA_SMEM, stream>>>(
      static_cast<const float*>(q), mk, mv, ld, mask, static_cast<float*>(out), S, H, scale,
      fast);
  return (int)cudaGetLastError();
}

int launch_attention_long(const void* q, const void* k, const void* v, int ld,
                          const float* mask, void* out, int B, int S, int H, float scale,
                          int fast, cudaStream_t stream) {
  cudaError_t e;
  if (B == 0) return 0;
  const long long blocks = (long long)((S + 127) / 128) * H * B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = head_map(&mq, q, B, S, H, ld, 64)) != 0) return rc;
  if ((rc = head_map(&mk, k, B, S, H, ld, 64)) != 0) return rc;
  if ((rc = head_map(&mv, v, B, S, H, ld, 64)) != 0) return rc;
  e = cudaFuncSetAttribute(attention_long_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           attention_long_bf16_smem());
  if (e != cudaSuccess) return (int)e;
  attention_long_bf16_kernel<<<(unsigned)blocks, ATL_THREADS, attention_long_bf16_smem(),
                               stream>>>(mq, mk, mv, mask, static_cast<bf16*>(out), B, S, H,
                                         scale, fast);
  return (int)cudaGetLastError();
}

// In bf16 the whole-row kernel takes S <= 256 (a row of scores in
// registers), the key-tile kernel every longer sequence; fp32 runs its
// key-tile kernel for every S.
constexpr int ATT_WHOLE_ROW_MAX_S = 256;

int launch_attention(const void* q, const void* k, const void* v, int ld, const float* mask,
                     void* out, int B, int S, int H, float scale, int fast, int is_bf16,
                     cudaStream_t stream) {
  cudaError_t e;
  if (!is_bf16)
    return launch_attention_tf32x3(q, k, v, ld, mask, out, B, S, H, scale, fast, stream);
  if (S > ATT_WHOLE_ROW_MAX_S)
    return launch_attention_long(q, k, v, ld, mask, out, B, S, H, scale, fast, stream);
  if (B == 0 || S == 0) return 0;
  const int tile_bytes = attention_bf16_tile_bytes(S), rows = tile_bytes / 128;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = head_map(&mq, q, B, S, H, ld, rows)) != 0) return rc;
  if ((rc = head_map(&mk, k, B, S, H, ld, rows)) != 0) return rc;
  if ((rc = head_map(&mv, v, B, S, H, ld, rows)) != 0) return rc;
  const int mask_bytes = round_up(S * S * 4, 16);
  const int stage_mask = mask != nullptr && mask_bytes <= ATT_MASK_SMEM;
  const int bytes = 1024 + 6 * tile_bytes + (stage_mask ? mask_bytes : 0) + 48;
  e = cudaFuncSetAttribute(attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  attention_bf16_kernel<<<min(B * H, sm_count()), ATT_THREADS_BF16, bytes, stream>>>(
      mq, mk, mv, mask, static_cast<bf16*>(out), B, S, H, scale, fast, stage_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes; every pointer is a device pointer)
// ---------------------------------------------------------------------------

extern "C" {

// out = act(LN(splice(x)) @ w + bias); act = QuickGELU when gelu != 0.
// x (M = B*S, K), w (K, N), bias (N,), out (M, N) in the working type;
// ln_g/ln_b (K,) fp32, or both null: no LN, the rows are read as they are
// (and plane must be null); plane (S, K) and pmask (S,) fp32 or both null.
int ln_gemm(const void* x, const void* plane, const void* pmask, const void* ln_g,
            const void* ln_b, const void* w, const void* bias, void* out, int M, int N,
            int K, int S, int gelu, int dtype, void* stream) {
  GemmArgs g{x, w, bias, nullptr, plane, static_cast<const float*>(pmask),
             static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out,
             M, N, K, S, gelu ? EPI_GELU : EPI_BIAS};
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if ((ln_g == nullptr) != (ln_b == nullptr)) return (int)cudaErrorInvalidValue;
  if (ln_g == nullptr) {
    if (plane != nullptr) return (int)cudaErrorInvalidValue;
    return launch_gemm<false>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
  }
  return launch_gemm<true>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// out = a @ w + bias [+ splice(res)]. a (M, K), w (K, N), bias (N,), res and
// out (M, N); res null: no residual (and plane must be null); plane (S, N)
// and pmask (S,) fp32 or both null.
int gemm_bias_residual(const void* a, const void* w, const void* bias, const void* res,
                       const void* plane, const void* pmask, void* out, int M, int N,
                       int K, int S, int dtype, void* stream) {
  GemmArgs g{a, w, bias, res, plane, static_cast<const float*>(pmask), nullptr, nullptr,
             out, M, N, K, S, res != nullptr ? EPI_RESIDUAL : EPI_BIAS};
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if (res == nullptr && plane != nullptr) return (int)cudaErrorInvalidValue;
  return launch_gemm<false>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// q, k, v: (B, S, H, 64) with row stride ld (elements between consecutive
// tokens; batch stride S*ld) -> out (B, S, H*64) contiguous. mask: (S, S)
// fp32 additive mask (clamped to >= -1e30; in log2e units when fast) or null.
// bf16: S <= 256 runs the whole-row kernel, a longer sequence the key-tile
// kernel; fp32 runs its key-tile kernel for every S.
int mha_core(const void* q, const void* k, const void* v, int ld, const void* mask,
             void* out, int B, int S, int H, float scale, int fast, int dtype,
             void* stream) {
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  return launch_attention(q, k, v, ld, static_cast<const float*>(mask), out, B, S, H,
                          scale, fast, dtype == DTYPE_BF16,
                          static_cast<cudaStream_t>(stream));
}


const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
