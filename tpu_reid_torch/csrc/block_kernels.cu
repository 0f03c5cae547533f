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
//                       normalised rows rounded to the working type before
//                       the product; with a deep-prompt plane, spliced rows
//                       are read from the plane instead. Without LN
//                       parameters the rows are read as they are (fused_mha
//                       without pre-LN).
//   mha_core            softmax attention for any S, dh = 64 (bf16: whole score
//                       rows for S <= 256, a loop over key tiles beyond; fp32:
//                       key tiles for every S), and dh = 112 in bf16 for
//                       S <= 256 (whole score rows), on
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
//   * The A tiles come by TMA too, 256 rows per block (each consumer
//     warpgroup two 64-row accumulators of every stage), and blocks walk
//     the output tiles, so the ring fills for the next tile under a tile's
//     epilogue.
//   * In bf16 the LayerNorm runs before the product, in ln_rows (below):
//     each row read once, two-pass fp32 statistics, the fp32 affine, the
//     row written once in bf16 to the caller's scratch, which the product
//     then reads as its A: one launch more and one more read and write of
//     the rows. Every design that kept the LayerNorm inside the GEMM
//     measured slower at the serving shapes (PERF.md): a resident
//     normalised panel leaves W a ring of four 8 KB stages, A fragments
//     normalised in registers serialise wgmma for registers, and
//     normalisers beside the mainloop take its issue slots.
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
// EVA02's block (ops/fused_eva.py; bf16) runs the GEMM kernel in two more
// modes and one kernel of its own, each placed where it costs least:
//
//   * EPI_ROPE (qkv): after the epilogue's column exchange a thread holds 8
//     consecutive columns of a row, four whole (2p, 2p + 1) pairs of one
//     head, so the 2D rotary embedding is 8 multiply-adds on values in
//     registers and two 32-byte table reads (L1-resident, 167 KB), before
//     the one cast; both attention kernels then read q and k rotated as
//     they are. Rotating at mha_core's load instead would repeat the table
//     reads for every query tile on the attention's critical path.
//   * EPI_SWIGLU (gate | up): the weight is packed so that each 128-column
//     tile holds 64 gate columns and the matching 64 up columns; a thread
//     holds gate column c and up column c + 64 (accumulator groups j and
//     j + 8), so SiLU(gate) * up needs no exchange and u is written once, at
//     half the product's width.
//   * ln_rows: LN_1, LN_2, the attention output's sub-LN and the MLP's
//     sub-LN as passes of their own; its notes stand above it.
//
// EVA02-CLIP-E/14's post-norm block (ops/fused_eva_e.py; bf16) adds one GEMM
// mode, a mode of ln_rows and a head width:
//
//   * EPI_GELU_ERF (fc1): the exact GELU, erff on the 8 values a thread holds
//     after the column exchange, before the one cast.
//   * ln_rows' residual mode (ln_residual): out = res + LN(y), the post-norm
//     residual. Each row's statistics need all of its D columns, which no
//     128-column output tile of the product holds, so the products before
//     it (out-projection, fc2) write y with the bias alone and this pass
//     reads y and the residual once; the next block's deep-prompt rows are
//     stored in place of the sum (the splice on store: the post-norm block
//     has no pass before its qkv product to splice on load).
//   * attention_bf16_kernel<112> and attention_long_bf16_kernel<112> (S >
//     256: EVA-CLIP's own 224x224 input has 257 tokens): heads of 112 as two
//     64-column blocks; their notes stand above them.
//
// The fp32 route (the training CLIs' default dtype: every forward and every
// backward of every training step) runs two kernels of its own, both 3xTF32
// on wgmma: each operand split once into hi = tf32(x) and lo = tf32(x - hi),
// each k8 step lo*hi + hi*lo + hi*hi into one fp32 accumulator, so every product keeps
// ~22 of fp32's 24 mantissa bits at a third of the TF32 tensor-core rate
// (165 TF/s dense against the CUDA cores' 67 TF/s of fp32 FMA). What bounds
// them is that rate: the least time of an fp32-accurate product on this card
// is three TF32 passes.
//
//   * gemm_tf32x3_kernel behind ln_gemm and gemm_bias_residual; tf32 wgmma
//     reads its shared operands K-major only, so a splitter warpgroup
//     writes each TMA-loaded W tile transposed and split, while the
//     consumers take A from registers (LayerNorm and splice applied there,
//     before the split); its notes stand above it. The block's backward
//     (gemm_tf32x3_backward) runs the same kernel in four more modes: its
//     recompute's three products, and its eight gradient products (dgrad,
//     dgrad times QuickGELU', split-K wgrad, reading a forward weight or an
//     activation transposed by TMA), each stage's sum promoted to fp32.
//   * attention_tf32x3_kernel: mha_core for every S, flash-style over key
//     tiles of 64 with an online softmax; its notes stand above it. For the
//     block backward it also writes each row's log-sum-exp, and
//     mha_core_backward takes the gradient from there in two more kernels
//     (attention_tf32x3_kernel_bwd_dq, _bwd_dkv) that recompute the scores
//     tile by tile; their notes stand above them.
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
// the fp32 block backward's products (gemm_tf32x3_backward):
// EPI_DGRAD    out = a @ w^T, w given as (N, K): a forward product's weight
// EPI_DGELU    the same times QuickGELU'(res), res (M, N) the pre-activation,
//              and QuickGELU(res) into out2 where given
// EPI_WGRAD    out[split] = a^T @ w over one range of K, a given as (K, M)
// EPI_PRODUCT  out = a @ w + bias [+ res]: the recompute of a forward product
constexpr int EPI_DGRAD = 3, EPI_DGELU = 4, EPI_WGRAD = 5, EPI_PRODUCT = 6;
// the EVA02 block's modes (bf16, without the LayerNorm prologue: their
// input rows come normalised by ln_rows):
// EPI_SWIGLU   out (M, N / 2) = SiLU(gate) * up, gate and up the two halves of
//              each 128-column tile (a packed weight: see swiglu_epilogue)
// EPI_ROPE     out = a @ w + bias, then the 2D rotary embedding on columns
//              below rope_cols (q and k of a packed qkv), from a (S, 2, 64)
//              cos / sin table
constexpr int EPI_SWIGLU = 7, EPI_ROPE = 8;
// EVA02-CLIP-E/14's MLP (bf16, without the LayerNorm prologue):
// EPI_GELU_ERF out = GELU(a @ w + bias), the exact form x Phi(x) =
//              x (1 + erf(x / sqrt 2)) / 2 in fp32 (nn.GELU()), not the tanh
//              approximation nor QuickGELU
constexpr int EPI_GELU_ERF = 9;

struct GemmArgs {
  const void* a;       // (M, K) row-major, T; EPI_WGRAD: (K, M)
  const void* w;       // (K, N) row-major, T; EPI_DGRAD, EPI_DGELU: (N, K)
  const void* bias;    // (N,), T
  const void* res;     // (M, N), T; EPI_RESIDUAL and EPI_DGELU only
  const void* plane;   // (S, K) with LN, else (S, N); rows spliced in, or null
  const float* pmask;  // (S,): row s of each sequence comes from the plane if > 0
  const float* ln_g;   // (K,) fp32 LayerNorm scale; null: no LN prologue
  const float* ln_b;   // (K,) fp32 LayerNorm bias
  void* out;           // (M, N), T; EPI_WGRAD: (splits, M, N)
  int M, N, K, S, epi;
  int splits = 1;      // EPI_WGRAD: ranges of K, each summed into its own slab of out
  void* out2 = nullptr;  // EPI_DGELU: (M, N), QuickGELU(res), or null
  float eps = 1e-5f;     // the LayerNorm prologue's epsilon
  const float* rope = nullptr;  // EPI_ROPE: (S, 2, 64) fp32, cos then sin of each token
  int rope_cols = 0;     // EPI_ROPE: the columns rotated, [0, rope_cols)
};

// ---- bf16: TMA-fed wgmma ---------------------------------------------------
//
// Threads: two consumer warpgroups, then one producer warpgroup of which one
// thread issues TMA loads; all blocks are persistent, one per SM. Shared
// memory (from a 1024-byte aligned base): the ring of four stages, each [A
// tile: 256 rows x 128 bytes][W tile: two [64 rows][128 bytes] halves,
// columns n0.. and n0 + 64..] (48 KB); then the barriers.

constexpr int TBN = 128;     // output tile width: one wgmma m64n128k16 per 64 rows
constexpr int SMEM_MAX = 232448;

struct GemmShape {
  static constexpr int MT = 2;                   // 64-row accumulators per consumer warpgroup
  static constexpr int BK = 64;                  // rows of W per stage
  static constexpr int STAGES = 4;               // ring depth
  static constexpr int ROWS = 128 * MT;          // rows of the block's tile
  static constexpr int A_STAGE = ROWS * 128;
  static constexpr int W_HALF = BK * 128;
  static constexpr int STAGE = A_STAGE + 2 * W_HALF;
  static constexpr int THREADS = 384;            // two consumer warpgroups and the producer's
  // 1024 for the alignment of the base, 256 for the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE + 256;
};

// The bias of the 8 columns lane q stores in each of the epilogue's four
// rounds: columns n0 + 8 * (4 * round + q) ..., zero past N, loaded at the
// start of a tile so that the epilogue never waits for it.
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

// SiLU(gate) * up of a 64 x 128 tile whose columns n0 .. n0 + 63 are gate and
// n0 + 64 .. n0 + 127 the matching up columns: gate column c and up column
// c + 64 lie in the same thread (accumulator column groups j and j + 8), so
// the product needs no exchange. Bias and the product in fp32, one cast; the
// 64 columns go to out columns n0 / 2 .., a row N / 2 wide.
template <int MT>
__device__ __forceinline__ void swiglu_epilogue(const GemmArgs& g, const float (&acc)[MT][64],
                                                int row0, int n0, int lane) {
  const int gq = lane >> 2, q = lane & 3, nh = g.N / 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = row0 + 64 * mt + gq + 8 * hr;
      bf16* dst = static_cast<bf16*>(g.out) + (size_t)m * nh;
#pragma unroll
      for (int jq = 0; jq < 2; ++jq) {
        float x[2][8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[i] = acc[mt][4 * (4 * (jq + 2 * half) + i) + 2 * hr];
            hi[i] = acc[mt][4 * (4 * (jq + 2 * half) + i) + 2 * hr + 1];
          }
          quad_transpose(lo, q);
          quad_transpose(hi, q);
          const int n = n0 + 64 * half + 8 * (4 * jq + q);
          const uint4 b4 = n < g.N
              ? *reinterpret_cast<const uint4*>(static_cast<const bf16*>(g.bias) + n)
              : make_uint4(0u, 0u, 0u, 0u);
          const uint32_t b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 bb = unpack_bf16(b[i]);
            x[half][2 * i] = lo[i] + bb.x;
            x[half][2 * i + 1] = hi[i] + bb.y;
          }
        }
        // gate / (1 + 2^(-gate log2(e))) * up, a stage at a time over the 8
        // values so that their chains overlap
        float e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = ex2_approx(x[0][i] * -1.4426950408889634f);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = rcp_approx(1.f + e[i]);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] *= x[0][i] * x[1][i];
        const int nu = n0 / 2 + 8 * (4 * jq + q);
        if (m < g.M && nu < nh)
          *reinterpret_cast<uint4*>(dst + nu) =
              make_uint4(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]), pack_bf16(e[4], e[5]),
                         pack_bf16(e[6], e[7]));
      }
    }
}

// The rotary embedding of the 8 columns n .. n + 7 (one head's dims d0 .. d0 +
// 7, d0 = n % 64) of token s: interleaved pairs (2p, 2p + 1) turn by the
// pair's angle, y0 = x0 cos - x1 sin, y1 = x1 cos + x0 sin, fp32, before the
// cast. The table holds each pair's cos and sin twice; identity rows (cos 1,
// sin 0: CLS and the prompt tokens) leave the values as they are, bit for bit.
__device__ __forceinline__ void rope8(const GemmArgs& g, int s, int n, float (&x)[8]) {
  const float* cs = g.rope + (size_t)s * 128 + (n & 63);
  const float4 c0 = __ldg(reinterpret_cast<const float4*>(cs));
  const float4 c1 = __ldg(reinterpret_cast<const float4*>(cs + 4));
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(cs + 64));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(cs + 68));
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = x[2 * i], b = x[2 * i + 1];
    x[2 * i] = a * c[2 * i] - b * sn[2 * i];
    x[2 * i + 1] = b * c[2 * i + 1] + a * sn[2 * i + 1];
  }
}

// MT 64 x 128 accumulators -> out: bias, then QuickGELU (fp32) or the spliced
// residual, the cast, and 16-byte stores. row0: the first of this warp's 16
// rows in accumulator 0 (accumulator mt: + 64 mt); res: the residual source
// of the thread's rows g and g + 8 of each accumulator (residual_row, taken
// once per row at the start of the tile). The four lanes of a quad exchange
// their column pairs (in fp32, before any arithmetic) so that each owns 8
// consecutive columns of a row: bias, residual and output then move as
// 16-byte vectors.
template <int EPI, int MT>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& g, const float (&acc)[MT][64],
                                              const uint4 (&bias4)[4],
                                              const bf16* (&res)[MT][2], int row0, int n0,
                                              int lane) {
  if constexpr (EPI == EPI_SWIGLU) {
    swiglu_epilogue<MT>(g, acc, row0, n0, lane);
    return;
  }
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
      const int tok = EPI == EPI_ROPE ? m % g.S : 0;
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
        const uint4 b4 = bias4[jq];
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
        if (EPI == EPI_GELU_ERF) {
          // erff a stage at a time over the 8 values, so that their chains
          // overlap
          float e[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = erff(x[i] * 0.70710678118654752f);
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = 0.5f * x[i] * (1.f + e[i]);
        }
        if (EPI == EPI_ROPE && n < g.rope_cols && m < g.M) rope8(g, tok, n, x);
        if (m < g.M && n < g.N)
          *reinterpret_cast<uint4*>(dst + n) =
              make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                         pack_bf16(x[6], x[7]));
      }
#pragma unroll
      for (int jq = 0; jq < 4; ++jq) res_now[jq] = res_next[jq];
    }
}

template <int EPI>
__global__ void __launch_bounds__(GemmShape::THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, const GemmArgs g) {
  using Sh = GemmShape;
  constexpr int MT = Sh::MT, BK = Sh::BK, ROWS = Sh::ROWS, STAGE = Sh::STAGE,
                G_STAGES = Sh::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + G_STAGES * STAGE, empty = full + 8 * G_STAGES;

  // Output tiles are numbered row tile by row tile, N fastest; block c of G
  // takes tiles c, c + G, ...
  const int n_tiles = (g.N + TBN - 1) / TBN;
  const long long total = (long long)((g.M + ROWS - 1) / ROWS) * n_tiles;
  auto tile = [&](int i, int& m0, int& n0) {
    const long long t = (long long)blockIdx.x + (long long)i * gridDim.x;
    if (t >= total) return false;
    m0 = (int)(t / n_tiles) * ROWS;
    n0 = (int)(t % n_tiles) * TBN;
    return true;
  };
  const int nk = (g.K + BK - 1) / BK;
  if (total <= 0) return;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
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
        tma_load_2d(dst, &map_a, full + 8 * s, kt * BK, m0);
        tma_load_2d(dst + Sh::A_STAGE, &map_w, full + 8 * s, n0, kt * BK);
        tma_load_2d(dst + Sh::A_STAGE + Sh::W_HALF, &map_w, full + 8 * s, n0 + 64, kt * BK);
        if (++s == G_STAGES) s = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, epilogue ---------------------------
    // The two warpgroups share every stage, 128 rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid / 32, lane = tid % 32;
    int it = 0;  // stages gone by since the kernel began: stage it % G_STAGES
    for (int i = 0; tile(i, m0, n0); ++i) {
      // cleared, although the first wgmma of a tile overwrites it: the compiler
      // then keeps no accumulator alive from one tile to the next
      float acc[MT][64];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[mt][e] = 0.f;
      // the epilogue is not hidden: its bias is asked for here
      uint4 bias4[4] = {};
      load_tile_bias(g, n0, lane & 3, bias4);
      const int row0 = m0 + wg * MT * 64 + warp * 16;
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
            const uint32_t a = stage + (wg * MT + mt) * 8192 + j * 32;
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
      gemm_epilogue<EPI, MT>(g, acc, bias4, res, row0, n0, lane);
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
//
// The block backward's products (ops/fused_attention.fused_block_backward)
// are four more modes of the same kernel. product: the recompute's
// X W + b [+ residual], operands as the forward's. dgrad (dY W^T):
// W is a forward product's weight, (K_in, N) as stored, so the reduction
// runs along its rows: TMA brings each tile K-major already, 128-byte
// swizzled, and the splitters split it in place, without the transpose.
// dgelu: dgrad times QuickGELU' of the pre-activation, read in the
// epilogue. wgrad (X^T dY): A is X, (rows, M) as stored, brought as four
// 32 x 32 boxes per stage (128-byte swizzle); the reduction runs over the
// batch's rows (B x S), which need not be a multiple of 32 (both maps
// zero-fill the last stage). Its outputs are small (768 x 768 is 36 tiles
// for 132 SMs), so K is split into `splits` ranges, the split outermost in
// the chunk order (the blocks in flight share one range of A and W in L2);
// each range writes its own slab of fp32 partials, which the wrapper sums
// in a fixed order: no atomics, and two runs give equal bits.
//
// In these modes the splitters split A too, into the layout of W's halves
// (gathering the wgrad's transposed rows from the sub-tiles), and the
// consumers run wgmma on both operands from shared memory: their registers
// hold only the accumulator and a second 64-float sum. The tensor cores
// add with truncation, so a long reduction into one accumulator drifts
// toward zero (1.8e-5 of the result at K = 2304, against float64); the
// consumers start each stage's 12 passes afresh and add the stage into the
// sum, rounded to nearest (4e-7 at K = 2304). The forward's modes keep one
// accumulator (7e-6 at K = 768, 2.4e-5 at K = 3072); the backward recomputes
// through the product mode, so its gradients are taken at fp32-accurate
// activations. The splitters round with integer operations
// (tf32_split_alu: tf32_split's bits, off the conversion unit: +11% in
// these modes). Two raw stages instead of four make room for the split A
// tiles in the same shared memory.

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
// and one range of the k-stages (all of them unless the product is split;
// chunk c = (split * row panels + panel) * chunks per panel + j)
struct TileOrder {
  int n_tiles, cpp, panels, splits, nk;  // N tiles; chunks per panel; row panels; K ranges; k-stages
  long long n_chunks;
  __device__ TileOrder(const GemmArgs& g, bool ln, int splits_, int nk_) {
    n_tiles = (g.N + TG_BN - 1) / TG_BN;
    cpp = ln ? (n_tiles + 2) / 3 : n_tiles;
    panels = (g.M + TG_BM - 1) / TG_BM;
    splits = splits_;
    nk = nk_;
    n_chunks = (long long)panels * cpp * splits;
  }
  // the N tiles [nt0, nt1) of chunk c (never empty: cpp <= n_tiles)
  __device__ void tiles(long long c, int& nt0, int& nt1) const {
    const int j = (int)(c % cpp);
    nt0 = j * n_tiles / cpp;
    nt1 = (j + 1) * n_tiles / cpp;
  }
  __device__ int row0(long long c) const {
    const long long p = c / cpp;
    return (int)(splits == 1 ? p : p % panels) * TG_BM;
  }
  __device__ int split(long long c) const {
    return splits == 1 ? 0 : (int)(c / cpp / panels);
  }
  // the k-stages [k0, k1) of chunk c (never empty: splits <= nk)
  __device__ void kspan(long long c, int& k0, int& k1) const {
    const int s = split(c);
    k0 = s * nk / splits;
    k1 = (s + 1) * nk / splits;
  }
};

// A walk over a block's k-stages in order: (chunk, N tile, k-stage)
struct StageWalk {
  long long c;
  int nt, nt1, kt, k0, k1;
  __device__ bool enter(const TileOrder& o) {
    if (c >= o.n_chunks) return false;
    o.tiles(c, nt, nt1);
    o.kspan(c, k0, k1);
    kt = k0;
    return true;
  }
  __device__ bool start(const TileOrder& o) {
    c = blockIdx.x;
    return enter(o);
  }
  __device__ bool next(const TileOrder& o) {
    if (++kt < k1) return true;
    kt = k0;
    if (++nt < nt1) return true;
    c += gridDim.x;
    return enter(o);
  }
};

// QuickGELU(h) = h s and its derivative s + 1.702 h s (1 - s), s = sigmoid(1.702 h)
__device__ __forceinline__ float2 quick_gelu_and_grad(float h) {
  const float s = 1.f / (1.f + expf(-1.702f * h));
  return make_float2(h * s, s + 1.702f * h * s * (1.f - s));
}

// fp32 epilogue value of output (m, n): + bias, then QuickGELU or + residual
// (already the spliced row's); the backward's dgrad and wgrad: as it is;
// its recompute: + bias [+ residual]
template <int EPI>
__device__ __forceinline__ float tg_epi(float v, const float* bias, const float* res_row, int n) {
  if (EPI == EPI_DGRAD || EPI == EPI_WGRAD) return v;
  if (EPI == EPI_PRODUCT) return v + bias[n] + (res_row != nullptr ? __ldg(res_row + n) : 0.f);
  v += bias[n];
  if (EPI == EPI_GELU) return v / (1.f + expf(-1.702f * v));
  if (EPI == EPI_RESIDUAL) v += res_row[n];
  return v;
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(TG_THREADS, 1)
gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w, const GemmArgs g) {
  // the backward's modes: A given transposed (wgrad), W given as (N, K)
  // (dgrad); both operands split by the splitters, sums promoted
  constexpr bool A_T = EPI == EPI_WGRAD, W_T = EPI == EPI_DGRAD || EPI == EPI_DGELU;
  constexpr bool BWD = EPI >= EPI_DGRAD;
  // raw ring stages, and a split stage's bytes: [W hi | W lo] or, in the
  // backward's modes, [W hi | W lo | A hi | A lo] (the same shared memory:
  // 2 x 32 + 2 x 64 = 4 x 32 + 2 x 32 KB)
  constexpr int RAW = BWD ? 2 : TG_RAW, SPLIT = BWD ? 2 * TG_SPLIT_STAGE : TG_SPLIT_STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base, split = ring + RAW * TG_RAW_STAGE;
  float* const ln_s = reinterpret_cast<float*>(gbase + TG_RAW * TG_RAW_STAGE +
                                               2 * TG_SPLIT_STAGE);  // [gamma | beta]
  // per tile row of the current panel: mean, rstd, and (as a float) the
  // position in its sequence where the row is spliced from the plane, or -1
  float* const row_mean = ln_s + 2 * LN_MAX_K;
  float* const row_rstd = row_mean + TG_BM;
  float* const row_plane = row_rstd + TG_BM;
  const uint32_t raw_full = ring + TG_RAW * TG_RAW_STAGE + 2 * TG_SPLIT_STAGE + TG_LN_BYTES;
  const uint32_t raw_empty = raw_full + 8 * TG_RAW, split_full = raw_empty + 8 * TG_RAW,
                 split_empty = split_full + 16;
  const int nk = A_T ? (g.K + TG_BK - 1) / TG_BK : g.K / TG_BK;
  const TileOrder order(g, LN, A_T ? g.splits : 1, nk);

  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      // every thread has read its part (the backward's: the splitters alone)
      mbar_init(raw_empty + 8 * s, BWD ? 128 : TG_THREADS);
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
    // ---- splitters: W tiles transposed and split (the backward's: A tiles
    // too); thread 0 keeps the raw ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    StageWalk pw;
    bool pmore = false;
    long long issued = 0;
    auto issue = [&]() {
      const int s = (int)(issued % RAW);
      mbar_wait(raw_empty + 8 * s, (uint32_t)((issued / RAW) & 1) ^ 1);
      mbar_arrive_expect_tx(raw_full + 8 * s, TG_RAW_STAGE);
      const int m0 = order.row0(pw.c), n0 = pw.nt * TG_BN;
      const uint32_t dst = ring + s * TG_RAW_STAGE;
      if (A_T) {
        // four boxes of 32 k rows x 32 m columns: sub-tile j holds rows 32j..
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(dst + j * (TG_TILE / 4), &map_a, raw_full + 8 * s, m0 + 32 * j,
                      pw.kt * TG_BK);
      } else {
        tma_load_2d(dst, &map_a, raw_full + 8 * s, pw.kt * TG_BK, m0);
      }
      if (W_T)
        tma_load_2d(dst + TG_TILE, &map_w, raw_full + 8 * s, pw.kt * TG_BK, n0);
      else
        tma_load_2d(dst + TG_TILE, &map_w, raw_full + 8 * s, n0, pw.kt * TG_BK);
      ++issued;
      pmore = pw.next(order);
    };
    if (tid == 0) {
      pmore = pw.start(order);
      for (int s = 0; s < RAW && pmore; ++s) issue();
    }
    StageWalk sw;
    bool more = sw.start(order);
    for (long long it = 0; more; ++it, more = sw.next(order)) {
      const int s = (int)(it % RAW), sp = (int)(it & 1);
      mbar_wait(raw_full + 8 * s, (uint32_t)((it / RAW) & 1));
      mbar_wait(split_empty + 8 * sp, (uint32_t)((it >> 1) & 1) ^ 1);
      // column n = tid of the W tile: 32 k values -> one swizzled 128-byte
      // row of hi and one of lo (chunk kc of row n at ((kc ^ (n & 7)) << 4))
      unsigned char* hi = gbase + RAW * TG_RAW_STAGE + sp * SPLIT + tid * 128;
      if (W_T) {
        // the raw tile is that layout already: split each chunk where it lies
        const unsigned char* wr = gbase + s * TG_RAW_STAGE + TG_TILE + tid * 128;
#pragma unroll
        for (int kc = 0; kc < TG_BK / 4; ++kc) {
          const int off = (kc ^ (tid & 7)) << 4;
          const float4 v = *reinterpret_cast<const float4*>(wr + off);
          uint32_t h[4], l[4];
          tf32_split_alu(v.x, h[0], l[0]);
          tf32_split_alu(v.y, h[1], l[1]);
          tf32_split_alu(v.z, h[2], l[2]);
          tf32_split_alu(v.w, h[3], l[3]);
          *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(hi + TG_TILE + off) = make_uint4(l[0], l[1], l[2], l[3]);
        }
      } else {
        const float* wr = reinterpret_cast<const float*>(gbase + s * TG_RAW_STAGE + TG_TILE);
        float v[TG_BK];
#pragma unroll
        for (int k = 0; k < TG_BK; ++k) v[k] = wr[k * TG_BN + tid];
#pragma unroll
        for (int kc = 0; kc < TG_BK / 4; ++kc) {
          uint32_t h[4], l[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (BWD)
              tf32_split_alu(v[4 * kc + e], h[e], l[e]);
            else
              tf32_split(v[4 * kc + e], h[e], l[e]);
          }
          const int off = (kc ^ (tid & 7)) << 4;
          *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(hi + TG_TILE + off) = make_uint4(l[0], l[1], l[2], l[3]);
        }
      }
      if (BWD) {
        // row m = tid of the A tile, into the same layout behind W's halves:
        // as it lies (dgrad), or gathered from the four 32 x 32 sub-tiles,
        // element (m, k) at row k of sub-tile m >> 5 (wgrad)
        const unsigned char* ar = gbase + s * TG_RAW_STAGE;
        unsigned char* ah = hi + 2 * TG_TILE;
#pragma unroll
        for (int kc = 0; kc < TG_BK / 4; ++kc) {
          const int off = (kc ^ (tid & 7)) << 4;
          float v[4];
          if (A_T) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 4 * kc + e;
              v[e] = *reinterpret_cast<const float*>(
                  ar + (tid >> 5) * (TG_TILE / 4) + k * 128 +
                  ((((tid & 31) >> 2) ^ (k & 7)) << 4) + 4 * (tid & 3));
            }
          } else {
            const float4 u = *reinterpret_cast<const float4*>(ar + tid * 128 + off);
            v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
          }
          uint32_t h[4], l[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split_alu(v[e], h[e], l[e]);
          *reinterpret_cast<uint4*>(ah + off) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(ah + TG_TILE + off) = make_uint4(l[0], l[1], l[2], l[3]);
        }
      }
      fence_proxy_async();
      mbar_arrive(split_full + 8 * sp);
      mbar_arrive(raw_empty + 8 * s);
      if (tid == 0 && pmore) issue();
    }
    return;
  }

  // ---- consumers: A fragments from the raw tile (the backward's: A split in
  // shared memory), three passes on wgmma ----------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  const int warp = tid / 32, lane = tid % 32, gq = lane >> 2, q = lane & 3;
  const int r_loc = 64 * wg + 16 * warp + gq;  // tile row of the thread's first row
  uint32_t it = 0;
  for (long long c = blockIdx.x; c < order.n_chunks; c += gridDim.x) {
    const int m0 = order.row0(c);
    int nt0, nt1, k0, k1;
    order.tiles(c, nt0, nt1);
    order.kspan(c, k0, k1);
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
          const float rs = rsqrtf(warp_sum(s2) / g.K + g.eps);
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
        const int s = (int)(st % RAW);
        mbar_wait(raw_full + 8 * s, (st / RAW) & 1);
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
      float acc[64], sum[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;
      if constexpr (BWD) {
        // both operands split in shared memory; a stage's 12 passes summed
        // afresh into acc, then into `sum` rounded to nearest
        for (int kt = k0; kt < k1; ++kt, ++it) {
          const int sp = (int)(it & 1);
          mbar_wait(split_full + 8 * sp, (it >> 1) & 1);
          const uint32_t bh = split + sp * SPLIT, bl = bh + TG_TILE;
          const uint32_t ah = bh + 2 * TG_TILE + wg * (64 * 128), al = ah + TG_TILE;
          wgmma_fence();
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8) {
            wgmma_m64n128k8_tf32(acc, wgmma_desc(al + 32 * k8, 16, 1024),
                                 wgmma_desc(bh + 32 * k8, 16, 1024), k8 == 0 ? 0 : 1);
            wgmma_m64n128k8_tf32(acc, wgmma_desc(ah + 32 * k8, 16, 1024),
                                 wgmma_desc(bl + 32 * k8, 16, 1024), 1);
            wgmma_m64n128k8_tf32(acc, wgmma_desc(ah + 32 * k8, 16, 1024),
                                 wgmma_desc(bh + 32 * k8, 16, 1024), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          wgmma_settle(acc);
          mbar_arrive(split_empty + 8 * sp);
#pragma unroll
          for (int e = 0; e < 64; ++e) sum[e] += acc[e];
        }
      } else {
        float vals[4][4];
        uint32_t ch[4][4], cl[4][4];
        load_vals(it, k0, vals);
        for (int kt = k0; kt < k1; ++kt, ++it) {
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8)
#pragma unroll
            for (int i = 0; i < 4; ++i) tf32_split(vals[k8][i], ch[k8][i], cl[k8][i]);
          const int sp = (int)(it & 1);
          mbar_wait(split_full + 8 * sp, (it >> 1) & 1);
          const uint32_t bh = split + sp * SPLIT, bl = bh + TG_TILE;
          wgmma_fence();
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8) {
            wgmma_m64n128k8_tf32_ra(acc, cl[k8], wgmma_desc(bh + 32 * k8, 16, 1024), 1);
            wgmma_m64n128k8_tf32_ra(acc, ch[k8], wgmma_desc(bl + 32 * k8, 16, 1024), 1);
            wgmma_m64n128k8_tf32_ra(acc, ch[k8], wgmma_desc(bh + 32 * k8, 16, 1024), 1);
          }
          wgmma_commit();
          // the next stage's values while the tensor cores run
          if (kt + 1 < k1) load_vals(it + 1, kt + 1, vals);
          wgmma_wait<0>();
          wgmma_settle(acc);
#pragma unroll
          for (int k8 = 0; k8 < 4; ++k8) {
            wgmma_settle(ch[k8]);
            wgmma_settle(cl[k8]);
          }
          mbar_arrive(split_empty + 8 * sp);
        }
      }
      // epilogue: acc[4j + 2hr + e] is row r_loc + 8 hr, column 8j + 2q + e
      float* out = static_cast<float*>(g.out);
      if (A_T) out += (size_t)order.split(c) * g.M * g.N;  // this range's slab
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
        } else if (EPI == EPI_DGELU || (EPI == EPI_PRODUCT && g.res != nullptr)) {
          res_row = static_cast<const float*>(g.res) + (size_t)m * g.N;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          if (n >= g.N) continue;  // N % 8 == 0: n + 1 < N too
          const int e = 4 * j + 2 * hr;
          float v0, v1;
          if (EPI == EPI_DGELU) {
            // the pre-activation's pair as one 8-byte load, through the
            // read-only path: no store to out can alias it, so the loads of
            // the row need not wait behind the stores
            const float2 h = __ldg(reinterpret_cast<const float2*>(res_row + n));
            const float2 f0 = quick_gelu_and_grad(h.x), f1 = quick_gelu_and_grad(h.y);
            v0 = sum[e] * f0.y;
            v1 = sum[e + 1] * f1.y;
            if (g.out2 != nullptr)
              *reinterpret_cast<float2*>(static_cast<float*>(g.out2) + (size_t)m * g.N + n) =
                  make_float2(f0.x, f1.x);
          } else {
            v0 = tg_epi<EPI>(BWD ? sum[e] : acc[e], bias, res_row, n);
            v1 = tg_epi<EPI>(BWD ? sum[e + 1] : acc[e + 1], bias, res_row, n + 1);
          }
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

template <int EPI>
int launch_gemm_bf16(const GemmArgs& g, cudaStream_t stream) {
  using Sh = GemmShape;
  static_assert(Sh::SMEM <= SMEM_MAX, "the bf16 GEMM's ring outgrows an SM");
  if (g.M == 0) return 0;
  CUtensorMap map_a, map_w;
  int rc = matrix_map(&map_w, g.w, g.K, g.N, Sh::BK);
  if (rc != 0) return rc;
  if ((rc = matrix_map(&map_a, g.a, g.M, g.K, Sh::ROWS)) != 0) return rc;
  auto kernel = gemm_bf16_kernel<EPI>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (g.N + TBN - 1) / TBN, row_tiles = (g.M + Sh::ROWS - 1) / Sh::ROWS;
  // persistent blocks: at most one per SM (shared memory allows no more)
  const int grid = (int)min((long long)row_tiles * n_tiles, (long long)sm_count());
  kernel<<<grid, Sh::THREADS, Sh::SMEM, stream>>>(map_a, map_w, g);
  return (int)cudaGetLastError();
}

template <bool LN, int EPI>
int launch_gemm_tf32x3(const GemmArgs& g, cudaStream_t stream) {
  constexpr bool A_T = EPI == EPI_WGRAD, W_T = EPI == EPI_DGRAD || EPI == EPI_DGELU;
  if (g.M == 0) return 0;
  // A: (M, K), box of 32 columns (one 128-byte row) x 128 rows, swizzled as
  // the consumers read it (A_T: (K, M), boxes of 32 x 32); W: (K, N) as
  // stored, box of 128 columns x 32 rows (W_T: (N, K), box of 32 columns x
  // 128 rows, swizzled as the wgmma operand)
  CUtensorMap map_a, map_w;
  const uint64_t a_dims[2] = {(uint64_t)(A_T ? g.M : g.K), (uint64_t)(A_T ? g.K : g.M)};
  const uint64_t a_strides[1] = {(uint64_t)a_dims[0] * 4};
  const uint32_t a_box[2] = {(uint32_t)TG_BK, (uint32_t)(A_T ? TG_BK : TG_BM)};
  int rc = encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_128B, g.a, 2,
                      a_dims, a_strides, a_box);
  if (rc != 0) return rc;
  const uint64_t w_dims[2] = {(uint64_t)(W_T ? g.K : g.N), (uint64_t)(W_T ? g.N : g.K)};
  const uint64_t w_strides[1] = {(uint64_t)w_dims[0] * 4};
  const uint32_t w_box[2] = {(uint32_t)(W_T ? TG_BK : TG_BN), (uint32_t)(W_T ? TG_BN : TG_BK)};
  if ((rc = encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       W_T ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, g.w, 2,
                       w_dims, w_strides, w_box)) != 0)
    return rc;
  auto kernel = gemm_tf32x3_kernel<LN, EPI>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TG_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (g.N + TG_BN - 1) / TG_BN, cpp = LN ? (n_tiles + 2) / 3 : n_tiles;
  const long long chunks =
      (long long)((g.M + TG_BM - 1) / TG_BM) * cpp * (A_T ? g.splits : 1);
  // persistent blocks, one per SM (shared memory allows no more)
  const int grid = (int)min(chunks, (long long)sm_count());
  kernel<<<grid, TG_THREADS, TG_SMEM, stream>>>(map_a, map_w, g);
  return (int)cudaGetLastError();
}

// bf16 takes no LayerNorm here: ln_gemm and gemm_bias_residual run ln_rows
// first (launch_ln_rows_then_gemm)
template <bool LN>
int launch_gemm(const GemmArgs& g, bool is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    if (LN) return (int)cudaErrorInvalidValue;
    if (g.epi == EPI_ROPE) return launch_gemm_bf16<EPI_ROPE>(g, stream);
    if (g.epi == EPI_GELU_ERF) return launch_gemm_bf16<EPI_GELU_ERF>(g, stream);
    if (g.epi == EPI_SWIGLU) return launch_gemm_bf16<EPI_SWIGLU>(g, stream);
    if (g.epi == EPI_RESIDUAL) return launch_gemm_bf16<EPI_RESIDUAL>(g, stream);
    if (g.epi == EPI_GELU) return launch_gemm_bf16<EPI_GELU>(g, stream);
    return launch_gemm_bf16<EPI_BIAS>(g, stream);
  }
  if (g.epi == EPI_ROPE || g.epi == EPI_SWIGLU || g.epi == EPI_GELU_ERF ||
      (LN && g.epi == EPI_RESIDUAL))
    return (int)cudaErrorInvalidValue;  // the EVA02 modes run in bf16 only
  if (g.epi == EPI_GELU) return launch_gemm_tf32x3<LN, EPI_GELU>(g, stream);
  if constexpr (!LN) {
    if (g.epi == EPI_RESIDUAL) return launch_gemm_tf32x3<false, EPI_RESIDUAL>(g, stream);
  }
  return launch_gemm_tf32x3<LN, EPI_BIAS>(g, stream);
}

// ---------------------------------------------------------------------------
// ln_rows: a LayerNorm over rows, as a pass of its own: every bf16 LayerNorm
// of the block kernels. For ln_gemm and gemm_bias_residual with LayerNorm
// (LN_1 -> qkv with the deep-prompt splice on load, LN_2 -> c_fc, EVA02's
// attention-output sub-LN before the out-projection) the entry points run it
// into the caller's scratch and then the GEMM without LayerNorm
// (launch_ln_rows_then_gemm); EVA02's block also calls it for LN_1 and LN_2
// and for the MLP's sub-LN over its hidden width F, stored F_pad = F rounded
// up to 64 wide; and, in its residual mode (RES), EVA02-CLIP-E/14's post-norm
// residual res + LN(y) (ln_residual), the sum rounded once. bf16 in and out,
// statistics two-pass in fp32 over the first n_real columns only, the fp32
// affine, the normalised row rounded to bf16;
// the padded columns come out as their (zero) gamma and beta make them. One
// warp per row, 8 rows per block: a lane loads its 16-byte chunks lane, lane
// + 32, ... of the row at once (NV of them, all in flight), so the row is
// read once and written once. What bounds it is those bytes.
//
// The MLP's sub-LN could not be a prologue of any kind that keeps rows in
// shared memory: a 64-row panel of EVA02-L's hidden width is 64 x 2752 x 2
// bytes = 352 KB, past an SM's 227 KB. Statistics taken in the gate | up
// product's epilogue and the normalisation folded into the down product's
// epilogue (gamma folded into W, the mean's term subtracted through W's
// column sums) would save the pass (~0.9 GB per 256 images per block, ~5% of
// the block) but need the weight prepared on every call and subtract two
// large terms where a row's mean is large against its spread.
// ---------------------------------------------------------------------------

constexpr int LNR_THREADS = 256, LNR_ROWS = LNR_THREADS / 32;

template <int NV, bool RES>
__global__ void __launch_bounds__(LNR_THREADS)
ln_rows_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                    const bf16* __restrict__ plane, const float* __restrict__ pmask,
                    const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                    bf16* __restrict__ out, int M, int K, int S, int n_real, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * LNR_ROWS + warp;
  if (row >= M) return;
  const int nchunks = K / 8;
  const bf16* xr = x + row * K;
  bf16* orow = out + row * K;
  if (plane != nullptr) {
    const int s = (int)(row % S);
    if (pmask[s] > 0.f) {
      const bf16* pr = plane + (size_t)s * K;
      if constexpr (RES) {
        // the splice on store: the plane's row in place of res + LN(x)
        for (int c = lane; c < nchunks; c += 32)
          *reinterpret_cast<uint4*>(orow + 8 * c) = *reinterpret_cast<const uint4*>(pr + 8 * c);
        return;
      }
      xr = pr;
    }
  }
  uint4 u[NV], r[RES ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    u[i] = c < nchunks ? *reinterpret_cast<const uint4*>(xr + 8 * c) : make_uint4(0u, 0u, 0u, 0u);
    if constexpr (RES)
      r[i] = c < nchunks ? *reinterpret_cast<const uint4*>(res + row * K + 8 * c)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[8];
    unpack_vec<bf16>(u[i], f);
    const int c0 = 8 * (lane + 32 * i);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c0 + e < n_real) s += f[e];
  }
  const float mean = warp_sum(s) / n_real;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[8];
    unpack_vec<bf16>(u[i], f);
    const int c0 = 8 * (lane + 32 * i);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c0 + e < n_real) v += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(v) / n_real + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c >= nchunks) continue;
    float f[8];
    unpack_vec<bf16>(u[i], f);
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(ln_g + 8 * c));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(ln_g + 8 * c + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b + 8 * c + 4));
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] - mean) * rstd * gm[e] + bt[e];
    if constexpr (RES) {
      float rr[8];
      unpack_vec<bf16>(r[i], rr);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] += rr[e];
    }
    store_vec<bf16>(orow + 8 * c, f);
  }
}

constexpr int LNR_MAX_K = 4096;  // 16 chunks of 16 bytes per lane

// res null: LN(splice(x)), the plane's rows read in place of x's; res
// given (n_real == K): res + LN(x), the plane's rows stored in place of it
int launch_ln_rows(const void* x, const void* res, const void* plane, const float* pmask,
                   const float* ln_g, const float* ln_b, void* out, int M, int K, int S,
                   int n_real, float eps, cudaStream_t stream) {
  if (M == 0) return 0;
  if (K <= 0 || K % 8 || K > LNR_MAX_K || n_real < 1 || n_real > K || S < 1 ||
      (plane == nullptr) != (pmask == nullptr) || (res != nullptr && n_real != K))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + LNR_ROWS - 1) / LNR_ROWS);
  auto xs = static_cast<const bf16*>(x);
  auto rs = static_cast<const bf16*>(res);
  auto ps = static_cast<const bf16*>(plane);
  auto o = static_cast<bf16*>(out);
  const int per_lane = (K / 8 + 31) / 32;
  auto launch = [&](auto kernel) {
    kernel<<<blocks, LNR_THREADS, 0, stream>>>(xs, rs, ps, pmask, ln_g, ln_b, o, M, K, S,
                                               n_real, eps);
  };
  if (res != nullptr) {
    if (per_lane <= 4) launch(ln_rows_bf16_kernel<4, true>);
    else if (per_lane <= 8) launch(ln_rows_bf16_kernel<8, true>);
    else if (per_lane <= 12) launch(ln_rows_bf16_kernel<12, true>);
    else launch(ln_rows_bf16_kernel<16, true>);
  } else {
    if (per_lane <= 4) launch(ln_rows_bf16_kernel<4, false>);
    else if (per_lane <= 8) launch(ln_rows_bf16_kernel<8, false>);
    else if (per_lane <= 12) launch(ln_rows_bf16_kernel<12, false>);
    else launch(ln_rows_bf16_kernel<16, false>);
  }
  return (int)cudaGetLastError();
}

// bf16 with LayerNorm: ln_rows writes LN(splice(a)) to scratch (M, K), then
// the GEMM without LN reads it as its A. splice: the prompt plane is the
// input rows' (ln_gemm) and the product takes none; otherwise it stays the
// residual's (gemm_bias_residual).
int launch_ln_rows_then_gemm(GemmArgs g, void* scratch, bool splice, cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int rc = launch_ln_rows(g.a, nullptr, splice ? g.plane : nullptr, splice ? g.pmask : nullptr,
                          g.ln_g, g.ln_b, scratch, g.M, g.K, g.S, g.K, g.eps, stream);
  if (rc != 0) return rc;
  g.a = scratch;
  g.ln_g = g.ln_b = nullptr;
  if (splice) g.plane = nullptr, g.pmask = nullptr;
  return launch_gemm<false>(g, true, stream);
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
//
// The head width HD is a template parameter: 64 (every CLIP and EVA02-L
// head) or 112 (EVA02-CLIP-E/14). A head of 112 is 224 bytes a row, wider
// than one 128-byte swizzle row, so each of Q, K and V arrives as two column
// blocks of 64 (boxes at columns h*112 and h*112 + 64, each its own tile); the
// second box's last 16 columns belong to the next head (zeros past the last
// one) and are never read by Q K^T, whose 7 k-steps of 16 take 4 from the
// first block and 3 from the second. P V runs over one column block at a
// time (m64n64k16 per 16 keys, one 32-float accumulator beside P: two would
// spill), and the second block's last 16 output columns are not stored: 128
// columns of P V work for 112 (+14% of P V, ~1% of the block). Two buffers of
// a 112-wide head pass an SM's shared memory beyond S = 128 (12 tiles of 24
// KB at S = 165), so there the kernel keeps one buffer and thread 0 asks for
// a head once both warpgroups have left the one before (`nbuf`).

constexpr int ATT_THREADS_BF16 = 256, ATT_PIECE = 64;
constexpr int ATT_MASK_SMEM = 32 * 1024;  // the largest mask staged beside the two buffers

__host__ __device__ inline int attention_bf16_tile_bytes(int S) { return round_up(S, 64) * 128; }

template <int HD>
__global__ void __launch_bounds__(ATT_THREADS_BF16, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ mask, bf16* __restrict__ out, int B, int S,
                      int H, float scale, int fast, int stage_mask, int nbuf) {
  constexpr int NCB = (HD + 63) / 64;  // 64-column blocks of a head
  constexpr int KSTEPS = HD / 16;      // k-steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const int tile_bytes = attention_bf16_tile_bytes(S);
  const int op_bytes = NCB * tile_bytes;  // one of Q, K, V of a head
  const int mask_bytes = stage_mask ? round_up(S * S * 4, 16) : 0;
  float* smask = reinterpret_cast<float*>(smem_raw + (base - raw) + nbuf * 3 * op_bytes);
  // barriers of buffer u: bars + 8u (Q, K), + 16 + 8u (V), + 32 + 8u (drained)
  const uint32_t bars = base + nbuf * 3 * op_bytes + mask_bytes;
  const int D = H * HD, n_items = B * H;

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
    const int u = i % nbuf, h = w % H, b = w / H;
    const uint32_t buf = base + u * 3 * op_bytes;
    mbar_wait(bars + 32 + 8 * u, ((i / nbuf) & 1) ^ 1);
    mbar_arrive_expect_tx(bars + 8 * u, 2 * op_bytes);
#pragma unroll
    for (int c = 0; c < NCB; ++c) {
      tma_load_3d(buf + c * tile_bytes, &map_q, bars + 8 * u, h * HD + 64 * c, 0, b);
      tma_load_3d(buf + op_bytes + c * tile_bytes, &map_k, bars + 8 * u, h * HD + 64 * c, 0, b);
    }
    mbar_arrive_expect_tx(bars + 16 + 8 * u, op_bytes);
#pragma unroll
    for (int c = 0; c < NCB; ++c)
      tma_load_3d(buf + 2 * op_bytes + c * tile_bytes, &map_v, bars + 16 + 8 * u,
                  h * HD + 64 * c, 0, b);
  };
  // with two buffers the first head is asked for here, each next one under
  // the work on the one before; with one, each head as its turn comes
  const int ahead = nbuf - 1;
  if (threadIdx.x == 0 && ahead > 0) request(0, blockIdx.x);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int n_pieces = (S + ATT_PIECE - 1) / ATT_PIECE;

  for (int it = 0, w = blockIdx.x; w < n_items; ++it, w += gridDim.x) {
    const int u = it % nbuf, h = w % H, b = w / H;
    const uint32_t phase = (it / nbuf) & 1;
    const uint32_t sQ = base + u * 3 * op_bytes, sK = sQ + op_bytes, sV = sK + op_bytes;
    if (threadIdx.x == 0 && w + ahead * gridDim.x < n_items)
      request(it + ahead, w + ahead * gridDim.x);
    mbar_wait(bars + 8 * u, phase);
    bool v_ready = false;

    for (int qt = wg; qt * 64 < S; qt += 2) {
      const int row[2] = {qt * 64 + warp * 16 + g, qt * 64 + warp * 16 + g + 8};
      const float* mrow[2] = {nullptr, nullptr};
      if (mask != nullptr) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) mrow[hr] = mask + (size_t)min(row[hr], S - 1) * S;
      }

      // raw scores: key 64p + 8j + 2q + (e & 1) of row[e >> 1] in sc[p][4j + e];
      // k-step ks reads column block ks / 4 at 32-byte step ks % 4
      float sc[4][32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= n_pieces) continue;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const uint32_t col = (ks / 4) * tile_bytes + 32 * (ks % 4);
          wgmma_m64n64k16(sc[p], wgmma_desc(sQ + col + qt * 8192, 16, 1024),
                          wgmma_desc(sK + col + p * 8192, 16, 1024), ks != 0);
        }
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

      // O = P V: 16 keys per step; step ks of piece p takes pk[p][4ks .. 4ks + 3];
      // one column block of V at a time, so that one 32-float accumulator
      // lives beside pk (two would spill at heads of 112)
      if (!v_ready) {
        mbar_wait(bars + 16 + 8 * u, phase);
        v_ready = true;
      }
      float rc[2];
#pragma unroll
      for (int c = 0; c < NCB; ++c) {
        float o[32];
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p >= n_pieces) continue;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t pa[4] = {pk[p][4 * ks], pk[p][4 * ks + 1], pk[p][4 * ks + 2],
                                    pk[p][4 * ks + 3]};
            wgmma_m64n64k16_ra_tb(
                o, pa,
                wgmma_desc(sV + c * tile_bytes + (ATT_PIECE * p + 16 * ks) * 128, 16, 1024),
                (p | ks) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_settle(o);
        if (c == NCB - 1) {
#pragma unroll
          for (int p = 0; p < 4; ++p) wgmma_settle(pk[p]);
        }

        // scale by the row reciprocal, cast, 16-byte stores into (B, S, D): the
        // columns of the head alone
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (c == 0) {
            denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 1);
            denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 2);
            if (fast) denom[hr] = fmaxf(denom[hr], 1e-30f);
            rc[hr] = 1.f / denom[hr];
          }
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 4) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = pack_bf16(o[4 * (j0 + i) + 2 * hr] * rc[hr],
                               o[4 * (j0 + i) + 2 * hr + 1] * rc[hr]);
            quad_transpose(v, q);
            const int col = 64 * c + 8 * (j0 + q);
            if (row[hr] < S && col < HD)
              *reinterpret_cast<uint4*>(out + ((size_t)b * S + row[hr]) * D + h * HD + col) =
                  make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    }
    // this warpgroup has read the buffer for the last time
    if (tid == 0) mbar_arrive(bars + 32 + 8 * u);
  }
}

// 3-D map of one of q, k, v: element (b, s, column) at base + (b*S + s)*ld +
// column, H*hd columns; a box is 64 columns (one head of 64, a column block of
// a wider head) of `rows` tokens of one image, tokens past S and columns past
// H*hd read as zeros
int head_map(CUtensorMap* map, const void* p, int B, int S, int H, int ld, int rows,
             int hd = DH) {
  const uint64_t dims[3] = {(uint64_t)H * hd, (uint64_t)S, (uint64_t)B};
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
//
// The head width HD is a template parameter, as in the whole-row kernel: at
// 112 each Q tile and each K and V tile of a stage is two 64-column blocks
// (boxes at columns h*112 and h*112 + 64), Q K^T takes 4 k-steps from the
// first block and 3 from the second, and P V runs both column blocks on one
// tile's P, into two 32-float accumulators (P is 16 registers here, not a
// whole row); the second block's last 16 output columns (the next head's) are
// not stored. A stage is then 32 KB and the shared memory ~161 KB: one block
// per SM.

constexpr int ATL_THREADS = 256, ATL_STAGES = 4, ATL_TILE = 64 * 128;

__host__ __device__ constexpr int attention_long_bf16_smem(int ncb) {
  return 1024 + 2 * ncb * ATL_TILE + ATL_STAGES * 2 * ncb * ATL_TILE + 8 * (1 + 2 * ATL_STAGES);
}

template <int HD>
__global__ void __launch_bounds__(ATL_THREADS, 1)
attention_long_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const float* __restrict__ mask, bf16* __restrict__ out, int B,
                           int S, int H, float scale, int fast) {
  constexpr int NCB = (HD + 63) / 64;  // 64-column blocks of a head
  constexpr int KSTEPS = HD / 16;      // k-steps of Q K^T
  constexpr int STAGE = 2 * NCB * ATL_TILE;  // a K tile and a V tile, NCB blocks each
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, ring = base + 2 * NCB * ATL_TILE;
  const uint32_t qbar = ring + ATL_STAGES * STAGE, full = qbar + 8,
                 empty = full + 8 * ATL_STAGES;
  const int nq = (S + 127) / 128, D = H * HD;
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
    const uint32_t dst = ring + st * STAGE;
    mbar_arrive_expect_tx(full + 8 * st, STAGE);
#pragma unroll
    for (int c = 0; c < NCB; ++c) {
      tma_load_3d(dst + c * ATL_TILE, &map_k, full + 8 * st, h * HD + 64 * c, 64 * t, b);
      tma_load_3d(dst + (NCB + c) * ATL_TILE, &map_v, full + 8 * st, h * HD + 64 * c, 64 * t,
                  b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(qbar, active * NCB * ATL_TILE);
    for (int w = 0; w < active; ++w)
      for (int c = 0; c < NCB; ++c)
        tma_load_3d(sQ + (w * NCB + c) * ATL_TILE, &map_q, qbar, h * HD + 64 * c, q0 + 64 * w,
                    b);
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
  const uint32_t sQw = sQ + wg * NCB * ATL_TILE;

  float o[NCB][32];
#pragma unroll
  for (int c = 0; c < NCB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_run[2] = {-3.402823466e38f, -3.402823466e38f}, denom[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % ATL_STAGES;
    const uint32_t phase = (t / ATL_STAGES) & 1;
    const uint32_t sK = ring + st * STAGE, sV = sK + NCB * ATL_TILE;
    mbar_wait(full + 8 * st, phase);

    // raw scores: key 64t + 8j + 2q + (e & 1) of row[e >> 1] in sc[4j + e];
    // k-step ks reads column block ks / 4 of Q and K
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t off = (ks / 4) * ATL_TILE + 32 * (ks % 4);
      wgmma_m64n64k16(sc, wgmma_desc(sQw + off, 16, 1024), wgmma_desc(sK + off, 16, 1024),
                      ks != 0);
    }
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
      for (int c = 0; c < NCB; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = ex2_approx((sc[i] - m_run[(i >> 1) & 1]) * 1.4426950408889634f);
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

    // O += P V: 16 keys per step, step ks takes pk[4ks .. 4ks + 3]; column
    // block c of V into o[c]
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t pa[4] = {pk[4 * ks], pk[4 * ks + 1], pk[4 * ks + 2], pk[4 * ks + 3]};
        wgmma_m64n64k16_ra_tb(o[c], pa,
                              wgmma_desc(sV + c * ATL_TILE + 16 * ks * 128, 16, 1024), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCB; ++c) wgmma_settle(o[c]);
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
    for (int c = 0; c < NCB; ++c)
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = pack_bf16(o[c][4 * (j0 + i) + 2 * hr] * rc,
                           o[c][4 * (j0 + i) + 2 * hr + 1] * rc);
        quad_transpose(v, q);
        const int col = 64 * c + 8 * (j0 + q);  // the head's columns alone
        if (row[hr] < S && col < HD)
          *reinterpret_cast<uint4*>(out + ((size_t)b * S + row[hr]) * D + h * HD + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
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
// causal S = 77 takes it). Given an lse pointer (exact softmax only), a row's
// log-sum-exp m + log(sum) goes there at the end, for the backward.

constexpr int TA_THREADS = 256, TA_KT = 64;
constexpr int TA_Q = 128 * 128;           // one column block of Q: 128 rows x 128 bytes
constexpr int TA_KV = 64 * 128;           // one column block of a K or Vt tile
constexpr int TA_RAW = 2 * 64 * 64 * 4;   // a raw stage: K tile | V tile, 64 x 64 fp32 each
constexpr int TA_SMEM = 1024 + 4 * TA_Q + 2 * TA_RAW + 8 * TA_KV + 16;

__global__ void __launch_bounds__(TA_THREADS, 1)
attention_tf32x3_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, int ld,
                        const float* __restrict__ mask, float* __restrict__ out, int S, int H,
                        float scale, int fast, float* __restrict__ lse) {
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
    // the exact softmax's row statistic for the backward: the quad's lanes
    // hold the same maximum and sum
    if (lse != nullptr && qq == 0)
      lse[((size_t)b * H + h) * S + row[hr]] = m_run[hr] + logf(denom[hr]);
    float* dst = out + ((size_t)b * S + row[hr]) * D + h * DH + 2 * qq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[4 * j + 2 * hr] * rc, o[4 * j + 2 * hr + 1] * rc);
  }
}

// 3-D fp32 map of one (B, S, H, 64) operand: element (b, s, column) at base
// + (b*S + s)*ld + column, H*64 columns; a box is one head (64 columns) of
// `rows` tokens of one image, tokens past S read as zeros; no swizzle (the
// block splits the tile)
int head_map_f32(CUtensorMap* map, const void* p, int B, int S, int H, int ld, int rows) {
  const uint64_t dims[3] = {(uint64_t)H * DH, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)ld * sizeof(float), (uint64_t)S * ld * sizeof(float)};
  const uint32_t box[3] = {(uint32_t)DH, (uint32_t)rows, 1u};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, p, 3, dims,
                    strides, box);
}

int launch_attention_tf32x3(const void* q, const void* k, const void* v, int ld,
                            const float* mask, void* out, float* lse, int B, int S, int H,
                            float scale, int fast, cudaStream_t stream) {
  if (B == 0 || S == 0) return 0;
  const long long blocks = (long long)((S + 127) / 128) * H * B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int rc;
  if ((rc = head_map_f32(&mk, k, B, S, H, ld, TA_KT)) != 0) return rc;
  if ((rc = head_map_f32(&mv, v, B, S, H, ld, TA_KT)) != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(attention_tf32x3_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TA_SMEM);
  if (e != cudaSuccess) return (int)e;
  attention_tf32x3_kernel<<<(unsigned)blocks, TA_THREADS, TA_SMEM, stream>>>(
      static_cast<const float*>(q), mk, mv, ld, mask, static_cast<float*>(out), S, H, scale,
      fast, lse);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_attention_long(const void* q, const void* k, const void* v, int ld,
                          const float* mask, void* out, int B, int S, int H, float scale,
                          int fast, cudaStream_t stream) {
  cudaError_t e;
  if (B == 0) return 0;
  const long long blocks = (long long)((S + 127) / 128) * H * B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = head_map(&mq, q, B, S, H, ld, 64, HD)) != 0) return rc;
  if ((rc = head_map(&mk, k, B, S, H, ld, 64, HD)) != 0) return rc;
  if ((rc = head_map(&mv, v, B, S, H, ld, 64, HD)) != 0) return rc;
  const int smem = attention_long_bf16_smem((HD + 63) / 64);
  auto kernel = attention_long_bf16_kernel<HD>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, ATL_THREADS, smem, stream>>>(mq, mk, mv, mask,
                                                          static_cast<bf16*>(out), B, S, H,
                                                          scale, fast);
  return (int)cudaGetLastError();
}

// In bf16 the whole-row kernel takes S <= 256 (a row of scores in
// registers), the key-tile kernel every longer sequence; fp32 runs its
// key-tile kernel for every S (with the rows' log-sum-exp where lse is
// given).
constexpr int ATT_WHOLE_ROW_MAX_S = 256;
constexpr int ATT_WIDE_DH = 112;  // the one head width past 64: bf16 only

// the whole-row kernel for heads of HD: two buffers where they fit beside
// the staged mask, else one
template <int HD>
int launch_attention_whole_row(const void* q, const void* k, const void* v, int ld,
                               const float* mask, void* out, int B, int S, int H, float scale,
                               int fast, cudaStream_t stream) {
  const int tile_bytes = attention_bf16_tile_bytes(S), rows = tile_bytes / 128;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = head_map(&mq, q, B, S, H, ld, rows, HD)) != 0) return rc;
  if ((rc = head_map(&mk, k, B, S, H, ld, rows, HD)) != 0) return rc;
  if ((rc = head_map(&mv, v, B, S, H, ld, rows, HD)) != 0) return rc;
  const int mask_bytes = round_up(S * S * 4, 16);
  const int stage_mask = mask != nullptr && mask_bytes <= ATT_MASK_SMEM;
  const int op_bytes = (HD + 63) / 64 * tile_bytes;
  const int fixed = 1024 + (stage_mask ? mask_bytes : 0) + 48;
  const int nbuf = fixed + 6 * op_bytes <= SMEM_MAX ? 2 : 1;
  const int bytes = fixed + 3 * nbuf * op_bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = attention_bf16_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<min(B * H, sm_count()), ATT_THREADS_BF16, bytes, stream>>>(
      mq, mk, mv, mask, static_cast<bf16*>(out), B, S, H, scale, fast, stage_mask, nbuf);
  return (int)cudaGetLastError();
}

int launch_attention(const void* q, const void* k, const void* v, int ld, const float* mask,
                     void* out, float* lse, int B, int S, int H, int hd, float scale, int fast,
                     int is_bf16, cudaStream_t stream) {
  if (hd != DH) {
    if (hd != ATT_WIDE_DH || !is_bf16 || lse != nullptr) return (int)cudaErrorInvalidValue;
    if (B == 0 || S == 0) return 0;
    if (S > ATT_WHOLE_ROW_MAX_S)
      return launch_attention_long<ATT_WIDE_DH>(q, k, v, ld, mask, out, B, S, H, scale, fast,
                                                stream);
    return launch_attention_whole_row<ATT_WIDE_DH>(q, k, v, ld, mask, out, B, S, H, scale, fast,
                                                   stream);
  }
  if (!is_bf16)
    return launch_attention_tf32x3(q, k, v, ld, mask, out, lse, B, S, H, scale, fast, stream);
  if (S > ATT_WHOLE_ROW_MAX_S)
    return launch_attention_long<DH>(q, k, v, ld, mask, out, B, S, H, scale, fast, stream);
  if (B == 0 || S == 0) return 0;
  return launch_attention_whole_row<DH>(q, k, v, ld, mask, out, B, S, H, scale, fast, stream);
}

// ---------------------------------------------------------------------------
// The gradient of the exact fp32 mha_core: replaces no TPU kernel. The JAX
// package's block VJP recomputes the block under XLA and differentiates the
// plain core (tpu_reid/models/layers.py, _block_fused's backward), and so
// did the port's fp32 block backward: scores, probabilities and their
// gradients as (B, H, S, S) fp32 tensors in device memory, six batched
// products on the CUDA cores. Here the scores never leave the block.
//
// The recompute runs attention_tf32x3_kernel (exact) with its lse output:
// each row's log-sum-exp L = m + log(sum). The gradient of O = softmax(s) V,
// s = scale Q K^T + mask, with dO given:
//   P = exp(s - L), dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O),
//   dS = P * (dP - delta), dQ = scale dS K, dK = scale dS^T Q.
// Every product is three TF32 passes on wgmma (lo*hi + hi*lo + hi*hi, as the
// forward), summed in fp32 registers.
//
// What bounds it on the H100 is the tensor-core rate of those passes: five
// products of 2 S^2 64 operations per (image, head), 67 GFLOP of TF32 at B
// 64, S 213, 12 heads (0.135 ms at 494.7 TF/s); its bytes (q, k, v, o, dO
// in, dq, dk, dv out, ~0.3 GB) take ~0.1 ms.
//
// Determinism: no atomics. dK and dV sum over the queries, dQ over the keys,
// so the work is two passes, each output row owned by one block that sums in
// one order: attention_tf32x3_kernel_bwd_dq walks the key tiles for 128 query
// rows (S = Q K^T and dP = dO V^T again, then dQ), and writes delta for the
// second pass; attention_tf32x3_kernel_bwd_dkv walks the query tiles for 128
// keys (S^T = K Q^T, dP^T = V dO^T, dV, dK). Its cost: the two score
// products run twice, seven products where five would do (+40% of the
// tensor work), against dQ summed with fp32 atomics in a run-dependent
// order or a whole head's dQ (up to 112 KB at S = 444) held beside the
// operands of one block.
//
// Both kernels: 256 threads, two warpgroups of 64 own rows, one block per
// (128 own rows, head, image), the blocks of a head adjacent in the grid so
// that its operands stay in L2. The own rows arrive once, split into hi and
// lo K-major swizzled tiles (the A operands of the score products); tiles of
// 32 streamed rows come by TMA from the strided views into a ring of two raw
// stages (rows past S arrive as zeros), then all 256 threads split each
// into hi and lo twice: K-major as stored (the B operand of a score
// product) and transposed (rows of the head dimension, 32 values each: the B
// operand of a product whose A, the probabilities or dS, comes from the
// registers that hold it, in the order 0, 2, 4, 6, 1, 3, 5, 7 of each group
// of 8, as the forward's V). Score products m64n32k8, gradient products
// m64n64k8 with A from registers, committed in groups so that the softmax
// runs under the tensor cores: P (dkv: P^T) is taken while dP's products
// run, and in the dkv pass dS^T while dV's do. P = 2^(s scale log2 e + mask
// log2 e - L log2 e) by ex2.approx (about 2 ulp): one FMA and one MUFU
// instruction in place of expf's range reduction. The
// streamed tile is 32 rows so that a block's operands fit beside the ring:
// 210 KB (dq) and 225 KB (dkv) of shared memory, one block per SM.
// Padded keys weigh 0 (P set to 0); padded query rows of the dkv pass too;
// rows past S are not stored. The additive mask is read from device memory
// where it applies (the text tower's causal S = 77).
// ---------------------------------------------------------------------------

constexpr int TB_THREADS = 256;
constexpr float TB_LOG2E = 1.4426950408889634f;
constexpr int TB_ROWS = 128;               // a block's own rows: queries (dq), keys (dkv)
constexpr int TB_T = 32;                   // the streamed tile: keys (dq), queries (dkv)
constexpr int TB_OWN = TB_ROWS * 128;      // one column block of the own rows' tile
constexpr int TB_TILE = TB_T * 128;        // one column block of a streamed tile
constexpr int TB_TR = DH * 128;            // a streamed tile transposed: 64 rows of 32 values
constexpr int TB_RAW = 2 * TB_T * DH * 4;  // a raw stage: two 32 x 64 fp32 tiles
constexpr int TB_LOADS = 4;                // own-row chunks a thread loads before using any
// dq: Q hi | lo, dO hi | lo; the ring; K hi | lo, V hi | lo, Kt hi | lo; delta of the own rows
constexpr int TB_DQ_SMEM =
    1024 + 8 * TB_OWN + 2 * TB_RAW + 8 * TB_TILE + 2 * TB_TR + 4 * TB_ROWS + 16;
// dkv: K hi | lo, V hi | lo; the ring; Q hi | lo, dO hi | lo, Qt hi | lo, dOt hi | lo; L and
// delta of a tile
constexpr int TB_DKV_SMEM =
    1024 + 8 * TB_OWN + 2 * TB_RAW + 8 * TB_TILE + 4 * TB_TR + 8 * TB_T + 16;

// 4 values of row r (16-byte chunk c of its 64 columns), split, into hi and
// lo K-major swizzled tiles whose column blocks lie `cb` bytes apart
__device__ __forceinline__ void store_split(unsigned char* hi, unsigned char* lo, int cb, int r,
                                            int c, float4 x) {
  uint32_t h[4], l[4];
  tf32_split_alu(x.x, h[0], l[0]);
  tf32_split_alu(x.y, h[1], l[1]);
  tf32_split_alu(x.z, h[2], l[2]);
  tf32_split_alu(x.w, h[3], l[3]);
  const int off = (c >> 3) * cb + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// A raw 32 x 64 tile transposed, split: row d (a head column), chunk sc
// holds tile rows 8 (sc / 2) + (sc & 1) + 0, 2, 4, 6
__device__ __forceinline__ void store_split_t(unsigned char* hi, unsigned char* lo,
                                              const float* raw, int d, int sc) {
  const int r0 = 8 * (sc >> 1) + (sc & 1);
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) tf32_split_alu(raw[(r0 + 2 * e) * DH + d], h[e], l[e]);
  const int off = d * 128 + ((sc ^ (d & 7)) << 4);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// A 64 x 32 accumulator as the register A operand of a product over its 32
// columns: k step j takes columns 8j .. 8j + 7 in store_split_t's order
__device__ __forceinline__ void a_split(const float (&x)[16], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tf32_split_alu(x[4 * j], hi[j][0], lo[j][0]);
    tf32_split_alu(x[4 * j + 2], hi[j][1], lo[j][1]);
    tf32_split_alu(x[4 * j + 1], hi[j][2], lo[j][2]);
    tf32_split_alu(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// d (64 x 32) (+)= a b over one k8 step in three TF32 passes; a and b are
// K-major tiles whose lo halves lie a_lo and b_lo bytes on
__device__ __forceinline__ void mma3_n32(float (&d)[16], uint32_t a, uint32_t a_lo, uint32_t b,
                                         uint32_t b_lo, bool first) {
  wgmma_m64n32k8_tf32(d, wgmma_desc(a + a_lo, 16, 1024), wgmma_desc(b, 16, 1024), !first);
  wgmma_m64n32k8_tf32(d, wgmma_desc(a, 16, 1024), wgmma_desc(b + b_lo, 16, 1024), 1);
  wgmma_m64n32k8_tf32(d, wgmma_desc(a, 16, 1024), wgmma_desc(b, 16, 1024), 1);
}

// d (64 x 64) += a b over one k8 step, a from registers, in three passes
__device__ __forceinline__ void mma3_ra(float (&d)[32], const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4], uint32_t b, uint32_t b_lo) {
  wgmma_m64n64k8_tf32_ra(d, lo, wgmma_desc(b, 16, 1024), 1);
  wgmma_m64n64k8_tf32_ra(d, hi, wgmma_desc(b + b_lo, 16, 1024), 1);
  wgmma_m64n64k8_tf32_ra(d, hi, wgmma_desc(b, 16, 1024), 1);
}

// rows of a warpgroup's 64 x 64 accumulator, times `mul`, as fp32 into
// (B, S, ld) rows r0, r0 + 8 (the thread's), columns h*64 ..; rows past S
// are not stored
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&x)[32],
                                           const int (&row)[2], int b, int S, int ld, int h,
                                           int qq, float mul) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= S) continue;
    float* p = dst + ((size_t)b * S + row[hr]) * ld + h * DH + 2 * qq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(p + 8 * j) =
          make_float2(x[4 * j + 2 * hr] * mul, x[4 * j + 2 * hr + 1] * mul);
  }
}

__global__ void __launch_bounds__(TB_THREADS, 1)
attention_tf32x3_kernel_bwd_dq(const float* __restrict__ q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v, int ld,
                               const float* __restrict__ o, const float* __restrict__ dout,
                               int ld_o, const float* __restrict__ lse,
                               const float* __restrict__ mask, float* __restrict__ delta,
                               float* __restrict__ dq, int ld_out, int S, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const g = smem_raw + (base - raw);  // generic address of `base`
  const uint32_t o_q = 0, o_do = o_q + 4 * TB_OWN, o_raw = o_do + 4 * TB_OWN,
                 o_k = o_raw + 2 * TB_RAW, o_v = o_k + 4 * TB_TILE, o_kt = o_v + 4 * TB_TILE,
                 o_delta = o_kt + 2 * TB_TR, o_bars = o_delta + 4 * TB_ROWS;
  float* const delta_s = reinterpret_cast<float*>(g + o_delta);
  const uint32_t bars = base + o_bars;  // raw stage landed, per stage
  const int nq = (S + TB_ROWS - 1) / TB_ROWS;
  const int q0 = (int)(blockIdx.x % nq) * TB_ROWS, h = (int)(blockIdx.x / nq) % H,
            b = (int)(blockIdx.x / nq) / H;
  const int n_tiles = (S + TB_T - 1) / TB_T;
  const int tid_b = threadIdx.x;
  const size_t stat = ((size_t)b * H + h) * S;  // (b, h) row of lse and delta

  if (tid_b == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int t) {  // thread 0: key tile t into its raw stage
    const int st = t & 1;
    const uint32_t dst = base + o_raw + st * TB_RAW;
    mbar_arrive_expect_tx(bars + 8 * st, TB_RAW);
    tma_load_3d(dst, &map_k, bars + 8 * st, h * DH, TB_T * t, b);
    tma_load_3d(dst + TB_RAW / 2, &map_v, bars + 8 * st, h * DH, TB_T * t, b);
  };
  if (tid_b == 0) {
    for (int t = 0; t < n_tiles && t < 2; ++t) fill(t);
  }

  // Q and dO of the own rows, split; delta = rowsum(dO * O) in fp32, the 16
  // lanes of a row reduced in one order, into shared memory and, for the
  // dkv pass, device memory
  {
    const size_t head = (size_t)b * S * ld + (size_t)h * DH;
    const size_t head_o = (size_t)b * S * ld_o + (size_t)h * DH;
    // TB_LOADS chunks of each operand in flight per thread before any is
    // used: the block waits on these loads alone
    for (int u0 = tid_b; u0 < TB_ROWS * 16; u0 += TB_LOADS * TB_THREADS) {
      float4 vq[TB_LOADS], vd[TB_LOADS], vo[TB_LOADS];
#pragma unroll
      for (int l = 0; l < TB_LOADS; ++l) {
        const int u = u0 + l * TB_THREADS, row = q0 + (u >> 4), c = u & 15;
        vq[l] = vd[l] = vo[l] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < S) {
          vq[l] = *reinterpret_cast<const float4*>(q + head + (size_t)row * ld + 4 * c);
          vd[l] = *reinterpret_cast<const float4*>(dout + head_o + (size_t)row * ld_o + 4 * c);
          vo[l] = *reinterpret_cast<const float4*>(o + head_o + (size_t)row * ld_o + 4 * c);
        }
      }
#pragma unroll
      for (int l = 0; l < TB_LOADS; ++l) {
        const int u = u0 + l * TB_THREADS, r = u >> 4, c = u & 15, row = q0 + r;
        store_split(g + o_q, g + o_q + 2 * TB_OWN, TB_OWN, r, c, vq[l]);
        store_split(g + o_do, g + o_do + 2 * TB_OWN, TB_OWN, r, c, vd[l]);
        float part = vd[l].x * vo[l].x + vd[l].y * vo[l].y + vd[l].z * vo[l].z +
                     vd[l].w * vo[l].w;
        part += __shfl_xor_sync(0xffffffffu, part, 8);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (c == 0) {
          delta_s[r] = part;
          if (row < S) delta[stat + row] = part;
        }
      }
    }
  }
  __syncthreads();

  const int wg = tid_b / 128, tid = tid_b % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, qq = lane & 3;
  const bool active = q0 + 64 * wg < S;
  int row[2];
  float nl_r[2], delta_r[2];  // -L in log2 units, delta
  const float* mrow[2] = {nullptr, nullptr};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int lr = 64 * wg + 16 * warp + gq + 8 * hr;
    row[hr] = q0 + lr;
    nl_r[hr] = row[hr] < S ? -lse[stat + row[hr]] * TB_LOG2E : 0.f;
    delta_r[hr] = delta_s[lr];
    if (mask != nullptr) mrow[hr] = mask + (size_t)min(row[hr], S - 1) * S;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    mbar_wait(bars + 8 * st, (uint32_t)((t >> 1) & 1));
    __syncthreads();  // both warpgroups are done with the previous tile's split operands
    const float* kr = reinterpret_cast<const float*>(g + o_raw + st * TB_RAW);
    const float* vr = kr + TB_T * DH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid_b + TB_THREADS * i, n = u >> 4, c = u & 15;
      store_split(g + o_k, g + o_k + 2 * TB_TILE, TB_TILE, n, c,
                  *reinterpret_cast<const float4*>(kr + n * DH + 4 * c));
      store_split(g + o_v, g + o_v + 2 * TB_TILE, TB_TILE, n, c,
                  *reinterpret_cast<const float4*>(vr + n * DH + 4 * c));
      store_split_t(g + o_kt, g + o_kt + TB_TR, kr, u & 63, u >> 6);
    }
    fence_proxy_async();
    __syncthreads();  // the split operands are complete; the raw stage is free
    if (tid_b == 0 && t + 2 < n_tiles) {
      fence_proxy_async();
      fill(t + 2);
    }
    if (!active) continue;

    // raw scores, then dP, in two groups, so that P is taken while dP's
    // products run: key 32t + 8j + 2qq + (e & 1) of row[e >> 1] in [4j + e]
    float sc[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks)
      mma3_n32(sc, base + o_q + (ks >> 2) * TB_OWN + wg * 64 * 128 + 32 * (ks & 3), 2 * TB_OWN,
               base + o_k + (ks >> 2) * TB_TILE + 32 * (ks & 3), 2 * TB_TILE, ks == 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks)
      mma3_n32(dp, base + o_do + (ks >> 2) * TB_OWN + wg * 64 * 128 + 32 * (ks & 3),
               2 * TB_OWN, base + o_v + (ks >> 2) * TB_TILE + 32 * (ks & 3), 2 * TB_TILE,
               ks == 0);
    wgmma_commit();
    wgmma_settle(dp);
    wgmma_wait<1>();
    wgmma_settle(sc);
    // P = 2^((s * scale + mask - L) log2 e) in place; keys past S weigh 0
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = TB_T * t + 8 * (i >> 2) + 2 * qq + (i & 1), hr = (i >> 1) & 1;
      float p = 0.f;
      if (col < S) {
        float x = nl_r[hr];
        if (mask != nullptr) x = fmaf(mrow[hr][col], TB_LOG2E, x);
        p = ex2_approx(fmaf(sc[i], scale * TB_LOG2E, x));
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    wgmma_settle(dp);
    // dS = P (dP - delta) in place
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] *= dp[i] - delta_r[(i >> 1) & 1];
    uint32_t sh[4][4], sl[4][4];
    a_split(sc, sh, sl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma3_ra(acc, sh[j], sl[j], base + o_kt + 32 * j, TB_TR);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_settle(sh[j]);
      wgmma_settle(sl[j]);
    }
  }
  if (!active) return;
  store_rows(dq, acc, row, b, S, ld_out, h, qq, scale);
}

__global__ void __launch_bounds__(TB_THREADS, 1)
attention_tf32x3_kernel_bwd_dkv(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_do,
                                const float* __restrict__ k, const float* __restrict__ v,
                                int ld, const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const float* __restrict__ mask, float* __restrict__ dk,
                                float* __restrict__ dv, int ld_out, int S, int H,
                                float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = (raw + 1023u) & ~1023u;
  unsigned char* const g = smem_raw + (base - raw);
  const uint32_t o_k = 0, o_v = o_k + 4 * TB_OWN, o_raw = o_v + 4 * TB_OWN,
                 o_q = o_raw + 2 * TB_RAW, o_do = o_q + 4 * TB_TILE, o_qt = o_do + 4 * TB_TILE,
                 o_dot = o_qt + 2 * TB_TR, o_stat = o_dot + 2 * TB_TR,
                 o_bars = o_stat + 8 * TB_T;
  float* const lse_s = reinterpret_cast<float*>(g + o_stat);  // -L log2 e, then delta, of a tile
  float* const delta_s = lse_s + TB_T;
  const uint32_t bars = base + o_bars;
  const int nk = (S + TB_ROWS - 1) / TB_ROWS;
  const int k0 = (int)(blockIdx.x % nk) * TB_ROWS, h = (int)(blockIdx.x / nk) % H,
            b = (int)(blockIdx.x / nk) / H;
  const int n_tiles = (S + TB_T - 1) / TB_T;
  const int tid_b = threadIdx.x;
  const size_t stat = ((size_t)b * H + h) * S;

  if (tid_b == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fill = [&](int t) {  // thread 0: query tile t of Q and dO into its raw stage
    const int st = t & 1;
    const uint32_t dst = base + o_raw + st * TB_RAW;
    mbar_arrive_expect_tx(bars + 8 * st, TB_RAW);
    tma_load_3d(dst, &map_q, bars + 8 * st, h * DH, TB_T * t, b);
    tma_load_3d(dst + TB_RAW / 2, &map_do, bars + 8 * st, h * DH, TB_T * t, b);
  };
  if (tid_b == 0) {
    for (int t = 0; t < n_tiles && t < 2; ++t) fill(t);
  }

  // K and V of the own keys, split (keys past S as zeros)
  {
    const size_t head = (size_t)b * S * ld + (size_t)h * DH;
    for (int u0 = tid_b; u0 < TB_ROWS * 16; u0 += TB_LOADS * TB_THREADS) {
      float4 vk[TB_LOADS], vv[TB_LOADS];
#pragma unroll
      for (int l = 0; l < TB_LOADS; ++l) {
        const int u = u0 + l * TB_THREADS, key = k0 + (u >> 4), c = u & 15;
        vk[l] = vv[l] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (key < S) {
          vk[l] = *reinterpret_cast<const float4*>(k + head + (size_t)key * ld + 4 * c);
          vv[l] = *reinterpret_cast<const float4*>(v + head + (size_t)key * ld + 4 * c);
        }
      }
#pragma unroll
      for (int l = 0; l < TB_LOADS; ++l) {
        const int u = u0 + l * TB_THREADS;
        store_split(g + o_k, g + o_k + 2 * TB_OWN, TB_OWN, u >> 4, u & 15, vk[l]);
        store_split(g + o_v, g + o_v + 2 * TB_OWN, TB_OWN, u >> 4, u & 15, vv[l]);
      }
    }
  }

  const int wg = tid_b / 128, tid = tid_b % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, qq = lane & 3;
  const bool active = k0 + 64 * wg < S;
  int key[2], kc[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    key[hr] = k0 + 64 * wg + 16 * warp + gq + 8 * hr;
    kc[hr] = min(key[hr], S - 1);  // the mask column a padded key reads
  }
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  // -L in log2 units (threads 0-31), then delta (32-63), of one query of
  // tile t: loaded a tile ahead of its use
  auto stat_of = [&](int t) {
    const int qi = TB_T * t + (tid_b & (TB_T - 1));
    return qi >= S ? 0.f : tid_b < TB_T ? -lse[stat + qi] * TB_LOG2E : delta[stat + qi];
  };
  float stat_next = tid_b < 2 * TB_T ? stat_of(0) : 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    mbar_wait(bars + 8 * st, (uint32_t)((t >> 1) & 1));
    __syncthreads();  // both warpgroups are done with the previous tile's split operands
    const float* qr = reinterpret_cast<const float*>(g + o_raw + st * TB_RAW);
    const float* dr = qr + TB_T * DH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid_b + TB_THREADS * i, n = u >> 4, c = u & 15;
      store_split(g + o_q, g + o_q + 2 * TB_TILE, TB_TILE, n, c,
                  *reinterpret_cast<const float4*>(qr + n * DH + 4 * c));
      store_split(g + o_do, g + o_do + 2 * TB_TILE, TB_TILE, n, c,
                  *reinterpret_cast<const float4*>(dr + n * DH + 4 * c));
      store_split_t(g + o_qt, g + o_qt + TB_TR, qr, u & 63, u >> 6);
      store_split_t(g + o_dot, g + o_dot + TB_TR, dr, u & 63, u >> 6);
    }
    if (tid_b < 2 * TB_T) {
      lse_s[tid_b] = stat_next;
      if (t + 1 < n_tiles) stat_next = stat_of(t + 1);
    }
    fence_proxy_async();
    __syncthreads();  // the split operands are complete; the raw stage is free
    if (tid_b == 0 && t + 2 < n_tiles) {
      fence_proxy_async();
      fill(t + 2);
    }
    if (!active) continue;

    // S^T, then dP^T, then dV, in three groups, so that P^T is taken while
    // dP^T's products run and dS^T while dV's do: query 32t + 8j + 2qq +
    // (e & 1) of key[e >> 1] in [4j + e]
    float sc[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks)
      mma3_n32(sc, base + o_k + (ks >> 2) * TB_OWN + wg * 64 * 128 + 32 * (ks & 3), 2 * TB_OWN,
               base + o_q + (ks >> 2) * TB_TILE + 32 * (ks & 3), 2 * TB_TILE, ks == 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DH / 8; ++ks)
      mma3_n32(dp, base + o_v + (ks >> 2) * TB_OWN + wg * 64 * 128 + 32 * (ks & 3), 2 * TB_OWN,
               base + o_do + (ks >> 2) * TB_TILE + 32 * (ks & 3), 2 * TB_TILE, ks == 0);
    wgmma_commit();
    wgmma_settle(dp);
    wgmma_wait<1>();
    wgmma_settle(sc);
    // P^T = 2^((s * scale + mask - L) log2 e) in sc; queries past S weigh 0
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i >> 2) + 2 * qq + (i & 1), qi = TB_T * t + c, hr = (i >> 1) & 1;
      float p = 0.f;
      if (qi < S) {
        float x = lse_s[c];
        if (mask != nullptr) x = fmaf(mask[(size_t)qi * S + kc[hr]], TB_LOG2E, x);
        p = ex2_approx(fmaf(sc[i], scale * TB_LOG2E, x));
      }
      sc[i] = p;
    }
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
    a_split(sc, ph, pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma3_ra(dva, ph[j], pl[j], base + o_dot + 32 * j, TB_TR);
    wgmma_commit();
    wgmma_settle(dva);
    wgmma_wait<1>();
    wgmma_settle(dp);
    // dS^T = P^T (dP^T - delta) in dp
#pragma unroll
    for (int i = 0; i < 16; ++i)
      dp[i] = sc[i] * (dp[i] - delta_s[8 * (i >> 2) + 2 * qq + (i & 1)]);
    a_split(dp, sh, sl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) mma3_ra(dka, sh[j], sl[j], base + o_qt + 32 * j, TB_TR);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_settle(dva);
    wgmma_settle(dka);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_settle(ph[j]);
      wgmma_settle(pl[j]);
      wgmma_settle(sh[j]);
      wgmma_settle(sl[j]);
    }
  }
  if (!active) return;
  store_rows(dk, dka, key, b, S, ld_out, h, qq, scale);
  store_rows(dv, dva, key, b, S, ld_out, h, qq, 1.f);
}

int launch_attention_backward(const void* q, const void* k, const void* v, int ld,
                              const float* o, const float* dout, int ld_o, const float* lse,
                              const float* mask, float* delta, float* dq, float* dk, float* dv,
                              int ld_out, int B, int S, int H, float scale,
                              cudaStream_t stream) {
  if (B == 0 || S == 0) return 0;
  const long long blocks = (long long)((S + TB_ROWS - 1) / TB_ROWS) * H * B;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv, mq, mdo;
  int rc;
  if ((rc = head_map_f32(&mk, k, B, S, H, ld, TB_T)) != 0) return rc;
  if ((rc = head_map_f32(&mv, v, B, S, H, ld, TB_T)) != 0) return rc;
  if ((rc = head_map_f32(&mq, q, B, S, H, ld, TB_T)) != 0) return rc;
  if ((rc = head_map_f32(&mdo, dout, B, S, H, ld_o, TB_T)) != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(attention_tf32x3_kernel_bwd_dq,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TB_DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attention_tf32x3_kernel_bwd_dkv,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, TB_DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  // dq first: it writes delta, which the dkv pass reads
  attention_tf32x3_kernel_bwd_dq<<<(unsigned)blocks, TB_THREADS, TB_DQ_SMEM, stream>>>(
      static_cast<const float*>(q), mk, mv, ld, o, dout, ld_o, lse, mask, delta, dq, ld_out, S,
      H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attention_tf32x3_kernel_bwd_dkv<<<(unsigned)blocks, TB_THREADS, TB_DKV_SMEM, stream>>>(
      mq, mdo, static_cast<const float*>(k), static_cast<const float*>(v), ld, lse, delta, mask,
      dk, dv, ld_out, S, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes; every pointer is a device pointer)
// ---------------------------------------------------------------------------

extern "C" {

// out = act(LN(splice(x)) @ w + bias); act 0: none, 1: QuickGELU, 2: SwiGLU
// (out (M, N / 2) = SiLU(gate) * up, each 128-column tile of w and bias 64
// gate columns then their 64 up columns; bf16 without LN, N % 128 == 0), 3:
// the exact (erf) GELU (bf16 without LN).
// rope (S, 2, 64) fp32 or null: the rotary embedding on output columns below
// rope_cols (bf16 without LN, act 0). x (M = B*S, K), w (K, N), bias (N,), out
// (M, N) in the working type; ln_g/ln_b (K,) fp32, or both null: no LN, the
// rows are read as they are (and plane must be null); plane (S, K) and pmask
// (S,) fp32 or both null; eps the LayerNorm's epsilon. scratch (M, K) bf16:
// the normalised rows of a bf16 LN (ln_rows), else null.
int ln_gemm(const void* x, const void* plane, const void* pmask, const void* ln_g,
            const void* ln_b, const void* w, const void* bias, const void* rope, void* out,
            void* scratch, int M, int N, int K, int S, int act, int rope_cols, float eps,
            int dtype, void* stream) {
  const int epi = rope != nullptr ? EPI_ROPE : act == 3 ? EPI_GELU_ERF : act == 2 ? EPI_SWIGLU
                : act == 1 ? EPI_GELU : EPI_BIAS;
  GemmArgs g{x, w, bias, nullptr, plane, static_cast<const float*>(pmask),
             static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out,
             M, N, K, S, epi};
  g.eps = eps;
  g.rope = static_cast<const float*>(rope);
  g.rope_cols = rope_cols;
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if ((ln_g == nullptr) != (ln_b == nullptr) || act < 0 || act > 3) return (int)cudaErrorInvalidValue;
  const bool eva = epi == EPI_ROPE || epi == EPI_SWIGLU || epi == EPI_GELU_ERF;
  if (eva && (ln_g != nullptr || dtype != DTYPE_BF16 || (rope != nullptr && act != 0) ||
              (epi == EPI_SWIGLU && N % 128) || (epi == EPI_ROPE && (rope_cols < 0 ||
                                                                    rope_cols > N))))
    return (int)cudaErrorInvalidValue;
  if (ln_g == nullptr) {
    if (plane != nullptr) return (int)cudaErrorInvalidValue;
    return launch_gemm<false>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
  }
  if (dtype == DTYPE_BF16)
    return launch_ln_rows_then_gemm(g, scratch, true, static_cast<cudaStream_t>(stream));
  return launch_gemm<true>(g, false, static_cast<cudaStream_t>(stream));
}

// out = [LN(a)] @ w + bias [+ splice(res)]. a (M, K), w (K, N), bias (N,), res
// and out (M, N); res null: no residual (and plane must be null); plane (S, N)
// and pmask (S,) fp32 or both null. ln_g / ln_b (K,) fp32, or both null: a
// LayerNorm (epsilon eps) of a's rows as the product's prologue, with a
// residual and in bf16 only (the EVA02 attention output's sub-LN), ln_rows
// into scratch (M, K) bf16 (else null) before the product; the splice then
// applies to the residual alone.
int gemm_bias_residual(const void* a, const void* ln_g, const void* ln_b, const void* w,
                       const void* bias, const void* res, const void* plane, const void* pmask,
                       void* out, void* scratch, int M, int N, int K, int S, float eps,
                       int dtype, void* stream) {
  GemmArgs g{a, w, bias, res, plane, static_cast<const float*>(pmask),
             static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out, M, N, K, S,
             res != nullptr ? EPI_RESIDUAL : EPI_BIAS};
  g.eps = eps;
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if (res == nullptr && plane != nullptr) return (int)cudaErrorInvalidValue;
  if ((ln_g == nullptr) != (ln_b == nullptr)) return (int)cudaErrorInvalidValue;
  if (ln_g != nullptr) {
    if (res == nullptr || dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
    return launch_ln_rows_then_gemm(g, scratch, false, static_cast<cudaStream_t>(stream));
  }
  return launch_gemm<false>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// out (M, K) = LN(splice(x)) over each row's first n_real columns
// (statistics; the affine over all K), bf16 x and out, ln_g / ln_b (K,) fp32;
// plane (S, K) and pmask (S,) fp32, or both null: row m reads plane[m % S]
// where pmask[m % S] > 0; K % 8 == 0, K <= 4096, 1 <= n_real <= K.
int ln_rows(const void* x, const void* plane, const void* pmask, const void* ln_g,
            const void* ln_b, void* out, int M, int K, int S, int n_real, float eps,
            void* stream) {
  return launch_ln_rows(x, nullptr, plane, static_cast<const float*>(pmask),
                        static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out, M,
                        K, S, n_real, eps, static_cast<cudaStream_t>(stream));
}

// out (M, K) = res + LN(y), the post-norm block's residual pass: y, res and
// out bf16, statistics two-pass in fp32 over all K columns, the fp32 affine
// and the residual add in fp32, one cast; ln_g / ln_b (K,) fp32. plane (S, K)
// and pmask (S,) fp32, or both null: row m of out is plane[m % S] where
// pmask[m % S] > 0 (the next block's prompt rows, spliced on store). K % 8 ==
// 0, K <= 4096.
int ln_residual(const void* y, const void* res, const void* plane, const void* pmask,
                const void* ln_g, const void* ln_b, void* out, int M, int K, int S, float eps,
                void* stream) {
  if (res == nullptr) return (int)cudaErrorInvalidValue;
  return launch_ln_rows(y, res, plane, static_cast<const float*>(pmask),
                        static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out, M,
                        K, S, K, eps, static_cast<cudaStream_t>(stream));
}

// The fp32 block backward's products, 3xTF32 on wgmma, each stage's sum
// promoted to fp32 registers; fp32 only.
// mode 0 (dgrad): out (M, N) = a (M, K) @ w^T, w (N, K): a forward product's
//   weight as stored; K % 32 == 0.
// mode 1 (dgelu): the same, times QuickGELU'(res) elementwise, res (M, N);
//   out2 (M, N), or null: QuickGELU(res).
// mode 2 (wgrad): a (K, M), w (K, N), out (splits, M, N): slab s holds
//   a^T @ w over the s-th of `splits` equal ranges of K's 32-row stages;
//   any K >= 1, 1 <= splits <= ceil(K / 32).
// mode 3 (product): out = a (M, K) @ w (K, N) + bias [+ res], res (M, N) or
//   null; K % 32 == 0.
int gemm_tf32x3_backward(const void* a, const void* w, const void* bias, const void* res,
                         void* out, void* out2, int M, int N, int K, int splits, int mode,
                         void* stream) {
  const int nk = (K + TG_BK - 1) / TG_BK;
  if (mode < 0 || mode > 3 || K < 1 || (mode != 2 && K % TG_BK) ||
      (mode == 1 && res == nullptr) || (mode == 3) != (bias != nullptr) ||
      (mode == 0 && res != nullptr) || (mode == 2 && res != nullptr) ||
      (mode != 1 && out2 != nullptr) || splits < 1 ||
      splits > nk || (mode != 2 && splits != 1))
    return (int)cudaErrorInvalidValue;
  const int epi = mode == 0 ? EPI_DGRAD : mode == 1 ? EPI_DGELU : mode == 2 ? EPI_WGRAD
                                                                             : EPI_PRODUCT;
  GemmArgs g{a, w, bias, res, nullptr, nullptr, nullptr, nullptr, out, M, N, K, 1, epi, splits,
             out2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_gemm_tf32x3<false, EPI_DGRAD>(g, st);
  if (mode == 1) return launch_gemm_tf32x3<false, EPI_DGELU>(g, st);
  if (mode == 2) return launch_gemm_tf32x3<false, EPI_WGRAD>(g, st);
  return launch_gemm_tf32x3<false, EPI_PRODUCT>(g, st);
}

// q, k, v: (B, S, H, hd) with row stride ld (elements between consecutive
// tokens; batch stride S*ld) -> out (B, S, H*hd) contiguous; hd 64, or 112
// in bf16 for S <= 256 (the whole-row kernel). mask: (S, S)
// fp32 additive mask (clamped to >= -1e30; in log2e units when fast) or null.
// bf16: S <= 256 runs the whole-row kernel, a longer sequence the key-tile
// kernel; fp32 runs its key-tile kernel for every S. lse: (B, H, S) fp32 or
// null; where given (fp32 and exact only), each row's log-sum-exp of its
// scaled, masked scores, what mha_core_backward reads.
int mha_core(const void* q, const void* k, const void* v, int ld, const void* mask,
             void* out, void* lse, int B, int S, int H, int hd, float scale, int fast,
             int dtype, void* stream) {
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if (lse != nullptr && (dtype != DTYPE_F32 || fast)) return (int)cudaErrorInvalidValue;
  return launch_attention(q, k, v, ld, static_cast<const float*>(mask), out,
                          static_cast<float*>(lse), B, S, H, hd, scale, fast,
                          dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// The gradient of mha_core's exact fp32 softmax attention for q, k and v:
// q, k, v as mha_core's (row stride ld); o, its output, and dout, the
// output's gradient, (B, S, H, 64) with row stride ld_o; lse (B, H, S) from
// mha_core's lse; mask as mha_core's exact form, or null; delta (B, H, S)
// fp32 scratch; dq, dk, dv (B, S, H, 64) with row stride ld_out (views into
// one packed (B, S, 3 * H * 64) gradient). scale 1 / sqrt(64). fp32 only.
int mha_core_backward(const void* q, const void* k, const void* v, int ld, const void* o,
                      const void* dout, int ld_o, const void* lse, const void* mask,
                      void* delta, void* dq, void* dk, void* dv, int ld_out, int B, int S,
                      int H, float scale, void* stream) {
  return launch_attention_backward(
      q, k, v, ld, static_cast<const float*>(o), static_cast<const float*>(dout), ld_o,
      static_cast<const float*>(lse), static_cast<const float*>(mask),
      static_cast<float*>(delta), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), ld_out, B, S, H, scale, static_cast<cudaStream_t>(stream));
}


const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
