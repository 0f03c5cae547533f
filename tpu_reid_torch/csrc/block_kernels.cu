// Hand-written Hopper (sm_90a) kernels for one pre-norm CLIP block.
//
// Replaces tpu_reid/ops/fused_attention.py::fused_block (Pallas kernel
// _whole_block_kernel, attention core _attention_heads). The TPU kernel keeps
// the whole block's weights (about 14 MB in bf16) resident in VMEM; an SM has
// 227 KB of shared memory, so the block becomes five launches of three
// kernels:
//
//   ln_gemm             LN1 -> qkv GEMM + bias           (and LN2 -> c_fc +
//                       bias + QuickGELU); LayerNorm statistics in fp32, fp32
//                       affine, the normalised rows rounded to the working
//                       type on the way into shared memory. With a deep-prompt
//                       plane, spliced rows are read from the plane instead.
//   attention           full-row softmax attention for S <= 256, dh = 64,
//                       reading q, k and v straight from the (B, S, 3D) qkv
//                       buffer and writing (B, S, D); exact or fast
//                       (exp2 with a saturating clamp) softmax, both
//                       normalised late by the row reciprocal.
//   gemm_bias_residual  out-proj / c_proj GEMM, bias and residual added in
//                       fp32, then the cast. The out-proj residual applies the
//                       same deep-prompt splice as ln_gemm's row load.
//
// What bounds them on the H100: the four GEMMs are ~97% of the block's
// operations (2*S*(4*D^2 + 2*D*hid) per image), so at ViT-B width the block
// is bound by tensor-core rate, not by the ~1 GB of activations it moves per
// 64 images; attention alone is bound by its bytes (qkv in, heads out). The
// design answers that only partly in this first version: bf16 GEMMs run
// mma.sync m16n8k16 (fp32 accumulation) on ldmatrix fragments of 128x128x32
// shared-memory tiles per 256-thread block, with the next tile's global loads
// in flight in registers during the current tile's MMAs; bf16 attention keeps
// scores and probabilities in registers so only q, k, v and the head output
// touch memory; the fp32 paths are plain FMA. There is no TMA, wgmma or
// persistent scheduling yet, so the kernels run below the bound; their
// measured times stand in PERF.md.
//
// bf16 rounding points mirror the Pallas kernel: LN output cast back to the
// working type, qkv cast after the bias, probabilities cast before p@v, the
// head output cast after the reciprocal, x1 cast after the residual, the MLP
// hidden activation cast after QuickGELU.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fragment helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); fragment layouts of the PTX ISA:
// a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); d0,d1 (g, 2t..), d2,d3 (g+8, 2t..)
// with g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// GEMM with LayerNorm prologue / bias, QuickGELU or residual epilogue
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, GEMM_THREADS = 256;
constexpr int LN_MAX_K = 1024;  // LayerNorm width the prologue holds
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

// Source row of each tile row (the activation, or the prompt plane where the
// LN path splices; null past M) and, with LN, the fp32 gamma/beta staged in
// shared memory (ln_s: [gamma | beta]) and each row's fp32 statistics: a
// warp loads RG rows into registers at once (K <= LN_MAX_K), then takes two
// passes over each. Ends with a barrier.
template <typename T, bool LN>
__device__ __forceinline__ void gemm_rows(const GemmArgs& g, int m0, const T** row_src,
                                          float* row_mean, float* row_rstd, float* ln_s) {
  constexpr int VEC = Vec<T>::N, NV = LN_MAX_K / (32 * VEC), RG = 16 / NV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < BM) {
    const int m = m0 + tid;
    const T* p = nullptr;
    if (m < g.M) {
      p = static_cast<const T*>(g.a) + (size_t)m * g.K;
      if (LN && g.plane != nullptr) {
        const int s = m % g.S;
        if (g.pmask[s] > 0.f) p = static_cast<const T*>(g.plane) + (size_t)s * g.K;
      }
    }
    row_src[tid] = p;
  }
  if (LN) {
    for (int k = tid; k < g.K; k += GEMM_THREADS) {
      ln_s[k] = g.ln_g[k];
      ln_s[LN_MAX_K + k] = g.ln_b[k];
    }
  }
  __syncthreads();
  if (!LN) return;
  for (int r0 = warp * RG; r0 < BM; r0 += (GEMM_THREADS / 32) * RG) {
    uint4 u[RG][NV];
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      const T* p = row_src[r0 + q];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (lane + 32 * i) * VEC;
        u[q][i] = (p != nullptr && c < g.K) ? *reinterpret_cast<const uint4*>(p + c)
                                             : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      float f[VEC], s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        unpack_vec<T>(u[q][i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += f[e];
      }
      const float mean = warp_sum(s) / g.K;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if ((lane + 32 * i) * VEC >= g.K) continue;
        unpack_vec<T>(u[q][i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v += (f[e] - mean) * (f[e] - mean);
      }
      const float rstd = rsqrtf(warp_sum(v) / g.K + 1e-5f);
      if (lane == 0) {
        const bool live = row_src[r0 + q] != nullptr;
        row_mean[r0 + q] = live ? mean : 0.f;
        row_rstd[r0 + q] = live ? rstd : 0.f;
      }
    }
  }
  __syncthreads();
}

// acc + bias, then QuickGELU (fp32) or + splice(residual), for output (m, n)
template <typename T>
__device__ __forceinline__ float epi_value(const GemmArgs& g, int m, int n, float v) {
  v += to_f(static_cast<const T*>(g.bias)[n]);
  if (g.epi == EPI_GELU) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (g.epi == EPI_RESIDUAL) {
    const int s = m % g.S;
    const T* r = (g.plane != nullptr && g.pmask[s] > 0.f)
                     ? static_cast<const T*>(g.plane) + (size_t)s * g.N
                     : static_cast<const T*>(g.res) + (size_t)m * g.N;
    v += to_f(r[n]);
  }
  return v;
}

// ---- bf16: mma.sync m16n8k16 from ldmatrix fragments, two shared stages ----
//
// 8 warps as 2 (M) x 4 (N), each a 64x32 tile of 4x4 m16n8 accumulators.
// The next K-tile's global loads are issued into registers before the
// current tile's MMAs and stored (normalised, with LN) into the other stage
// after them: one barrier per K-step. Row strides (40 and 136 elements) keep
// every ldmatrix row in its own banks.

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <bool LN>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_bf16_kernel(GemmArgs g) {
  constexpr int VEC = 8, AS = BK + 8, BS = BN + 8;
  constexpr int A_VECS = BM * BK / VEC / GEMM_THREADS, B_VECS = BK * BN / VEC / GEMM_THREADS;
  __shared__ __align__(128) bf16 As[2][BM * AS];
  __shared__ __align__(128) bf16 Bs[2][BK * BS];
  __shared__ const bf16* row_src[BM];
  __shared__ float row_mean[BM], row_rstd[BM];
  __shared__ float ln_s[LN ? 2 * LN_MAX_K : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* W = static_cast<const bf16*>(g.w);
  gemm_rows<bf16, LN>(g, m0, row_src, row_mean, row_rstd, ln_s);

  uint4 ra[A_VECS], rb[B_VECS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS, r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
      const bf16* p = row_src[r];
      ra[i] = p != nullptr ? *reinterpret_cast<const uint4*>(p + k0 + c)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS, r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
      rb[i] = n0 + c < g.N
                  ? *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.N + n0 + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stash = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS, r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
      bf16* dst = &As[buf][r * AS + c];
      if (LN && row_src[r] != nullptr) {
        const bf16* e = reinterpret_cast<const bf16*>(&ra[i]);
        const float mean = row_mean[r], rstd = row_rstd[r];
        float f[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          f[j] = (to_f(e[j]) - mean) * rstd * ln_s[k0 + c + j] + ln_s[LN_MAX_K + k0 + c + j];
        store_vec<bf16>(dst, f);
      } else {
        *reinterpret_cast<uint4*>(dst) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * GEMM_THREADS, r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
      *reinterpret_cast<uint4*>(&Bs[buf][r * BS + c]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = g.K / BK;

  fetch(0);
  stash(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], &As[buf][(wm + i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[buf][(kk + (lane & 15)) * BS + wn + jj * 16 + (lane >> 4) * 8]);
        bfr[2 * jj][0] = r[0];
        bfr[2 * jj][1] = r[1];
        bfr[2 * jj + 1][0] = r[2];
        bfr[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    if (kt + 1 < nk) stash(buf ^ 1, (kt + 1) * BK);
    __syncthreads();
  }

  // accumulator (i, j): rows wm+16i+g (+8), columns wn+8j+2t, +1
  const int gq = lane >> 2, tq = lane & 3;
  bf16* out = static_cast<bf16*>(g.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm + i * 16 + gq + 8 * hr;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * tq;
        if (n >= g.N) continue;
        const float v0 = epi_value<bf16>(g, m, n, acc[i][j][2 * hr]);
        const float v1 = epi_value<bf16>(g, m, n + 1, acc[i][j][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(out + (size_t)m * g.N + n) = pack_bf16(v0, v1);
      }
    }
}

// ---- fp32: plain FMA --------------------------------------------------------
//
// 16x16 threads, each an 8x8 strided micro-tile (rows ty+16i, cols tx+16j)
// so shared reads are broadcasts or consecutive words; one shared stage.

template <bool LN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(GemmArgs g) {
  constexpr int VEC = 4, AS = BK + 4, BS = BN + 4;
  __shared__ __align__(128) float As[BM * AS];
  __shared__ __align__(128) float Bs[BK * BS];
  __shared__ const float* row_src[BM];
  __shared__ float row_mean[BM], row_rstd[BM];
  __shared__ float ln_s[LN ? 2 * LN_MAX_K : 1];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* W = static_cast<const float*>(g.w);
  gemm_rows<float, LN>(g, m0, row_src, row_mean, row_rstd, ln_s);

  const int tx = tid & 15, ty = tid >> 4;
  float facc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    for (int v = tid; v < BM * BK / VEC; v += GEMM_THREADS) {
      const int r = v / (BK / VEC), c = (v % (BK / VEC)) * VEC;
      const float* p = row_src[r];
      float f[VEC] = {0.f, 0.f, 0.f, 0.f};
      if (p != nullptr) {
        load_vec<float>(p + k0 + c, f);
        if (LN) {
          const float mean = row_mean[r], rstd = row_rstd[r];
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            f[i] = (f[i] - mean) * rstd * ln_s[k0 + c + i] + ln_s[LN_MAX_K + k0 + c + i];
        }
      }
      store_vec<float>(As + r * AS + c, f);
    }
    for (int v = tid; v < BK * BN / VEC; v += GEMM_THREADS) {
      const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < g.N) u = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * g.N + n0 + c);
      *reinterpret_cast<uint4*>(Bs + r * BS + c) = u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * AS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * BS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(g.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < g.N) out[(size_t)m * g.N + n] = epi_value<float>(g, m, n, facc[i][j]);
    }
  }
}

template <bool LN>
int launch_gemm(const GemmArgs& g, bool is_bf16, cudaStream_t stream) {
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  if (is_bf16)
    gemm_bf16_kernel<LN><<<grid, GEMM_THREADS, 0, stream>>>(g);
  else
    gemm_f32_kernel<LN><<<grid, GEMM_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// attention: one block per (query tile of 64 rows, head, batch row), four
// warps of 16 query rows each; K and V of the head for the whole sequence in
// shared memory (S <= 256, dh = 64)
// ---------------------------------------------------------------------------

constexpr int QT = 64, DH = 64, ATT_THREADS = 128;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Copy `rows` rows of 64 head elements (row stride ld in global) into shared
// memory rows of stride st; rows past `valid` are zero. The row stride must
// keep 16-byte alignment when `vector` (one 16-byte store per vector),
// otherwise elements are stored one by one.
template <typename T, bool vector>
__device__ __forceinline__ void load_head_rows(T* dst, int st, const T* src, size_t ld,
                                               int rows, int valid) {
  constexpr int VEC = Vec<T>::N;
  for (int v = threadIdx.x; v < rows * (DH / VEC); v += ATT_THREADS) {
    const int r = v / (DH / VEC), c = (v % (DH / VEC)) * VEC;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) u = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    if (vector) {
      *reinterpret_cast<uint4*>(dst + r * st + c) = u;
    } else {
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * st + c + i] = e[i];
    }
  }
}

// ---- bf16: scores and probabilities stay in registers ----------------------
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). Per warp, S = Q K^T is
// 16 rows x s_pad keys held as s_pad/8 accumulator tiles; the row softmax
// reduces across the four lanes of a quad; the probabilities, rounded to
// bf16, are re-packed in registers as the A operand of O = P V, whose B
// fragments come from V with ldmatrix.trans. Shared memory holds Q [64][72],
// K [s_pad][72] and V [s_pad][72] (a 144-byte row stride keeps every
// fragment load below bank-conflict free).

constexpr int KV_STRIDE = DH + 8;

__host__ __device__ inline int attention_bf16_smem(int s_pad) {
  return (QT + 2 * s_pad) * KV_STRIDE * (int)sizeof(bf16);
}

// NT_MAX: register tiles reserved for s_pad / 8 key tiles (s_pad <= 8*NT_MAX)
template <int NT_MAX>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                      bf16* __restrict__ out, int S, int H, float scale, int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = round_up(S, 16), nt = s_pad / 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + QT * KV_STRIDE;
  bf16* sV = sK + s_pad * KV_STRIDE;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * S * ld + h * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  load_head_rows<bf16, true>(sQ, KV_STRIDE, base + (size_t)q0 * ld, ld, QT, S - q0);
  load_head_rows<bf16, true>(sK, KV_STRIDE, base + D, ld, s_pad, S);
  load_head_rows<bf16, true>(sV, KV_STRIDE, base + 2 * D, ld, s_pad, S);
  __syncthreads();

  // this warp's 16 query rows as A fragments, k over dh in 4 steps of 16
  const bf16* qw = sQ + (warp * 16 + g) * KV_STRIDE + 2 * t;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    qa[ks][0] = ld_b32(qw + ks * 16);
    qa[ks][1] = ld_b32(qw + 8 * KV_STRIDE + ks * 16);
    qa[ks][2] = ld_b32(qw + ks * 16 + 8);
    qa[ks][3] = ld_b32(qw + 8 * KV_STRIDE + ks * 16 + 8);
  }

  // raw scores: tile j covers keys 8j..8j+7
  float sc[NT_MAX][4];
#pragma unroll
  for (int j = 0; j < NT_MAX; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if (j < nt) {
      const bf16* kp = sK + (8 * j + g) * KV_STRIDE + 2 * t;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_bf16(sc[j], qa[ks], ld_b32(kp + ks * 16), ld_b32(kp + ks * 16 + 8));
    }
  }

  // softmax over the two rows this thread holds: rows[0] = g, rows[1] = g+8
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* mrow[2] = {nullptr, nullptr};
  if (mask != nullptr) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mrow[hr] = mask + (size_t)min(qrow[hr], S - 1) * S;
  }
  float denom[2] = {0.f, 0.f};
  if (fast) {
    // exp2(min(s*scale*log2e + mask*log2e, 120)): the caller passes scale
    // and mask in log2e units; padded columns contribute 0
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, col = 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (col < S) {
          float v = sc[j][e] * scale;
          if (mrow[hr] != nullptr) v += mrow[hr][col];
          p = exp2f(fminf(v, 120.f));
        }
        sc[j][e] = p;
        denom[hr] += p;
      }
    }
  } else {
    float mx[2] = {-3.402823466e38f, -3.402823466e38f};
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, col = 8 * j + 2 * t + (e & 1);
        float v = -1e30f;
        if (col < S) {
          v = sc[j][e] * scale;
          if (mrow[hr] != nullptr) v += mrow[hr][col];
        }
        sc[j][e] = v;
        mx[hr] = fmaxf(mx[hr], v);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        denom[e >> 1] += p;
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 1);
    denom[hr] += __shfl_xor_sync(0xffffffffu, denom[hr], 2);
    if (fast) denom[hr] = fmaxf(denom[hr], 1e-30f);
  }

  // O = P V over key chunks of 16 (two score tiles), dh in 8 tiles of 8
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NT_MAX / 2; ++kc) {
    if (2 * kc >= nt) continue;
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
    pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
    pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
    pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
    for (int jj = 0; jj < DH / 16; ++jj) {
      uint32_t r[4];
      ldsm_x4_trans(r, sV + (16 * kc + (lane & 15)) * KV_STRIDE + jj * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * jj], pa, r[0], r[1]);
      mma_bf16(o[2 * jj + 1], pa, r[2], r[3]);
    }
  }

  // scale by the row reciprocal, cast, store (B, S, D)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (qrow[hr] >= S) continue;
    const float rc = 1.f / denom[hr];
    bf16* orow = out + ((size_t)b * S + qrow[hr]) * D + h * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const uint32_t v = pack_bf16(o[n][2 * hr] * rc, o[n][2 * hr + 1] * rc);
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = v;
    }
  }
}

// ---- fp32: plain FMA (the fp32 parity runs and the fp32 text tower) --------
//
// Shared memory: Q [64][64], K [s_pad][65] (odd stride: the score loop reads
// K rows across lanes), V [s_pad][64], scores [64][s_pad+4] overwritten in
// place by the probabilities, and the row reciprocals.

__host__ __device__ inline int attention_f32_smem(int s_pad) {
  return (QT * DH + s_pad * (DH + 1) + s_pad * DH + QT * (s_pad + 4) + QT) *
         (int)sizeof(float);
}

__global__ void __launch_bounds__(ATT_THREADS)
attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     float* __restrict__ out, int S, int H, float scale, int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int s_pad = round_up(S, 16), ss = s_pad + 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + QT * DH;
  float* sV = sK + s_pad * (DH + 1);
  float* sS = sV + s_pad * DH;
  float* sR = sS + QT * ss;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t ld = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * S * ld + h * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  load_head_rows<float, true>(sQ, DH, base + (size_t)q0 * ld, ld, QT, S - q0);
  load_head_rows<float, false>(sK, DH + 1, base + D, ld, s_pad, S);
  load_head_rows<float, true>(sV, DH, base + 2 * D, ld, s_pad, S);
  __syncthreads();

  for (int i = tid; i < QT * s_pad; i += ATT_THREADS) {
    const int r = i / s_pad, c = i % s_pad;
    float acc = 0.f;
#pragma unroll 16
    for (int k = 0; k < DH; ++k) acc = fmaf(sQ[r * DH + k], sK[c * (DH + 1) + k], acc);
    sS[r * ss + c] = acc;
  }
  __syncthreads();

  for (int r = warp; r < QT; r += ATT_THREADS / 32) {
    const int q = q0 + r;
    float* srow = sS + r * ss;
    if (q >= S) {
      for (int c = lane; c < s_pad; c += 32) srow[c] = 0.f;
      if (lane == 0) sR[r] = 0.f;
      continue;
    }
    const float* mrow = mask != nullptr ? mask + (size_t)q * S : nullptr;
    float denom = 0.f;
    if (fast) {
      for (int c = lane; c < s_pad; c += 32) {
        float p = 0.f;
        if (c < S) {
          float v = srow[c] * scale;
          if (mrow != nullptr) v += mrow[c];
          p = exp2f(fminf(v, 120.f));
        }
        denom += p;
        srow[c] = p;
      }
      denom = fmaxf(warp_sum(denom), 1e-30f);
    } else {
      float mx = -3.402823466e38f;
      for (int c = lane; c < s_pad; c += 32) {
        float v = -1e30f;
        if (c < S) {
          v = srow[c] * scale;
          if (mrow != nullptr) v += mrow[c];
        }
        srow[c] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      for (int c = lane; c < s_pad; c += 32) {
        const float p = expf(srow[c] - mx);
        denom += p;
        srow[c] = p;
      }
      denom = warp_sum(denom);
    }
    if (lane == 0) sR[r] = 1.f / denom;
  }
  __syncthreads();

  float* obase = out + ((size_t)b * S + q0) * D + h * DH;
  for (int i = tid; i < QT * DH; i += ATT_THREADS) {
    const int r = i / DH, d = i % DH;
    if (q0 + r >= S) continue;
    const float* prow = sS + r * ss;
    float acc = 0.f;
    for (int c = 0; c < s_pad; ++c) acc = fmaf(prow[c], sV[c * DH + d], acc);
    obase[(size_t)r * D + d] = acc * sR[r];
  }
}

int launch_attention(const void* qkv, const float* mask, void* out, int B, int S, int H,
                     float scale, int fast, int is_bf16, cudaStream_t stream) {
  const int s_pad = round_up(S, 16);
  dim3 grid((S + QT - 1) / QT, H, B);
  cudaError_t e;
  if (!is_bf16) {
    const int bytes = attention_f32_smem(s_pad);
    e = cudaFuncSetAttribute(attention_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attention_f32_kernel<<<grid, ATT_THREADS, bytes, stream>>>(
        static_cast<const float*>(qkv), mask, static_cast<float*>(out), S, H, scale, fast);
    return (int)cudaGetLastError();
  }
  const int bytes = attention_bf16_smem(s_pad);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
#define ATTN_BF16(NT)                                                                   \
  e = cudaFuncSetAttribute(attention_bf16_kernel<NT>,                                   \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);         \
  if (e != cudaSuccess) return (int)e;                                                  \
  attention_bf16_kernel<NT><<<grid, ATT_THREADS, bytes, stream>>>(q, mask, o, S, H, scale, \
                                                                   fast);
  if (s_pad <= 64) {
    ATTN_BF16(8)
  } else if (s_pad <= 128) {
    ATTN_BF16(16)
  } else if (s_pad <= 224) {
    ATTN_BF16(28)
  } else {
    ATTN_BF16(32)
  }
#undef ATTN_BF16
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes; every pointer is a device pointer)
// ---------------------------------------------------------------------------

extern "C" {

// out = act(LN(splice(x)) @ w + bias); act = QuickGELU when gelu != 0.
// x (M = B*S, K), w (K, N), bias (N,), out (M, N) in the working type;
// ln_g/ln_b (K,) fp32; plane (S, K) and pmask (S,) fp32 or both null.
int ln_gemm(const void* x, const void* plane, const void* pmask, const void* ln_g,
            const void* ln_b, const void* w, const void* bias, void* out, int M, int N,
            int K, int S, int gelu, int dtype, void* stream) {
  GemmArgs g{x, w, bias, nullptr, plane, static_cast<const float*>(pmask),
             static_cast<const float*>(ln_g), static_cast<const float*>(ln_b), out,
             M, N, K, S, gelu ? EPI_GELU : EPI_BIAS};
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  return launch_gemm<true>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// out = a @ w + bias + splice(res). a (M, K), w (K, N), bias (N,), res and
// out (M, N); plane (S, N) and pmask (S,) fp32 or both null.
int gemm_bias_residual(const void* a, const void* w, const void* bias, const void* res,
                       const void* plane, const void* pmask, void* out, int M, int N,
                       int K, int S, int dtype, void* stream) {
  GemmArgs g{a, w, bias, res, plane, static_cast<const float*>(pmask), nullptr, nullptr,
             out, M, N, K, S, EPI_RESIDUAL};
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  return launch_gemm<false>(g, dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

// qkv (B, S, 3*H*64) -> out (B, S, H*64). mask: (S, S) fp32 additive mask
// (clamped to >= -1e30; in log2e units when fast) or null.
int attention(const void* qkv, const void* mask, void* out, int B, int S, int H,
              float scale, int fast, int dtype, void* stream) {
  if (dtype != DTYPE_BF16 && dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  return launch_attention(qkv, static_cast<const float*>(mask), out, B, S, H, scale, fast,
                          dtype == DTYPE_BF16, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
