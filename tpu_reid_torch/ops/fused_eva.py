"""The EVA02 vision block (EVA-CLIP's EVA02-CLIP-L/14) on the hand-written
CUDA kernels, in bf16.

EVA02's block differs from OpenAI CLIP's pre-LN block (ops/fused_attention.py)
in its attention path (2D rotary embeddings on q and k, a LayerNorm of the
attention output inside the residual branch), its MLP (SwiGLU, then a
LayerNorm over the hidden width), LayerNorm epsilon 1e-6 and a key
projection without bias. On CUDA bf16 tensors it is eight launches of the
block kernels (csrc/block_kernels.cu):

    h1  = ln_rows(x, ln_1)                             (the deep-prompt splice on load)
    qkv = ln_gemm(h1, W_qkv, b_qkv, rope)              (RoPE on q and k)
    a   = mha_core(q, k, v)                            (strided views of qkv)
    x1  = gemm_bias_residual(a, W_o, b_o, x, ln=ln_attn)   (sub-LN prologue, splice
                                                        on the residual)
    h2  = ln_rows(x1, ln_2)
    u   = ln_gemm(h2, W_gu, b_gu, swiglu)              (SiLU(gate) * up, u written once)
    hn  = ln_rows(u, ffn_ln, F)                        (statistics over the F real columns)
    out = gemm_bias_residual(hn, W_3, b_3, x1)

Where each mechanism sits, and why (the kernels' header comments hold the
details):

  * LN_1 and LN_2 as passes of their own (`ln_rows`), not as the GEMM's
    LayerNorm prologue: at K = 1024 the prologue keeps 64-row panels, so
    each W tile serves 64 rows; the kernel's 256-row mode on normalised
    rows runs the qkv and gate | up products ~2.5x faster, for a pass of
    2 x 171 MB per 256 images.
  * RoPE in the qkv product's epilogue: each thread holds 8 consecutive
    columns of a row after the epilogue's exchange, four whole pairs of one
    head, so the rotation is 8 multiply-adds and two 32-byte table reads in
    registers before the one cast, and both attention kernels (whole-row and
    key-tile) read q and k rotated without a change. Rotating at
    `mha_core`'s load instead would put the table reads on the attention
    kernels' critical path, once per query tile for every key tile.
  * SwiGLU in the gate | up product's epilogue: the weight is packed so that
    each 128-column output tile holds 64 gate columns and their 64 up
    columns, which then lie in the same thread; u is written once, half the
    width of the product.
  * The attention output's sub-LN as the out-projection's LayerNorm prologue
    (K = D = 1024 fits the kernel's resident row panel) with the residual
    epilogue: one launch.
  * The MLP's sub-LN over F = 2730 as a pass of its own (`ln_rows`): a
    resident panel of the padded 2752 columns does not fit an SM's shared
    memory. The hidden width is stored padded to a multiple of 64 (the
    packed tiles), with zero weights, biases, gamma and beta past F, so the
    padded columns of u and of its LayerNorm are zero and the statistics
    are taken over the F real columns alone.

The plain versions of the pieces (each wrapper's `_reference`) repeat the
kernels' arithmetic and rounding points; `eva_block_reference` composes
them. `_eva_block_xla_impl` is the plain EVA block over its parameter dict
(the parity path). The model's EVA block (models/layers.eva_block) goes
through `eva_block_autograd`: the kernels forward, and a backward that
recomputes the plain EVA block under autograd. `eva_block_route` sends fp32
blocks, and shapes outside the kernels' domains, to the plain block, and
`fused_eva_block.plain` counts them.

The 16 positional block tensors: ln_1 scale, bias; W_qkv (D, 3D), b_qkv
(3D,) with a zero key slice; ln_attn scale, bias; W_o (D, D), b_o; ln_2
scale, bias; W_gu (D, 2 F_pad), b_gu (2 F_pad,) packed gate | up by
64-column groups; ffn_ln scale, bias (F_pad,); W_3 (F_pad, D), b_3 (D,).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops.attention import xla_mha_core

Tensor = torch.Tensor

N_TENSORS = 16


def padded_hidden(f: int) -> int:
    """The stored hidden width: F rounded up to a multiple of 64, so that
    each packed 128-column tile of the gate | up product is whole."""
    return -(-f // 64) * 64


def _eva(x, w, n_heads, rope, f_real, eps, plane, pmask, fast, pieces):
    ln_gemm_fn, attention_fn, gemm_fn, ln_rows_fn = pieces
    (ln1_s, ln1_b, w_qkv, b_qkv, lna_s, lna_b, w_o, b_o, ln2_s, ln2_b, w_gu, b_gu,
     lnf_s, lnf_b, w_3, b_3) = w
    d = x.shape[-1]
    h1 = ln_rows_fn(x, ln1_s, ln1_b, d, eps, plane, pmask)
    qkv = ln_gemm_fn(h1, None, None, w_qkv, b_qkv, rope=rope, rope_cols=2 * d)
    a = attention_fn(qkv, n_heads, None, fast)
    x1 = gemm_fn(a, w_o, b_o, x, plane, pmask, ln_scale=lna_s, ln_bias=lna_b, eps=eps)
    h2 = ln_rows_fn(x1, ln2_s, ln2_b, d, eps)
    u = ln_gemm_fn(h2, None, None, w_gu, b_gu, swiglu=True)
    u = ln_rows_fn(u, lnf_s, lnf_b, f_real, eps)
    return gemm_fn(u, w_3, b_3, x1)


_KERNELS = (FA.ln_gemm, FA._attention_kernel, FA.gemm_bias_residual, FA.ln_rows)
_PLAIN = (FA.ln_gemm_reference, FA.attention_reference, FA.gemm_bias_residual_reference,
          FA.ln_rows_reference)


def eva_block_reference(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                        rope: Tensor, f_real: int, eps: float = 1e-6,
                        prompt_plane: Optional[Tensor] = None,
                        prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """Plain version of `fused_eva_block`, rounding where the kernels do."""
    return _eva(x, weights, n_heads, rope, f_real, eps, prompt_plane, prompt_mask, fast, _PLAIN)


def fused_eva_block(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                    rope: Tensor, f_real: int, eps: float = 1e-6,
                    prompt_plane: Optional[Tensor] = None,
                    prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """One EVA02 block, (B, S, D) -> (B, S, D): eight launches on CUDA tensors
    (see the module's notes), the plain versions on CPU tensors. rope: the
    (S, 2, 64) fp32 cos / sin table (identity rows for CLS and the prompt
    tokens); f_real: the real hidden width F (the tensors hold
    padded_hidden(F)); prompt_plane / prompt_mask: the deep-prompt splice,
    before the block and in the attention's residual."""
    out = _eva(x, weights, n_heads, rope, f_real, eps, prompt_plane, prompt_mask, fast,
               _KERNELS)
    if x.is_cuda:
        fused_eva_block.launches += 1
    return out


fused_eva_block.launches = 0
fused_eva_block.plain = 0


def eva_block_route(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                    f_real: int) -> str:
    """How `eva_block_autograd` takes a block: "kernel" (bf16, every launch
    in its kernel's domain: `check_gemm_operands` of the four products in
    their modes, `check_ln_rows_operands` of the three passes, heads of 64;
    on CPU tensors the wrappers' plain versions) or "plain" (fp32: the EVA
    modes run in bf16 only; or a shape outside a domain). Decided from dtype
    and sizes."""
    if x.dtype != torch.bfloat16 or len(weights) != N_TENSORS:
        return "plain"
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    f_pad = weights[10].shape[1] // 2
    try:
        if d % n_heads or d // n_heads != 64 or f_pad != padded_hidden(f_real):
            raise ValueError("heads of 64 and a hidden width padded to 64")
        FA.check_ln_rows_operands("eva", rows, d, d, {})
        FA.check_gemm_operands("eva", rows, d, 3 * d, False, {}, mode="rope")
        FA.check_gemm_operands("eva", rows, d, d, True, {}, mode="ln_residual")
        FA.check_gemm_operands("eva", rows, d, 2 * f_pad, False, {}, mode="swiglu")
        FA.check_gemm_operands("eva", rows, f_pad, d, False, {})
        FA.check_ln_rows_operands("eva", rows, f_pad, f_real, {})
    except ValueError:
        return "plain"
    return "kernel"


# ---------------------------------------------------------------------------
# the plain EVA02 block over its parameter dict
# ---------------------------------------------------------------------------
#
# Parameters of one block, in the kernels' layout: ln_1, ln_2 {scale, bias};
# attn {in_proj {w (D, 3D), b (3D,) whose key slice is zero and stays zero},
# ln {scale, bias} (the sub-LN over D), out_proj {w, b}}; mlp {w12 {w (D,
# 2 F_pad), b}: gate and up packed by 64-column groups (columns 128t .. 128t +
# 63 gate columns 64t .., the next 64 the matching up columns), ffn_ln {scale,
# bias} (F_pad,) (the sub-LN over F), w3 {w (F_pad, D), b}}. F_pad is F rounded
# up to 64; the padding is zero, and the plain block reads only the F real
# columns, so it gets no gradient.


def eva_block_params(w) -> dict:
    """The 16 positional EVA block tensors as the parameter dict."""
    return {
        "ln_1": {"scale": w[0], "bias": w[1]},
        "attn": {"in_proj": {"w": w[2], "b": w[3]}, "ln": {"scale": w[4], "bias": w[5]},
                 "out_proj": {"w": w[6], "b": w[7]}},
        "ln_2": {"scale": w[8], "bias": w[9]},
        "mlp": {"w12": {"w": w[10], "b": w[11]}, "ffn_ln": {"scale": w[12], "bias": w[13]},
                "w3": {"w": w[14], "b": w[15]}},
    }


def _eva_tensors(p: dict, dt: torch.dtype) -> tuple:
    """The parameter dict as the 16 positional tensors, the products' weights
    and biases in the activations' dtype (LayerNorm parameters as they are)."""
    a, m = p["attn"], p["mlp"]
    ln_a, ln_f = a["ln"], m["ffn_ln"]
    return (p["ln_1"]["scale"], p["ln_1"]["bias"],
            a["in_proj"]["w"].to(dt), a["in_proj"]["b"].to(dt), ln_a["scale"], ln_a["bias"],
            a["out_proj"]["w"].to(dt), a["out_proj"]["b"].to(dt),
            p["ln_2"]["scale"], p["ln_2"]["bias"],
            m["w12"]["w"].to(dt), m["w12"]["b"].to(dt), ln_f["scale"], ln_f["bias"],
            m["w3"]["w"].to(dt), m["w3"]["b"].to(dt))


def _qkv_bias(b: Tensor, d: int) -> Tensor:
    """The packed qkv bias with its key slice held at zero (the key
    projection has no bias): no gradient reaches that slice."""
    return torch.cat([b[:d], torch.zeros_like(b[d:2 * d]), b[2 * d:]])


def _eva_mlp(m: dict, x: Tensor, eps: float, f_real: int) -> Tensor:
    """SwiGLU over the packed gate | up, the sub-LN over the F real columns,
    the down projection: (..., D) -> (..., D), without the residual."""
    gu = FA.linear(m["w12"], x).unflatten(-1, (-1, 2, 64))
    u = (torch.nn.functional.silu(gu[..., 0, :].float())
         * gu[..., 1, :].float()).to(x.dtype).flatten(-2)[..., :f_real]
    ln = m["ffn_ln"]
    u = FA.layer_norm({"scale": ln["scale"][:f_real], "bias": ln["bias"][:f_real]}, u, eps)
    w3 = m["w3"]
    return u @ w3["w"][:f_real].to(x.dtype) + w3["b"].to(x.dtype)


def _eva_attn_out(a: dict, out: Tensor, eps: float) -> Tensor:
    """The attention output's sub-LN, then the output projection."""
    return FA.linear(a["out_proj"], FA.layer_norm(a["ln"], out, eps))


def _eva_block_xla_impl(p: dict, x: Tensor, n_heads: int, rope: Tensor, eps: float,
                        f_real: int) -> Tensor:
    """Plain EVA02 block: x + proj(LN_attn(attn(RoPE q, RoPE k, v of
    LN_1 x))); then x + W_3 LN_ffn(SiLU(W_1 g) * W_2 g), g = LN_2 x. RoPE
    from a (S, 2, 64) cos / sin table (identity rows where a token is not
    rotated), in fp32 on the projected q and k."""
    b, s, d = x.shape
    dh = d // n_heads
    h = FA.layer_norm(p["ln_1"], x, eps)
    w_in = p["attn"]["in_proj"]["w"].to(x.dtype)
    qkv = h @ w_in + _qkv_bias(p["attn"]["in_proj"]["b"], d).to(x.dtype)
    q, k, v = (t.reshape(b, s, n_heads, dh) for t in qkv.split(d, dim=-1))
    q, k = FA.rotate_pairs(q, rope), FA.rotate_pairs(k, rope)
    attn = xla_mha_core(q, k, v, None).reshape(b, s, d)
    x = x + _eva_attn_out(p["attn"], attn, eps)
    return x + _eva_mlp(p["mlp"], FA.layer_norm(p["ln_2"], x, eps), eps, f_real)


class _EvaBlockFn(torch.autograd.Function):
    """Forward: `fused_eva_block` (the kernels on CUDA tensors), saving only
    x, the plane, the prompt mask, the rope table and the tensors passed in.
    Backward: the plain EVA block (`_eva_block_xla_impl` after the splice)
    recomputed under autograd, its gradients for x, the plane and the
    tensors."""

    @staticmethod
    def forward(ctx, x, plane, pmask, rope, n_heads, f_real, eps, fast, *weights):
        ctx.n_heads, ctx.f_real, ctx.eps = n_heads, f_real, eps
        ctx.save_for_backward(x, plane, pmask, rope, *weights)
        return fused_eva_block(x, weights, n_heads, rope, f_real, eps, plane, pmask, fast)

    @staticmethod
    def backward(ctx, g):
        x, plane, pmask, rope, *weights = ctx.saved_tensors
        dx, dplane, *dws = FA.recompute_grads(
            lambda x, plane, *ws: _eva_block_xla_impl(
                eva_block_params(ws), FA.splice_plane(x, plane, pmask), ctx.n_heads, rope,
                ctx.eps, ctx.f_real),
            (x, plane, *weights), g)
        return (dx, dplane, None, None, None, None, None, None, *dws)


def eva_block_autograd(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                       rope: Tensor, f_real: int, eps: float = 1e-6,
                       prompt_plane: Optional[Tensor] = None,
                       prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """The EVA02 block with gradients, as `eva_block_route` routes it: the
    kernels forward through `_EvaBlockFn` (no graph when nothing needs
    grad), or the plain block (counted in `fused_eva_block.plain`)."""
    if eva_block_route(x, weights, n_heads, f_real) == "plain":
        fused_eva_block.plain += 1
        return _eva_block_xla_impl(eva_block_params(weights),
                                   FA.splice_plane(x, prompt_plane, prompt_mask), n_heads, rope,
                                   eps, f_real)
    return _EvaBlockFn.apply(x, prompt_plane, prompt_mask, rope, n_heads, f_real, eps, fast,
                             *weights)
