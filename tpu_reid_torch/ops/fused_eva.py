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
them. The model's EVA block (models/layers.eva_block) goes through
`eva_block_autograd`: the kernels forward, and a backward that recomputes
the plain EVA block (`layers._eva_block_xla_impl`) under autograd.
`eva_block_route` sends fp32 blocks, and shapes outside the kernels'
domains, to the plain block, and `fused_eva_block.plain` counts them.

The 16 positional block tensors: ln_1 scale, bias; W_qkv (D, 3D), b_qkv
(3D,) with a zero key slice; ln_attn scale, bias; W_o (D, D), b_o; ln_2
scale, bias; W_gu (D, 2 F_pad), b_gu (2 F_pad,) packed gate | up by
64-column groups; ffn_ln scale, bias (F_pad,); W_3 (F_pad, D), b_3 (D,).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_reid_torch.ops import fused_attention as FA

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


class _EvaBlockFn(torch.autograd.Function):
    """Forward: `fused_eva_block` (the kernels on CUDA tensors), saving only
    x, the plane, the prompt mask, the rope table and the tensors passed in.
    Backward: the plain EVA block (`layers._eva_block_xla_impl` after the
    splice) recomputed under autograd, its gradients for x, the plane and
    the tensors."""

    @staticmethod
    def forward(ctx, x, plane, pmask, rope, n_heads, f_real, eps, fast, *weights):
        ctx.n_heads, ctx.f_real, ctx.eps = n_heads, f_real, eps
        ctx.save_for_backward(x, plane, pmask, rope, *weights)
        return fused_eva_block(x, weights, n_heads, rope, f_real, eps, plane, pmask, fast)

    @staticmethod
    def backward(ctx, g):
        from tpu_reid_torch.models.layers import (_apply_splice_plane, _eva_block_xla_impl,
                                                  eva_block_params)

        x, plane, pmask, rope, *weights = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_()
            ws = [w.detach().requires_grad_() for w in weights]
            xin = xs
            ps = None
            if plane is not None:
                ps = plane.detach().requires_grad_()
                xin = _apply_splice_plane(xs, ps, pmask)
            out = _eva_block_xla_impl(eva_block_params(ws), xin, ctx.n_heads, rope, ctx.eps,
                                      ctx.f_real)
            inputs = [xs] + ([ps] if ps is not None else []) + ws
            grads = iter(torch.autograd.grad(out, inputs, g, allow_unused=True))
        dx = next(grads)
        dplane = next(grads) if ps is not None else None
        dws = list(grads)
        return (dx, dplane, None, None, None, None, None, None, *dws)


def eva_block_autograd(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                       rope: Tensor, f_real: int, eps: float = 1e-6,
                       prompt_plane: Optional[Tensor] = None,
                       prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """The EVA02 block with gradients, as `eva_block_route` routes it: the
    kernels forward through `_EvaBlockFn` (no graph when nothing needs
    grad), or the plain block (counted in `fused_eva_block.plain`)."""
    if eva_block_route(x, weights, n_heads, f_real) == "plain":
        from tpu_reid_torch.models.layers import (_apply_splice_plane, _eva_block_xla_impl,
                                                  eva_block_params)

        fused_eva_block.plain += 1
        if prompt_plane is not None:
            x = _apply_splice_plane(x, prompt_plane, prompt_mask)
        return _eva_block_xla_impl(eva_block_params(weights), x, n_heads, rope, eps, f_real)
    return _EvaBlockFn.apply(x, prompt_plane, prompt_mask, rope, n_heads, f_real, eps, fast,
                             *weights)
