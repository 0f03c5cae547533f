"""EVA02-CLIP-E/14's post-norm vision block on the hand-written CUDA kernels,
in bf16.

The block (EVA-CLIP's eva_vit_model.Block with postnorm=True) puts its
LayerNorms on the branch outputs, before the residual adds, and none before
a product; its heads are 112 wide and its MLP is an exact-GELU MLP of 15360:

    x1  = x  + LN_1(attn(x) W_o + b_o)
    out = x1 + LN_2(GELU(x1 W_1 + b_1) W_2 + b_2)

with the qkv projection's key slice without bias and LayerNorm epsilon 1e-6.
On CUDA bf16 tensors it is seven launches of the block kernels
(csrc/block_kernels.cu):

    qkv = ln_gemm(x, W_qkv, b_qkv)                     (no LayerNorm)
    a   = mha_core(q, k, v)                            (strided views, heads of 112)
    y   = ln_gemm(a, W_o, b_o)                         (the bias alone)
    x1  = ln_residual(y, x, ln_1)                      x + LN_1(y)
    h   = ln_gemm(x1, W_1, b_1, gelu_erf)              (the exact GELU)
    y2  = ln_gemm(h, W_2, b_2)                         (K = 15360)
    out = ln_residual(y2, x1, ln_2, next prompts)      x1 + LN_2(y2), spliced on store

Where each mechanism sits, and why:

  * The post-norm as a pass of its own (`ln_residual`, a mode of `ln_rows`'
    kernel): LN(y) needs each row's statistics over all D columns, which no
    128-column output tile of the product holds; the product writes y with
    its bias and the pass reads y and the residual once, rounding once.
  * The deep-prompt splice on store: the block has no pass before its qkv
    product to splice rows on load, so the closing pass of each block
    writes the next block's prompt rows in place of its own output rows.
    This block's `prompt_plane` / `prompt_mask` are therefore the NEXT
    block's (models/layers.transformer_stack's `splice_after`): the block
    computes splice(Block(x), plane). The tower's first block takes no
    splice (IVLP's layer-0 prompts are the shallow ones, appended at the
    stem); the last full block's output stays unspliced, as the tower's x11.
  * Heads of 112 on both bf16 attention kernels (ops/attention.py,
    `kernel_takes_heads`): whole rows up to S = 256 (the Market cell's 165),
    key tiles beyond (EVA-CLIP's own 224x224 input: 257 tokens). fp32 has
    no kernel of the block's modes: on CUDA tensors it raises, on CPU
    tensors it takes the plain block, counted.

The plain versions of the pieces (each wrapper's `_reference`) repeat the
kernels' arithmetic and rounding points; `eva_e_block_reference` composes
them. `_eva_e_block_xla_impl` is the plain block over its parameter dict.
The model's block (models/layers.eva_e_block) goes through
`eva_e_block_autograd`: the kernels forward, and a backward that recomputes
the plain block under autograd. `eva_e_block_route` names fp32 blocks, and
shapes outside the kernels' domains, "plain": on CPU tensors they take the
plain block and `fused_eva_e_block.plain` counts them; on CUDA tensors,
where that would quietly run the plain block on the card, they raise.

The 12 positional block tensors: W_qkv (D, 3D), b_qkv (3D,) with a zero key
slice; W_o (D, D), b_o; ln_1 scale, bias (the post-attention LN); W_1 (D, F),
b_1; W_2 (F, D), b_2; ln_2 scale, bias (the post-MLP LN).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_reid_torch.ops import attention as A
from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops.attention import xla_mha_core
from tpu_reid_torch.ops.fused_eva import _qkv_bias

Tensor = torch.Tensor

N_TENSORS = 12


def _gemm_kernel(x, w, b, gelu_erf=False):
    return FA.ln_gemm(x, None, None, w, b, gelu_erf=gelu_erf)


def _gemm_plain(x, w, b, gelu_erf=False):
    return FA.ln_gemm_reference(x, None, None, w, b, gelu_erf=gelu_erf)


_KERNELS = (_gemm_kernel, FA._attention_kernel, FA.ln_residual)
_PLAIN = (_gemm_plain, FA.attention_reference, FA.ln_residual_reference)


def _eva_e(x, w, n_heads, eps, plane, pmask, fast, pieces):
    gemm_fn, attention_fn, ln_residual_fn = pieces
    w_qkv, b_qkv, w_o, b_o, ln1_s, ln1_b, w_1, b_1, w_2, b_2, ln2_s, ln2_b = w
    qkv = gemm_fn(x, w_qkv, b_qkv)
    a = attention_fn(qkv, n_heads, None, fast)
    x1 = ln_residual_fn(gemm_fn(a, w_o, b_o), x, ln1_s, ln1_b, eps)
    h = gemm_fn(x1, w_1, b_1, gelu_erf=True)
    return ln_residual_fn(gemm_fn(h, w_2, b_2), x1, ln2_s, ln2_b, eps, plane, pmask)


def eva_e_block_reference(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                          eps: float = 1e-6, prompt_plane: Optional[Tensor] = None,
                          prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """Plain version of `fused_eva_e_block`, rounding where the kernels do."""
    return _eva_e(x, weights, n_heads, eps, prompt_plane, prompt_mask, fast, _PLAIN)


def fused_eva_e_block(x: Tensor, weights: Sequence[Tensor], n_heads: int, eps: float = 1e-6,
                      prompt_plane: Optional[Tensor] = None,
                      prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """One post-norm block, (B, S, D) -> (B, S, D): seven launches on CUDA
    tensors (see the module's notes), the plain versions on CPU tensors.
    prompt_plane / prompt_mask: the next block's deep-prompt rows, spliced
    into the output."""
    out = _eva_e(x, weights, n_heads, eps, prompt_plane, prompt_mask, fast, _KERNELS)
    if x.is_cuda:
        fused_eva_e_block.launches += 1
    return out


fused_eva_e_block.launches = 0
fused_eva_e_block.plain = 0


def eva_e_block_route(x: Tensor, weights: Sequence[Tensor], n_heads: int) -> str:
    """How `eva_e_block_autograd` takes a block: "kernel" (bf16, every launch
    in its kernel's domain: the attention kernels' head widths
    (`attention.kernel_takes_heads`), `check_gemm_operands` of the four
    products, `check_ln_rows_operands` of the two residual passes; on CPU
    tensors the wrappers' plain versions) or "plain" (fp32: the modes run in
    bf16 only; or a shape outside a domain). Decided from dtype and sizes."""
    if x.dtype != torch.bfloat16 or len(weights) != N_TENSORS:
        return "plain"
    b, s, d = x.shape
    rows, f = b * s, weights[6].shape[1]
    if d % n_heads or not A.kernel_takes_heads(d // n_heads, x.dtype):
        return "plain"
    try:
        FA.check_gemm_operands("eva_e", rows, d, 3 * d, False, {})
        FA.check_gemm_operands("eva_e", rows, d, d, False, {})
        FA.check_gemm_operands("eva_e", rows, d, f, False, {}, mode="gelu_erf")
        FA.check_gemm_operands("eva_e", rows, f, d, False, {})
        FA.check_ln_rows_operands("eva_e", rows, d, d, {})
    except ValueError:
        return "plain"
    return "kernel"


# ---------------------------------------------------------------------------
# the plain post-norm block over its parameter dict
# ---------------------------------------------------------------------------
#
# Parameters of one block: attn {in_proj {w (D, 3D), b (3D,) whose key slice
# is zero and stays zero}, out_proj {w, b}}; ln_1 {scale, bias} (the LN of the
# attention branch's output); mlp {fc1 {w (D, F), b}, fc2 {w (F, D), b}}; ln_2
# {scale, bias} (the LN of the MLP's output).


def eva_e_block_params(w) -> dict:
    """The 12 positional block tensors as the parameter dict."""
    return {
        "attn": {"in_proj": {"w": w[0], "b": w[1]}, "out_proj": {"w": w[2], "b": w[3]}},
        "ln_1": {"scale": w[4], "bias": w[5]},
        "mlp": {"fc1": {"w": w[6], "b": w[7]}, "fc2": {"w": w[8], "b": w[9]}},
        "ln_2": {"scale": w[10], "bias": w[11]},
    }


def eva_e_tensors(p: dict, dt: torch.dtype) -> tuple:
    """The parameter dict as the 12 positional tensors, the products' weights
    and biases in the activations' dtype (LayerNorm parameters as they are)."""
    a, m = p["attn"], p["mlp"]
    return (a["in_proj"]["w"].to(dt), a["in_proj"]["b"].to(dt),
            a["out_proj"]["w"].to(dt), a["out_proj"]["b"].to(dt),
            p["ln_1"]["scale"], p["ln_1"]["bias"],
            m["fc1"]["w"].to(dt), m["fc1"]["b"].to(dt), m["fc2"]["w"].to(dt),
            m["fc2"]["b"].to(dt), p["ln_2"]["scale"], p["ln_2"]["bias"])


def eva_e_mlp(m: dict, x: Tensor) -> Tensor:
    """The exact-GELU MLP, (..., D) -> (..., D), without its LayerNorm."""
    return FA.linear(m["fc2"], FA.gelu_erf(FA.linear(m["fc1"], x)))


def _eva_e_block_xla_impl(p: dict, x: Tensor, n_heads: int, eps: float) -> Tensor:
    """Plain post-norm block: x1 = x + LN_1(attn(x) W_o + b_o), then
    x1 + LN_2(MLP(x1)); the key projection without bias."""
    b, s, d = x.shape
    dh = d // n_heads
    qkv = x @ p["attn"]["in_proj"]["w"].to(x.dtype) + _qkv_bias(
        p["attn"]["in_proj"]["b"], d).to(x.dtype)
    q, k, v = (t.reshape(b, s, n_heads, dh) for t in qkv.split(d, dim=-1))
    attn = xla_mha_core(q, k, v, None).reshape(b, s, d)
    x = x + FA.layer_norm(p["ln_1"], FA.linear(p["attn"]["out_proj"], attn), eps)
    return x + FA.layer_norm(p["ln_2"], eva_e_mlp(p["mlp"], x), eps)


def eva_e_block_plain(p: dict, x: Tensor, n_heads: int, eps: float,
                      plane: Optional[Tensor] = None, pmask: Optional[Tensor] = None) -> Tensor:
    """The plain block with the next block's prompt rows spliced into its
    output: what `fused_eva_e_block` computes."""
    return FA.splice_plane(_eva_e_block_xla_impl(p, x, n_heads, eps), plane, pmask)


class _EvaEBlockFn(torch.autograd.Function):
    """Forward: `fused_eva_e_block` (the kernels on CUDA tensors), saving only
    x, the plane, the prompt mask and the tensors passed in. Backward: the
    plain block (`eva_e_block_plain`) recomputed under autograd, its
    gradients for x, the plane and the tensors."""

    @staticmethod
    def forward(ctx, x, plane, pmask, n_heads, eps, fast, *weights):
        ctx.n_heads, ctx.eps = n_heads, eps
        ctx.save_for_backward(x, plane, pmask, *weights)
        return fused_eva_e_block(x, weights, n_heads, eps, plane, pmask, fast)

    @staticmethod
    def backward(ctx, g):
        x, plane, pmask, *weights = ctx.saved_tensors
        dx, dplane, *dws = FA.recompute_grads(
            lambda x, plane, *ws: eva_e_block_plain(eva_e_block_params(ws), x, ctx.n_heads,
                                                    ctx.eps, plane, pmask),
            (x, plane, *weights), g)
        return (dx, dplane, None, None, None, None, *dws)


def eva_e_block_autograd(x: Tensor, weights: Sequence[Tensor], n_heads: int,
                         eps: float = 1e-6, prompt_plane: Optional[Tensor] = None,
                         prompt_mask: Optional[Tensor] = None, fast: bool = False) -> Tensor:
    """The post-norm block with gradients, as `eva_e_block_route` routes it:
    the kernels forward through `_EvaEBlockFn` (no graph when nothing needs
    grad); outside the kernels' domains the plain block on CPU tensors
    (counted in `fused_eva_e_block.plain`) and ValueError on CUDA tensors
    (`kernel_impl("plain")` runs the plain block there)."""
    if eva_e_block_route(x, weights, n_heads) == "plain":
        if x.is_cuda:
            raise ValueError(
                f"eva_e_block: x {tuple(x.shape)} {x.dtype} with {n_heads} heads has no kernel "
                "route (the post-norm block's kernels run in bf16, at widths their GEMM and "
                "ln_rows domains take)")
        fused_eva_e_block.plain += 1
        return eva_e_block_plain(eva_e_block_params(weights), x, n_heads, eps, prompt_plane,
                                 prompt_mask)
    return _EvaEBlockFn.apply(x, prompt_plane, prompt_mask, n_heads, eps, fast, *weights)
