"""Functional transformer building blocks over plain parameter dicts.

Params are nested dicts of tensors with the JAX package's structure and
layouts: linear weights are (in, out), a stack of blocks carries a leading
layer axis. Every function is ``f(params, x, ...) -> y``.

The model-facing blocks live here; the plain math under them (LayerNorm with
fp32 statistics, `linear`, QuickGELU, the MLP, the splice and the plain
blocks) lives in ops/fused_attention.py and ops/fused_eva.py, beside the
kernels it is held against, and is imported here. `ops._build.kernel_impl`
selects how a block runs: "auto" (the default) takes the hand-written CUDA
kernels for CUDA tensors and the plain PyTorch block for CPU tensors;
"kernel" always goes through the kernel wrappers (which take their plain
versions on CPU tensors); "plain" always takes the plain block. The kernel
path always goes through the blocks' autograd Function
(ops/fused_attention.fused_block_autograd): kernels forward; backward a
recompute of the block, in fp32 with its gradient products on the same
kernels (the chain written out), in bf16 the plain block under autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_reid_torch.ops import attention as A
from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops import fused_eva as FE
from tpu_reid_torch.ops import fused_eva_e as FEE
from tpu_reid_torch.ops._build import use_kernels
from tpu_reid_torch.ops.fused_attention import (  # noqa: F401  (quick_gelu: for the models)
    layer_norm, linear, mlp, quick_gelu, splice_plane)
from tpu_reid_torch.ops.fused_eva import _eva_attn_out, _eva_mlp, _qkv_bias

Tensor = torch.Tensor


def multi_head_attention(p: dict, x: Tensor, n_heads: int,
                         mask: Optional[Tensor] = None) -> Tensor:
    """Self-attention over (B, S, D) with a fused qkv projection (p holds
    "in_proj" and "out_proj"); `mask` additive (S, S) or None. Under
    `use_kernels(x)` it runs as `fused_mha` without LN (three launches on CUDA
    tensors), otherwise the plain einsum path with an fp32 softmax."""
    if use_kernels(x):
        dt = x.dtype
        return FA.fused_mha(x, p["in_proj"]["w"].to(dt), p["in_proj"]["b"].to(dt),
                            p["out_proj"]["w"].to(dt), p["out_proj"]["b"].to(dt), n_heads, mask,
                            fast=A.fast_softmax_enabled())
    b, s, d = x.shape
    dh = d // n_heads
    q, k, v = linear(p["in_proj"], x).split(d, dim=-1)
    out = A.xla_mha_core(q.reshape(b, s, n_heads, dh), k.reshape(b, s, n_heads, dh),
                         v.reshape(b, s, n_heads, dh), mask)
    return linear(p["out_proj"], out.reshape(b, s, d))


def residual_block(
    p: dict,
    x: Tensor,
    n_heads: int,
    mask: Optional[Tensor] = None,
    prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None,
) -> Tensor:
    """Pre-norm transformer block: x + attn(ln1 x); x + mlp(ln2 x).

    Under `use_kernels(x)` the block runs as the three hand-written kernels
    (five launches), in fp32 and in bf16, with the deep-prompt splice fused
    into them, always through the blocks' autograd Function (with no input
    needing grad it builds no graph and runs just the kernels). Its backward
    recomputes the block: in fp32 through the kernels, then every gradient
    product on the fp32 GEMM kernel (`fused_attention.fused_block_backward`);
    in bf16 the plain block under autograd. The weight casts to the activation dtype stay outside the Function, so the
    gradients reach fp32 master weights through the cast (bf16-activation
    training). Otherwise the plain block runs after an out-of-kernel
    splice."""
    if use_kernels(x):
        dt = x.dtype
        a, m = p["attn"], p["mlp"]
        tensors = (
            p["ln_1"]["scale"], p["ln_1"]["bias"],
            a["in_proj"]["w"].to(dt), a["in_proj"]["b"].to(dt),
            a["out_proj"]["w"].to(dt), a["out_proj"]["b"].to(dt),
            p["ln_2"]["scale"], p["ln_2"]["bias"],
            m["c_fc"]["w"].to(dt), m["c_fc"]["b"].to(dt),
            m["c_proj"]["w"].to(dt), m["c_proj"]["b"].to(dt),
        )
        return FA.fused_block_autograd(x, *tensors, n_heads, mask, prompt_plane=prompt_plane,
                                       prompt_mask=prompt_mask, fast=A.fast_softmax_enabled())
    return FA._block_xla_impl(p, splice_plane(x, prompt_plane, prompt_mask), n_heads, mask)


def residual_block_cls(p: dict, x: Tensor, n_heads: int) -> Tensor:
    """Last-block path for CLS-only consumers: the block's output at position
    0 only, (B, 1, D).

    Exact: position 0's output depends on the rest of the sequence only
    through attention K/V, and the MLP is per-token. Plain math throughout
    (its cost is the full-sequence K/V projection, one (B*S, D) x (D, 2D)
    product)."""
    b, s, d = x.shape
    dh = d // n_heads
    h = layer_norm(p["ln_1"], x)
    w_in = p["attn"]["in_proj"]["w"].to(x.dtype)
    b_in = p["attn"]["in_proj"]["b"].to(x.dtype)
    wq, wk, wv = w_in.split(d, dim=1)
    bq, bk, bv = b_in.split(d)
    q = h[:, :1] @ wq + bq                      # (B, 1, D)
    k = h @ wk + bk                             # (B, S, D)
    v = h @ wv + bv
    q = q.reshape(b, 1, n_heads, dh)
    k = k.reshape(b, s, n_heads, dh)
    v = v.reshape(b, s, n_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    probs = torch.softmax(scores * (dh ** -0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, d)
    x0 = x[:, :1] + linear(p["attn"]["out_proj"], out)
    return x0 + mlp(p["mlp"], layer_norm(p["ln_2"], x0))


# ---------------------------------------------------------------------------
# the EVA02 block (EVA-CLIP's EVA02 vision towers; its parameters and plain
# block: ops/fused_eva.py)
# ---------------------------------------------------------------------------


def eva_block(p: dict, x: Tensor, n_heads: int, mask: Optional[Tensor] = None,
              prompt_plane: Optional[Tensor] = None, prompt_mask: Optional[Tensor] = None, *,
              rope: Tensor, eps: float = 1e-6, f_real: int) -> Tensor:
    """The EVA02 block, called as `residual_block` is (no attention mask:
    the vision tower has none). Under `use_kernels(x)` it goes through
    `fused_eva.eva_block_autograd`: in bf16 the hand-written kernels (eight
    launches, the splice fused), with the plain block recomputed under
    autograd for the backward; fp32, or shapes outside the kernels' domains,
    the plain block (counted in `fused_eva_block.plain`). Otherwise the plain
    block after an out-of-kernel splice."""
    if mask is not None:
        raise ValueError("eva_block: the EVA02 vision block takes no attention mask")
    if use_kernels(x):
        return FE.eva_block_autograd(x, FE._eva_tensors(p, x.dtype), n_heads, rope, f_real, eps,
                                     prompt_plane, prompt_mask, fast=A.fast_softmax_enabled())
    return FE._eva_block_xla_impl(p, splice_plane(x, prompt_plane, prompt_mask), n_heads, rope,
                                  eps, f_real)


def eva_block_cls(p: dict, x: Tensor, n_heads: int, *, rope: Tensor, eps: float = 1e-6,
                  f_real: int) -> Tensor:
    """`residual_block_cls` of the EVA02 block: its output at position 0
    only, (B, 1, D): the CLS query (its table row is the identity: it is not
    rotated) against every token's rotated key. Plain math throughout."""
    b, s, d = x.shape
    dh = d // n_heads
    h = layer_norm(p["ln_1"], x, eps)
    w_in = p["attn"]["in_proj"]["w"].to(x.dtype)
    b_in = _qkv_bias(p["attn"]["in_proj"]["b"], d).to(x.dtype)
    wq, wk, wv = w_in.split(d, dim=1)
    bq, bk, bv = b_in.split(d)
    q = (h[:, :1] @ wq + bq).reshape(b, 1, n_heads, dh)
    k = (h @ wk + bk).reshape(b, s, n_heads, dh)
    v = (h @ wv + bv).reshape(b, s, n_heads, dh)
    q, k = FA.rotate_pairs(q, rope[:1]), FA.rotate_pairs(k, rope)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    probs = torch.softmax(scores * (dh ** -0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, d)
    x0 = x[:, :1] + _eva_attn_out(p["attn"], out, eps)
    return x0 + _eva_mlp(p["mlp"], layer_norm(p["ln_2"], x0, eps), eps, f_real)


# ---------------------------------------------------------------------------
# EVA02-CLIP-E/14's post-norm block (its parameters, plain block and kernels:
# ops/fused_eva_e.py)
# ---------------------------------------------------------------------------


def eva_e_block(p: dict, x: Tensor, n_heads: int, mask: Optional[Tensor] = None,
                prompt_plane: Optional[Tensor] = None, prompt_mask: Optional[Tensor] = None, *,
                eps: float = 1e-6) -> Tensor:
    """The post-norm block, called as `residual_block` is, except that the
    deep-prompt plane and mask are the NEXT block's, spliced into this
    block's output (`transformer_stack(splice_after=True)`): the block has no
    pass before its first product to splice on load. Under `use_kernels(x)`
    it goes through `fused_eva_e.eva_e_block_autograd`: in bf16 the
    hand-written kernels (seven launches), with the plain block recomputed
    under autograd for the backward; fp32, or shapes outside the kernels'
    domains, the plain block on CPU tensors (counted in
    `fused_eva_e_block.plain`), ValueError on CUDA tensors. Otherwise the
    plain block, then the splice."""
    if mask is not None:
        raise ValueError("eva_e_block: the EVA02-E vision block takes no attention mask")
    if use_kernels(x):
        return FEE.eva_e_block_autograd(x, FEE.eva_e_tensors(p, x.dtype), n_heads, eps,
                                        prompt_plane, prompt_mask,
                                        fast=A.fast_softmax_enabled())
    return FEE.eva_e_block_plain(p, x, n_heads, eps, prompt_plane, prompt_mask)


def eva_e_block_cls(p: dict, x: Tensor, n_heads: int, *, eps: float = 1e-6) -> Tensor:
    """`residual_block_cls` of the post-norm block: its output at position 0
    only, (B, 1, D): the CLS query against every token's key and value, the
    branch LayerNorms and the MLP on the one row. Plain math throughout."""
    b, s, d = x.shape
    dh = d // n_heads
    w_in = p["attn"]["in_proj"]["w"].to(x.dtype)
    b_in = _qkv_bias(p["attn"]["in_proj"]["b"], d).to(x.dtype)
    wq, wk, wv = w_in.split(d, dim=1)
    bq, bk, bv = b_in.split(d)
    q = (x[:, :1] @ wq + bq).reshape(b, 1, n_heads, dh)
    k = (x @ wk + bk).reshape(b, s, n_heads, dh)
    v = (x @ wv + bv).reshape(b, s, n_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    probs = torch.softmax(scores * (dh ** -0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, 1, d)
    x0 = x[:, :1] + layer_norm(p["ln_1"], linear(p["attn"]["out_proj"], out), eps)
    return x0 + layer_norm(p["ln_2"], FEE.eva_e_mlp(p["mlp"], x0), eps)


def splice_prompt_tokens(x: Tensor, prompt: Tensor, text_side: bool) -> Tensor:
    """Replace the prompt-token positions of a sequence with new tokens.

      * vision: the prompt tokens live at the END — drop the last n_ctx
        outputs and append this layer's tokens,
      * text: the prompt tokens sit right after SOS — keep position 0,
        replace positions 1..n_ctx, keep the suffix.
    """
    n_ctx = prompt.shape[0]
    b = x.shape[0]
    tok = prompt.to(x.dtype).expand(b, n_ctx, x.shape[-1])
    if text_side:
        return torch.cat([x[:, :1], tok, x[:, 1 + n_ctx:]], dim=1)
    return torch.cat([x[:, : x.shape[1] - n_ctx], tok], dim=1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def slice_layer(stacked: dict, idx) -> dict:
    """One layer's params (or a sub-stack, for a slice) of a stacked dict."""
    return _tree_map(lambda a: a[idx], stacked)


def num_layers(stacked: dict) -> int:
    return int(stacked["ln_1"]["scale"].shape[0])


def transformer_stack(
    stacked: dict,
    x: Tensor,
    n_heads: int,
    mask: Optional[Tensor] = None,
    deep_prompts: Optional[Tensor] = None,
    prompt_flags: Optional[Sequence[bool]] = None,
    text_side: bool = False,
    block_fn=None,
    splice_after: bool = False,
) -> Tensor:
    """Run a stack of residual blocks whose params have a leading layer axis.

    deep_prompts: (L, n_ctx, D) per-layer prompt tokens; prompt_flags: (L,)
    bools — layer i splices its tokens before the block iff flags[i]. The
    splice is a (S, D) plane plus an (S, 1) row mask, fused into the block
    kernels on the kernel path. block_fn: the block, called as
    `residual_block` (the default) is, e.g. a bound `eva_block`.
    splice_after: block_fn splices the plane it is given into its output
    (`eva_e_block`): block i gets layer i + 1's plane, layer 0's is spliced
    before the first block, and the stack's last block gets none, so the
    result is the same sequence as with a splice before each block."""
    block_fn = block_fn or residual_block
    n_layers = num_layers(stacked)
    if deep_prompts is None:
        for i in range(n_layers):
            x = block_fn(slice_layer(stacked, i), x, n_heads, mask)
        return x

    n_ctx, dim = deep_prompts.shape[1:]
    s = x.shape[1]
    row0 = 1 if text_side else s - n_ctx
    planes = deep_prompts.new_zeros((n_layers, s, dim))
    planes[:, row0: row0 + n_ctx] = deep_prompts
    rowmask = torch.zeros(s, 1, dtype=torch.float32, device=x.device)
    rowmask[row0: row0 + n_ctx] = 1.0
    if splice_after:
        if prompt_flags[0]:
            x = splice_plane(x, planes[0], rowmask)
        for i in range(n_layers):
            nxt = i + 1 < n_layers
            x = block_fn(
                slice_layer(stacked, i), x, n_heads, mask,
                prompt_plane=planes[i + 1] if nxt else None,
                prompt_mask=rowmask * float(bool(prompt_flags[i + 1])) if nxt else None,
            )
        return x
    for i in range(n_layers):
        x = block_fn(
            slice_layer(stacked, i), x, n_heads, mask,
            prompt_plane=planes[i],
            prompt_mask=rowmask * float(bool(prompt_flags[i])),
        )
    return x


def causal_mask(n: int, device=None) -> Tensor:
    """CLIP's additive causal mask."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)
