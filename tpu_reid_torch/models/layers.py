"""Functional transformer building blocks over plain parameter dicts.

Params are nested dicts of tensors with the JAX package's structure and
layouts: linear weights are (in, out), a stack of blocks carries a leading
layer axis. Every function is ``f(params, x, ...) -> y``.

Numerical conventions shared with CLIP: LayerNorm statistics in fp32 even
under bf16 activations, QuickGELU activation, pre-norm residual blocks.

`kernel_impl` selects how a block runs: "auto" (the default) takes the
hand-written CUDA kernels for CUDA tensors and the plain PyTorch block for
CPU tensors; "kernel" always goes through the kernel wrappers (which take
their plain versions on CPU tensors); "plain" always takes the plain block.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from tpu_reid_torch.ops import attention as A

Tensor = torch.Tensor


def layer_norm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, output cast back to
    the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


def linear(p: dict, x: Tensor) -> Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mlp(p: dict, x: Tensor) -> Tensor:
    return linear(p["c_proj"], quick_gelu(linear(p["c_fc"], x)))


_KERNEL_IMPL = "auto"  # "auto" | "kernel" | "plain"


def set_kernel_impl(impl: str) -> None:
    """Select the block implementation:
      * "kernel" — the hand-written CUDA kernels (ops/fused_attention.py,
        ops/fused_tail.py); their wrappers take the plain versions on CPU
        tensors,
      * "plain" — the plain PyTorch block (the parity path),
      * "auto" — kernels for CUDA tensors, plain for CPU tensors (default)."""
    global _KERNEL_IMPL
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"kernel impl must be auto, kernel or plain: {impl!r}")
    _KERNEL_IMPL = impl


@contextlib.contextmanager
def kernel_impl(impl: str):
    """Scoped `set_kernel_impl`."""
    global _KERNEL_IMPL
    prev = _KERNEL_IMPL
    set_kernel_impl(impl)
    try:
        yield
    finally:
        _KERNEL_IMPL = prev


def use_kernels(x: Tensor) -> bool:
    if _KERNEL_IMPL == "auto":
        return x.is_cuda
    return _KERNEL_IMPL == "kernel"


def _block_xla_impl(p: dict, x: Tensor, n_heads: int,
                    mask: Optional[Tensor]) -> Tensor:
    """Plain pre-norm block body (the name keeps the JAX counterpart's)."""
    b, s, d = x.shape
    dh = d // n_heads
    h = layer_norm(p["ln_1"], x)
    qkv = linear(p["attn"]["in_proj"], h)
    q, k, v = qkv.split(d, dim=-1)
    attn = A.xla_mha_core(
        q.reshape(b, s, n_heads, dh), k.reshape(b, s, n_heads, dh),
        v.reshape(b, s, n_heads, dh), mask,
    )
    x = x + linear(p["attn"]["out_proj"], attn.reshape(b, s, d))
    return x + mlp(p["mlp"], layer_norm(p["ln_2"], x))


def _apply_splice_plane(x: Tensor, plane: Tensor, pmask: Tensor) -> Tensor:
    """Out-of-kernel prompt splice: rows where pmask > 0 come from plane."""
    return torch.where(pmask.reshape(1, -1, 1) > 0, plane.to(x.dtype)[None], x)


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
    into them; otherwise the plain block runs after an out-of-kernel splice."""
    if use_kernels(x):
        from tpu_reid_torch.ops.fused_attention import fused_block

        dt = x.dtype
        a, m = p["attn"], p["mlp"]
        return fused_block(
            x,
            p["ln_1"]["scale"], p["ln_1"]["bias"],
            a["in_proj"]["w"].to(dt), a["in_proj"]["b"].to(dt),
            a["out_proj"]["w"].to(dt), a["out_proj"]["b"].to(dt),
            p["ln_2"]["scale"], p["ln_2"]["bias"],
            m["c_fc"]["w"].to(dt), m["c_fc"]["b"].to(dt),
            m["c_proj"]["w"].to(dt), m["c_proj"]["b"].to(dt),
            n_heads,
            mask,
            prompt_plane=prompt_plane,
            prompt_mask=prompt_mask,
            fast=A.fast_softmax_enabled(),
        )
    if prompt_plane is not None:
        x = _apply_splice_plane(x, prompt_plane, prompt_mask)
    return _block_xla_impl(p, x, n_heads, mask)


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
) -> Tensor:
    """Run a stack of residual blocks whose params have a leading layer axis.

    deep_prompts: (L, n_ctx, D) per-layer prompt tokens; prompt_flags: (L,)
    bools — layer i splices its tokens before the block iff flags[i]. The
    splice is a (S, D) plane plus an (S, 1) row mask, fused into the block
    kernels on the kernel path."""
    n_layers = num_layers(stacked)
    if deep_prompts is None:
        for i in range(n_layers):
            x = residual_block(slice_layer(stacked, i), x, n_heads, mask)
        return x

    n_ctx, dim = deep_prompts.shape[1:]
    s = x.shape[1]
    row0 = 1 if text_side else s - n_ctx
    planes = deep_prompts.new_zeros((n_layers, s, dim))
    planes[:, row0: row0 + n_ctx] = deep_prompts
    rowmask = torch.zeros(s, 1, dtype=torch.float32, device=x.device)
    rowmask[row0: row0 + n_ctx] = 1.0
    for i in range(n_layers):
        x = residual_block(
            slice_layer(stacked, i), x, n_heads, mask,
            prompt_plane=planes[i],
            prompt_mask=rowmask * float(bool(prompt_flags[i])),
        )
    return x


def causal_mask(n: int, device=None) -> Tensor:
    """CLIP's additive causal mask."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)
