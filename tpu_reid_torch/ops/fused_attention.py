"""One pre-norm CLIP block as three hand-written CUDA kernels.

Replaces tpu_reid/ops/fused_attention.py::fused_block (the Pallas
`_whole_block_kernel` with its attention core `_attention_heads`). That kernel
keeps all of a block's weights resident in a TPU core's VMEM; they do not fit
an SM's shared memory, so the block runs as five launches
(csrc/block_kernels.cu):

    qkv = ln_gemm(x, ln_1, W_in, b_in)                 (deep-prompt splice on load)
    a   = attention(qkv)                               (exact or fast softmax)
    x1  = gemm_bias_residual(a, W_out, b_out, x)       (same splice on the residual)
    h   = ln_gemm(x1, ln_2, W_fc, b_fc, gelu=True)
    out = gemm_bias_residual(h, W_proj, b_proj, x1)

Each kernel has a wrapper that launches it for CUDA tensors (or raises) and
takes the plain PyTorch version beside it for CPU tensors; the plain versions
repeat the kernels' arithmetic and bf16 rounding points. Each wrapper counts
its launches in its `launches` attribute. The kernels are forward-only: an
input that requires grad raises.

Layouts follow the JAX package: activations (B, S, D), linear weights
(in, out). Weights and biases come in the activations' dtype (float32 or
bfloat16); LayerNorm parameters are used in fp32 (the plain block's choice;
the Pallas kernel rounds them to the working type first).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_reid_torch.ops import _build

_LOG2E = 1.4426950408889634
# fast softmax: unnormalised probabilities saturate at 2^120, so a row of at
# most 256 of them sums below 2^128 (fp32 max): sound only for S <= 256
_FAST_CLAMP = 120.0
MAX_SEQ = 256
HEAD_DIM = 64
LN_MAX_WIDTH = 1024  # ln_gemm keeps LayerNorm's gamma/beta and a row in fast memory

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _check_forward_only(*tensors: Optional[Tensor]) -> None:
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "the block and tail kernels are forward-only: call them under "
            "torch.no_grad() (training recomputes through the plain block)"
        )


def _splice(x: Tensor, plane: Optional[Tensor], pmask: Optional[Tensor]) -> Tensor:
    """Rows s of every sequence where pmask[s] > 0 come from plane[s]."""
    if plane is None:
        return x
    keep = pmask.reshape(1, -1, 1) > 0
    return torch.where(keep, plane.to(x.dtype)[None], x)


def _layer_norm_f32(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """fp32 statistics and fp32 affine, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _splice_args(plane: Optional[Tensor], pmask: Optional[Tensor], s: int, width: int,
                 dtype: torch.dtype):
    """Kernel operands of the deep-prompt splice: plane (S, width) in the
    working type, pmask (S,) fp32 — or (None, None)."""
    if plane is None:
        return None, None
    plane = plane.to(dtype).contiguous()
    pmask = pmask.reshape(-1).float().contiguous()
    if plane.shape != (s, width) or pmask.shape != (s,):
        raise ValueError(
            f"splice plane {tuple(plane.shape)} / mask {tuple(pmask.shape)} do "
            f"not match a sequence of {s} rows of width {width}"
        )
    return plane, pmask


# ---------------------------------------------------------------------------
# kernel 1: LayerNorm prologue + GEMM + bias (+ QuickGELU)
# ---------------------------------------------------------------------------


def ln_gemm_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w: Tensor,
                      b: Tensor, gelu: bool = False, plane: Optional[Tensor] = None,
                      pmask: Optional[Tensor] = None) -> Tensor:
    """act(LN(splice(x)) @ w + b): LN output cast to x.dtype, fp32 product,
    bias and QuickGELU in fp32, then the cast."""
    h = _layer_norm_f32(_splice(x, plane, pmask), ln_scale, ln_bias)
    acc = h.float() @ w.float() + b.float()
    if gelu:
        acc = acc * torch.sigmoid(1.702 * acc)
    return acc.to(x.dtype)


def ln_gemm(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w: Tensor, b: Tensor,
            gelu: bool = False, plane: Optional[Tensor] = None,
            pmask: Optional[Tensor] = None) -> Tensor:
    """(B, S, K) -> (B, S, N). CUDA: csrc/block_kernels.cu::ln_gemm."""
    _check_forward_only(x, ln_scale, ln_bias, w, b, plane)
    if x.device.type == "cpu":
        return ln_gemm_reference(x, ln_scale, ln_bias, w, b, gelu, plane, pmask)
    bsz, s, k = x.shape
    n = w.shape[1]
    if w.shape != (k, n) or b.shape != (n,) or k % 32 or n % 8 or k > LN_MAX_WIDTH:
        raise ValueError(f"ln_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}; needs K % 32 == 0, K <= {LN_MAX_WIDTH} "
                         "and N % 8 == 0")
    plane, pmask = _splice_args(plane, pmask, s, k, x.dtype)
    g = ln_scale.float().contiguous()
    gb = ln_bias.float().contiguous()
    _build.require_cuda(x.dtype, x.device, x=x, w=w, b=b, plane=plane)
    out = torch.empty(bsz, s, n, dtype=x.dtype, device=x.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.ln_gemm(ptr(x), ptr(plane), ptr(pmask), ptr(g), ptr(gb), ptr(w), ptr(b),
                     ptr(out), bsz * s, n, k, s, int(gelu), _build.DTYPE_CODES[x.dtype],
                     _build.stream(x))
    _build.check(lib, rc, "ln_gemm")
    ln_gemm.launches += 1
    return out


ln_gemm.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: full-row softmax attention (S <= 256, dh = 64)
# ---------------------------------------------------------------------------


def _attention_mask(mask: Optional[Tensor], fast: bool) -> Optional[Tensor]:
    """Additive (S, S) mask as the kernel reads it: -inf clamped to -1e30,
    pre-scaled by log2(e) for the fast softmax."""
    if mask is None:
        return None
    m = mask.float().clamp_min(-1e30)
    return m * _LOG2E if fast else m


def _attention_scale(dh: int, fast: bool) -> float:
    scale = 1.0 / math.sqrt(dh)
    return scale * _LOG2E if fast else scale


def attention_reference(qkv: Tensor, n_heads: int, mask: Optional[Tensor] = None,
                        fast: bool = False) -> Tensor:
    """(B, S, 3D) qkv -> (B, S, D) per-head softmax attention, normalised late
    by the row reciprocal. exact: max-subtracted exp; fast:
    exp2(min(s + mask, 120)) in log2e units, denominator floored at 1e-30."""
    bsz, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    q, k, v = (t.reshape(bsz, s, n_heads, dh).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    scores = (q.float() @ k.float().transpose(-1, -2)) * _attention_scale(dh, fast)
    m = _attention_mask(mask, fast)
    if m is not None:
        scores = scores + m
    if fast:
        p = torch.exp2(scores.clamp_max(_FAST_CLAMP))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
    o = (p.to(qkv.dtype).float() @ v.float()) * (1.0 / denom)
    return o.to(qkv.dtype).transpose(1, 2).reshape(bsz, s, d)


def attention(qkv: Tensor, n_heads: int, mask: Optional[Tensor] = None,
              fast: bool = False) -> Tensor:
    """(B, S, 3D) -> (B, S, D). CUDA: csrc/block_kernels.cu::attention."""
    _check_forward_only(qkv)
    if qkv.device.type == "cpu":
        return attention_reference(qkv, n_heads, mask, fast)
    bsz, s, d3 = qkv.shape
    d = d3 // 3
    if s > MAX_SEQ or d3 != 3 * d or d != n_heads * HEAD_DIM:
        raise ValueError(
            f"attention kernel: S={s} must be <= {MAX_SEQ} and the head width "
            f"{d3 // 3 // n_heads} must be {HEAD_DIM}"
        )
    m = _attention_mask(mask, fast)
    if m is not None:
        m = m.to(qkv.device).contiguous()
        if m.shape != (s, s):
            raise ValueError(f"mask {tuple(m.shape)} is not ({s}, {s})")
    _build.require_cuda(qkv.dtype, qkv.device, qkv=qkv)
    out = torch.empty(bsz, s, d, dtype=qkv.dtype, device=qkv.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.attention(ptr(qkv), ptr(m), ptr(out), bsz, s, n_heads,
                       _attention_scale(HEAD_DIM, fast), int(fast),
                       _build.DTYPE_CODES[qkv.dtype], _build.stream(qkv))
    _build.check(lib, rc, "attention")
    attention.launches += 1
    return out


attention.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: GEMM + bias + residual
# ---------------------------------------------------------------------------


def gemm_bias_residual_reference(a: Tensor, w: Tensor, b: Tensor, residual: Tensor,
                                 plane: Optional[Tensor] = None,
                                 pmask: Optional[Tensor] = None) -> Tensor:
    """a @ w + b + splice(residual) in fp32, then the cast."""
    acc = a.float() @ w.float() + b.float() + _splice(residual, plane, pmask).float()
    return acc.to(a.dtype)


def gemm_bias_residual(a: Tensor, w: Tensor, b: Tensor, residual: Tensor,
                       plane: Optional[Tensor] = None,
                       pmask: Optional[Tensor] = None) -> Tensor:
    """(B, S, K) -> (B, S, N). CUDA: csrc/block_kernels.cu::gemm_bias_residual."""
    _check_forward_only(a, w, b, residual, plane)
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, residual, plane, pmask)
    bsz, s, k = a.shape
    n = w.shape[1]
    if (w.shape != (k, n) or b.shape != (n,) or residual.shape != (bsz, s, n)
            or k % 32 or n % 8):
        raise ValueError(
            f"gemm_bias_residual: a {tuple(a.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)}, residual {tuple(residual.shape)}; needs "
            "K % 32 == 0 and N % 8 == 0"
        )
    plane, pmask = _splice_args(plane, pmask, s, n, a.dtype)
    _build.require_cuda(a.dtype, a.device, a=a, w=w, b=b, residual=residual, plane=plane)
    out = torch.empty(bsz, s, n, dtype=a.dtype, device=a.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.gemm_bias_residual(ptr(a), ptr(w), ptr(b), ptr(residual), ptr(plane),
                                ptr(pmask), ptr(out), bsz * s, n, k, s,
                                _build.DTYPE_CODES[a.dtype], _build.stream(a))
    _build.check(lib, rc, "gemm_bias_residual")
    gemm_bias_residual.launches += 1
    return out


gemm_bias_residual.launches = 0


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------


def _block(x, ln1_scale, ln1_bias, w_in, b_in, w_out, b_out, ln2_scale, ln2_bias,
           w_fc, b_fc, w_proj, b_proj, n_heads, mask, plane, pmask, fast, kernels):
    ln_gemm_fn, attention_fn, gemm_res_fn = kernels
    qkv = ln_gemm_fn(x, ln1_scale, ln1_bias, w_in, b_in, False, plane, pmask)
    a = attention_fn(qkv, n_heads, mask, fast)
    x1 = gemm_res_fn(a, w_out, b_out, x, plane, pmask)
    h = ln_gemm_fn(x1, ln2_scale, ln2_bias, w_fc, b_fc, True)
    return gemm_res_fn(h, w_proj, b_proj, x1)


def fused_block_reference(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """Plain PyTorch version of `fused_block`, rounding where the kernels do."""
    return _block(x, ln1_scale, ln1_bias, w_in, b_in, w_out, b_out, ln2_scale,
                  ln2_bias, w_fc, b_fc, w_proj, b_proj, n_heads, mask,
                  prompt_plane, prompt_mask, fast,
                  (ln_gemm_reference, attention_reference,
                   gemm_bias_residual_reference))


def fused_block(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """One pre-norm transformer block, (B, S, D) -> (B, S, D).

    prompt_plane (S, D) / prompt_mask (S, 1) or (S,): optional deep-prompt
    splice — rows where prompt_mask > 0 are replaced by the plane BEFORE the
    block, and the spliced rows are also the out-proj residual. CUDA tensors
    go through the three kernels, CPU tensors through their plain versions."""
    return _block(x, ln1_scale, ln1_bias, w_in, b_in, w_out, b_out, ln2_scale,
                  ln2_bias, w_fc, b_fc, w_proj, b_proj, n_heads, mask,
                  prompt_plane, prompt_mask, fast,
                  (ln_gemm, attention, gemm_bias_residual))
