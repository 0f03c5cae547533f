"""Softmax attention core: the `mha_core` kernel, its plain version, the
softmax-profile switch and the plain core of the plain block.

`mha_core` replaces tpu_reid/ops/attention.py::mha_core (the Pallas
`_attn_kernel`): softmax attention over (B, S, H, dh) q, k and v for
S <= 256 and dh = 64 (csrc/block_kernels.cu::mha_core). The kernel takes q, k
and v as three base pointers and one row stride, so contiguous
(B, S, H, 64) tensors and the strided views into a packed (B, S, 3D) qkv
buffer that fused_mha hands it both run without a copy. What bounds it on
the H100 is its bytes (q, k, v in, the heads out): scores and probabilities
stay in registers (bf16) or shared memory (fp32) and never reach device
memory.

Normalisation: the kernel multiplies the (S, dh) output by the row-sum
reciprocal, as the fused kernels' `_attention_heads` does; the Pallas
`_attn_kernel` divides. The two differ by at most an fp32 ulp before the
cast, well inside the kernel's tolerances. `mha_core_reference` mirrors
`_attn_kernel` (division) for the exact softmax, and the fused kernels'
exp2 form for fast=True, which JAX's mha_core does not have.

Beside it: `xla_mha_core`, the plain core the plain block runs (and the
recompute of every training backward), `attention_core`, which dispatches
between the two as the JAX package's does, and the process-wide
fast-softmax profile.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_reid_torch.ops import _build

Tensor = torch.Tensor

_FAST_SOFTMAX = False

_LOG2E = 1.4426950408889634
# fast softmax: unnormalised probabilities saturate at 2^120, so a row of at
# most 256 of them sums below 2^128 (fp32 max): sound only for S <= 256
_FAST_CLAMP = 120.0
MAX_SEQ = 256
HEAD_DIM = 64


def set_fast_softmax(enabled: bool) -> None:
    """Throughput profile for the attention softmax. Per path:

    * plain core (`xla_mha_core`, bf16 inputs only): probabilities cast to
      bf16 after a standard fp32 max-subtracted exp; the normalising sum
      stays fp32.
    * kernels (`mha_core` and the blocks with fast=True): exp2 with a
      saturating clamp replaces the max-reduce and subtract (masks are baked
      pre-scaled by log2(e)); probabilities are cast to the working type for
      the p@v product, as on the exact path.
    * training: the blocks' autograd Function runs the kernels' exp2 form
      forward and recomputes the backward through `xla_mha_core`'s
      bf16-probability form, as the JAX package's custom VJP does — two
      approximations of one softmax, not bit-equal to each other.

    Parity-sensitive evals leave this off (default)."""
    global _FAST_SOFTMAX
    _FAST_SOFTMAX = enabled


def fast_softmax_enabled() -> bool:
    """Read of the fast-softmax profile flag (the block kernels switch to the
    exp2/saturating-clamp softmax when set)."""
    return _FAST_SOFTMAX


def xla_mha_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Plain attention core over (B, S, H, dh) q, k, v -> (B, S, H, dh).

    Scores in fp32; softmax in fp32 and the probabilities cast to the input
    dtype before p@v (the name keeps the JAX counterpart's)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    if _FAST_SOFTMAX and q.dtype == torch.bfloat16:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m).to(torch.bfloat16)
        p = e / e.float().sum(dim=-1, keepdim=True).to(torch.bfloat16)
    else:
        p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# the mha_core kernel and its plain version
# ---------------------------------------------------------------------------


def attention_mask(mask: Optional[Tensor], fast: bool) -> Optional[Tensor]:
    """Additive (S, S) mask as the kernel reads it: -inf clamped to -1e30,
    pre-scaled by log2(e) for the fast softmax."""
    if mask is None:
        return None
    m = mask.float().clamp_min(-1e30)
    return m * _LOG2E if fast else m


def attention_scale(dh: int, fast: bool) -> float:
    scale = 1.0 / math.sqrt(dh)
    return scale * _LOG2E if fast else scale


def softmax_attention(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor], fast: bool,
                      divide: bool) -> Tensor:
    """(B, S, H, dh) q, k, v -> (B, S, H, dh) in q's dtype, rounding where
    the kernels do: fp32 scores, exact (max-subtracted exp) or fast
    (exp2(min(s + mask, 120)) in log2e units, denominator
    floored at 1e-30), probabilities cast to v's type, fp32 p@v normalised
    by the row sum (divide) or its reciprocal."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * attention_scale(dh, fast)
    m = attention_mask(mask, fast)
    if m is not None:
        scores = scores + m
    if fast:
        p = torch.exp2(scores.clamp_max(_FAST_CLAMP))
        denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    else:
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ v.float().transpose(1, 2)  # (B, H, S, dh)
    o = o / denom if divide else o * (1.0 / denom)
    return o.to(q.dtype).transpose(1, 2)


def mha_core_reference(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None, *,
                       fast: bool = False) -> Tensor:
    """Plain version of `mha_core`: the exact softmax divides by the row sum
    as the Pallas `_attn_kernel` does; fast=True is the fused kernels' exp2
    form (reciprocal)."""
    return softmax_attention(q, k, v, mask, fast, divide=not fast)


def _row_stride(t: Tensor, s: int, h: int) -> int:
    """Elements between consecutive tokens of a (B, S, H, 64) view, checked
    to be a layout the kernel reads (heads packed, batch stride S*ld,
    16-byte aligned vectors); raises otherwise (no copy)."""
    b = t.shape[0]
    ld = t.stride(1)
    vec = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.stride(2) == HEAD_DIM and ld >= h * HEAD_DIM
          and (b == 1 or t.stride(0) == s * ld) and ld % vec == 0
          and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"mha_core: a (B, S, H, 64) operand with strides {tuple(t.stride())} is not a "
            "layout the kernel reads (unit element and head strides, batch stride S*ld, "
            "16-byte aligned rows)"
        )
    return ld


def mha_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None, *,
             fast: bool = False) -> Tensor:
    """(B, S, H, dh) q, k, v -> (B, S, H, dh) softmax attention; `mask` an
    optional additive (S, S) mask. CUDA: csrc/block_kernels.cu::mha_core, for
    S <= 256 and dh = 64, q, k and v of one dtype sharing one row stride
    (contiguous tensors, or views into one packed qkv buffer); anything else
    raises. CPU tensors take `mha_core_reference`."""
    _build.check_forward_only(q, k, v)
    if q.device.type == "cpu":
        return mha_core_reference(q, k, v, mask, fast=fast)
    b, s, h, dh = q.shape
    if s > MAX_SEQ or dh != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"mha_core kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}; "
            f"needs equal shapes with S <= {MAX_SEQ} and head width {HEAD_DIM}"
        )
    if _build.DTYPE_CODES.get(q.dtype) is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mha_core kernel: q {q.dtype}, k {k.dtype}, v {v.dtype}; needs one "
                        "of float32 or bfloat16")
    ld = _row_stride(q, s, h)
    if _row_stride(k, s, h) != ld or _row_stride(v, s, h) != ld:
        raise ValueError("mha_core kernel: q, k and v must share one row stride")
    if k.device != q.device or v.device != q.device:
        raise ValueError("mha_core kernel: q, k and v must be on one device")
    m = attention_mask(mask, fast)
    if m is not None:
        m = m.to(q.device).contiguous()
        if m.shape != (s, s):
            raise ValueError(f"mask {tuple(m.shape)} is not ({s}, {s})")
    out = torch.empty(b, s, h, dh, dtype=q.dtype, device=q.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.mha_core(ptr(q), ptr(k), ptr(v), ld, ptr(m), ptr(out), b, s, h,
                      attention_scale(HEAD_DIM, fast), int(fast), _build.DTYPE_CODES[q.dtype],
                      _build.stream(q))
    _build.check(lib, rc, "mha_core")
    mha_core.launches += 1
    return out


mha_core.launches = 0


def attention_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Dispatch, as the JAX package's: the `mha_core` kernel where
    `layers.kernel_impl` selects kernels (CUDA tensors under "auto"), the
    plain `xla_mha_core` elsewhere."""
    from tpu_reid_torch.models.layers import use_kernels

    if use_kernels(q):
        return mha_core(q, k, v, mask)
    return xla_mha_core(q, k, v, mask)
