"""Softmax attention core: the `mha_core` kernel, its plain version, the
softmax-profile switch and the plain core of the plain block.

`mha_core` replaces tpu_reid/ops/attention.py::mha_core (the Pallas
`_attn_kernel`): softmax attention over (B, S, H, dh) q, k and v for any
S and dh = 64, and for any S and dh = 112 in bf16 (EVA02-CLIP-E/14's
heads; csrc/block_kernels.cu::mha_core). The head width
is read from the operands' shape; `kernel_takes_heads` says which widths a
call's dtype has a kernel for. The kernel takes q, k
and v as three base pointers and one row stride, so contiguous
(B, S, H, 64) tensors and the strided views into a packed (B, S, 3D) qkv
buffer that fused_mha hands it both run without a copy. What bounds it on
the H100 is its bytes (q, k, v in, the heads out) in bf16 and its
operations in fp32: scores and probabilities stay in registers and never
reach device memory. In bf16, for S <= 256, persistent blocks walk the
(image, head) pairs: a head's Q, K and V arrive once by TMA from the strided
view (`head_row_stride` holds what a tensor map needs of it), the next head
under the work on this one, both products run on wgmma and a thread holds
whole rows of scores. A longer sequence (the vehicle geometry: 256x256 gives
442 tokens, 444 with IVLP's prompts) takes a second kernel of the same entry
point: one block per 128 query rows of a head, K and V tiles of 64 keys
streaming through a TMA ring, the softmax taken online over the tiles (a
running row maximum, the accumulator rescaled when it rises; the fast
softmax needs no maximum and just accumulates). fp32 (the training CLIs'
default) runs one such key-tile kernel for every S, both products as three
TF32 passes on wgmma (each operand split into hi = tf32(x) and
lo = tf32(x - hi); lo*hi + hi*lo + hi*hi keeps ~22 of fp32's 24 mantissa
bits).

Normalisation: the kernel multiplies the (S, dh) output by the row-sum
reciprocal, as the fused kernels' `_attention_heads` does; the Pallas
`_attn_kernel` divides. The two differ by at most an fp32 ulp before the
cast, well inside the kernel's tolerances. `mha_core_reference` mirrors
`_attn_kernel` (division) for the exact softmax, and the fused kernels'
exp2 form for fast=True, which JAX's mha_core does not have.

The fp32 block backward (ops/fused_attention.py) takes the exact core's
gradient without a score tensor in device memory: `mha_core_lse` runs the
fp32 kernel with each row's log-sum-exp as a second output, and
`mha_core_backward` (csrc/block_kernels.cu, two kernels that replace no
TPU kernel: the JAX package differentiates the plain core) recomputes the
scores tile by tile from it and writes dq, dk and dv into one packed
(B, S, 3D) gradient; `mha_core_backward_reference` is its plain version.

Beside them: `xla_mha_core`, the plain core the plain block runs (and the
recompute of the bf16 training backward), `attention_core`, which
dispatches between the kernel and it as the JAX package's does, and the
process-wide fast-softmax profile.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch

from tpu_reid_torch.ops import _build

Tensor = torch.Tensor

_FAST_SOFTMAX = False

_LOG2E = 1.4426950408889634
# fast softmax: unnormalised probabilities saturate at 2^120, so the fp32 row
# sum stays finite (below 2^128) unless 256 or more scores of one row sit at
# the clamp. A shorter row cannot get there. A longer one (444 keys at the
# vehicle geometry) would need logits above 120 / log2(e) ~ 83 on hundreds of
# its keys, which no softmax input of these towers comes near; the JAX
# package runs the same clamp at 448 padded columns, and both compute one
# function.
_FAST_CLAMP = 120.0
# the head width of every attention kernel (and the only one of the fp32, the
# key-tile and the backward kernels)
HEAD_DIM = 64
# the head widths of the bf16 whole-row kernel: 112 is EVA02-CLIP-E/14's
# (csrc/block_kernels.cu, ATT_WIDE_DH)
HEAD_DIMS = (64, 112)
# the longest sequence of the whole-row kernels (csrc/block_kernels.cu,
# ATT_WHOLE_ROW_MAX_S); a longer one runs the key-tile kernels
WHOLE_ROW_MAX_SEQ = 256


def kernel_takes_heads(dh: int, dtype: torch.dtype) -> bool:
    """Whether `mha_core` has a kernel for heads of dh in dtype, at any
    sequence length: dh 64 everywhere; dh 112 in bf16 (the whole-row kernel
    up to WHOLE_ROW_MAX_SEQ, the key-tile kernel beyond), not in fp32 (the
    3xTF32 kernels take heads of 64)."""
    if dh == HEAD_DIM:
        return True
    return dh in HEAD_DIMS and dtype == torch.bfloat16


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
      approximations of one softmax, not bit-equal to each other. fp32
      blocks recompute and differentiate the exact softmax
      (`mha_core_lse`, `mha_core_backward`), as `xla_mha_core` does for
      fp32 inputs.

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


def head_row_stride(shape, strides, address: int, itemsize: int) -> int:
    """Elements between consecutive tokens (ld) of one (B, S, H, dh) operand
    of the kernel, from its shape, strides (in elements) and base address
    alone, or ValueError. The kernel reads element (b, s, h, d) at
    base + (b*S + s)*ld + h*dh + d, through TMA tensor maps over (B, S, ld)
    with boxes of 64 columns (and q by 16-byte vectors in fp32), so it needs:
    a head width of HEAD_DIMS (the boxes, and the wgmma shapes: 64, or 112 as
    two column blocks; which dtype and length take 112 is
    `kernel_takes_heads`'); S >= 1, and B, S and H below 2^31 (the kernels'
    32-bit sizes and a tensor map's extents; a sequence longer than 256 runs
    the key-tile kernel, whose grid of ceil(S / 64) * H * B blocks at most
    must stay below 2^31 too); unit element stride and heads packed dh apart;
    ld >= H*dh; batch stride S*ld; ld a multiple of 16 bytes and a 16-byte
    aligned base (vector loads, and TMA's rule for base address and
    strides); every stride below 2^40 bytes (TMA's). No copy is made: what
    does not fit raises."""
    b, s, h, dh = shape
    if (dh not in HEAD_DIMS or s < 1 or max(b, s, h) >= 2 ** 31
            or -(-s // 64) * h * b >= 2 ** 31):
        raise ValueError(f"mha_core kernel: (B, S, H, dh) = {tuple(shape)}; needs S >= 1, "
                         f"a head width of {HEAD_DIMS} and B, S, H and ceil(S / 64) * H * B "
                         "below 2^31")
    sb, ss, sh, sd = strides
    # the stride of a dimension of size 1 says nothing
    ld = ss if s > 1 else (sb if b > 1 else h * dh)
    vec = 16 // itemsize
    ok = (sd == 1 and (h == 1 or sh == dh) and ld >= h * dh
          and (b == 1 or sb == s * ld) and ld % vec == 0 and address % 16 == 0
          and b * s * ld * itemsize < 2 ** 40)
    if not ok:
        raise ValueError(
            f"mha_core: a (B, S, H, {dh}) operand {tuple(shape)} with strides "
            f"{tuple(strides)} at address {address:#x} is not a layout the kernel reads (unit "
            "element and head strides, batch stride S*ld, 16-byte aligned base and rows)"
        )
    return ld


def _row_stride(t: Tensor) -> int:
    return head_row_stride(tuple(t.shape), tuple(t.stride()), t.data_ptr(), t.element_size())


def mha_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None, *,
             fast: bool = False) -> Tensor:
    """(B, S, H, dh) q, k, v -> (B, S, H, dh) softmax attention; `mask` an
    optional additive (S, S) mask. CUDA: csrc/block_kernels.cu::mha_core, for
    any S and dh = 64 (bf16: whole score rows for S <= 256, key tiles beyond;
    fp32: key tiles, 3xTF32) and dh = 112 in bf16 for any S
    (`kernel_takes_heads`), q, k
    and v of one dtype sharing one row stride (contiguous tensors, or views
    into one packed qkv buffer); anything else raises. CPU tensors take
    `mha_core_reference`."""
    _build.check_forward_only(q, k, v)
    if q.device.type == "cpu":
        return mha_core_reference(q, k, v, mask, fast=fast)
    return _launch_mha_core(q, k, v, mask, fast, None)


def _launch_mha_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor], fast: bool,
                     lse: Optional[Tensor]) -> Tensor:
    b, s, h, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"mha_core kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}; "
            "needs equal shapes"
        )
    if _build.DTYPE_CODES.get(q.dtype) is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mha_core kernel: q {q.dtype}, k {k.dtype}, v {v.dtype}; needs one "
                        "of float32 or bfloat16")
    ld = _row_stride(q)
    if _row_stride(k) != ld or _row_stride(v) != ld:
        raise ValueError("mha_core kernel: q, k and v must share one row stride")
    if k.device != q.device or v.device != q.device:
        raise ValueError("mha_core kernel: q, k and v must be on one device")
    if not kernel_takes_heads(dh, q.dtype):
        raise ValueError(f"mha_core kernel: heads of {dh} at S = {s} in {q.dtype}; heads of "
                         f"{HEAD_DIMS[1]} run in bf16 only")
    m = attention_mask(mask, fast)
    if m is not None:
        m = m.to(q.device).contiguous()
        if m.shape != (s, s):
            raise ValueError(f"mask {tuple(m.shape)} is not ({s}, {s})")
    out = torch.empty(b, s, h, dh, dtype=q.dtype, device=q.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.mha_core(ptr(q), ptr(k), ptr(v), ld, ptr(m), ptr(out), ptr(lse), b, s, h, dh,
                      attention_scale(dh, fast), int(fast), _build.DTYPE_CODES[q.dtype],
                      _build.stream(q))
    _build.check(lib, rc, "mha_core")
    mha_core.launches += 1
    if q.dtype != torch.float32 and s > WHOLE_ROW_MAX_SEQ:
        mha_core_long.launches += 1
    if dh != HEAD_DIM:
        mha_core_wide.launches += 1
    return out


mha_core.launches = 0
# the launches among them that ran the bf16 key-tile kernel (S > WHOLE_ROW_MAX_SEQ)
mha_core_long = SimpleNamespace(launches=0)
# the launches among them on heads wider than HEAD_DIM (EVA02-CLIP-E/14's 112)
mha_core_wide = SimpleNamespace(launches=0)


# ---------------------------------------------------------------------------
# the exact fp32 core's gradient: mha_core_backward and its plain version
# ---------------------------------------------------------------------------


def mha_core_lse(q: Tensor, k: Tensor, v: Tensor,
                 mask: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """The exact `mha_core`, (B, S, H, dh) out, and each row's log-sum-exp
    of its scaled, masked fp32 scores, L (B, H, S) with P = exp(s - L), what
    `mha_core_backward` reads. CUDA: the fp32 kernel with its optional
    output (float32 only; counted in `mha_core.launches`); CPU tensors take
    the plain versions."""
    _build.check_forward_only(q, k, v)
    if q.device.type == "cpu":
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * attention_scale(
            q.shape[-1], False)
        m = attention_mask(mask, False)
        lse = torch.logsumexp(s if m is None else s + m, dim=-1)
        return mha_core_reference(q, k, v, mask), lse
    if q.dtype != torch.float32:
        raise TypeError(f"mha_core_lse kernel: {q.dtype}; the log-sum-exp is the fp32 "
                        "kernel's output")
    b, s, h, _ = q.shape
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    return _launch_mha_core(q, k, v, mask, False, lse), lse


def mha_core_backward_reference(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
                                lse: Tensor, mask: Optional[Tensor] = None
                                ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of `mha_core_backward`: (B, S, H, dh) q, k, v, the
    output o, its gradient do, and the rows' log-sum-exp (B, H, S) ->
    dq, dk, dv (B, S, H, dh), fp32. P = exp(scale q k^T + mask - L),
    dv = P^T do, dS = P (do v^T - rowsum(do o)), dq = scale dS k,
    dk = scale dS^T q."""
    scale = attention_scale(q.shape[-1], False)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    m = attention_mask(mask, False)
    if m is not None:
        s = s + m
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf), torch.einsum("bhqk,bqhd->bkhd", ds, qf),
            dv)


def mha_core_backward(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, lse: Tensor,
                      mask: Optional[Tensor] = None) -> Tensor:
    """The gradient of the exact softmax attention `mha_core_lse` computed
    (o, lse) for q, k and v, as one (B, S, 3 * H * dh) tensor [dq | dk | dv]:
    the layout of a packed qkv's gradient. CUDA:
    csrc/block_kernels.cu::mha_core_backward (a dQ pass, then a dK / dV pass,
    3xTF32 on wgmma, the scores recomputed tile by tile from lse; equal bits
    run to run), float32 only: q, k and v in `mha_core`'s domain (head width
    64, one row stride), o and do (B, S, H, 64) sharing one row stride;
    anything else raises. CPU tensors take `mha_core_backward_reference`."""
    _build.check_forward_only(q, k, v, o, do, lse)
    b, s, h, dh = q.shape
    if q.device.type == "cpu":
        grads = mha_core_backward_reference(q, k, v, o, do, lse, mask)
        return torch.cat([t.reshape(b, s, h * dh) for t in grads], dim=-1)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"mha_core_backward kernel: {name} {t.dtype} on {t.device}")
    if k.shape != q.shape or v.shape != q.shape or dh != HEAD_DIM:
        raise ValueError(f"mha_core_backward kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; needs equal shapes and heads of {HEAD_DIM}")
    ld = _row_stride(q)
    if _row_stride(k) != ld or _row_stride(v) != ld:
        raise ValueError("mha_core_backward kernel: q, k and v must share one row stride")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"mha_core_backward kernel: o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    _build.require_cuda(torch.float32, q.device, lse=lse)
    ld_o = _row_stride(o)
    if _row_stride(do) != ld_o:
        raise ValueError("mha_core_backward kernel: o and do must share one row stride")
    m = attention_mask(mask, False)
    if m is not None:
        m = m.to(q.device).contiguous()
        if m.shape != (s, s):
            raise ValueError(f"mask {tuple(m.shape)} is not ({s}, {s})")
    d = h * dh
    out = torch.empty(b, s, 3 * d, dtype=torch.float32, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    lib = _build.library("block")
    ptr = _build.ptr
    rc = lib.mha_core_backward(ptr(q), ptr(k), ptr(v), ld, ptr(o), ptr(do), ld_o,
                               ptr(lse), ptr(m), ptr(delta), ptr(out[..., :d]),
                               ptr(out[..., d:2 * d]), ptr(out[..., 2 * d:]), 3 * d, b, s, h,
                               attention_scale(HEAD_DIM, False), _build.stream(q))
    _build.check(lib, rc, "mha_core_backward")
    mha_core_backward.launches += 1
    return out


mha_core_backward.launches = 0


def attention_core(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Dispatch, as the JAX package's: the `mha_core` kernel where
    `_build.kernel_impl` selects kernels (CUDA tensors under "auto"), the
    plain `xla_mha_core` elsewhere."""
    if _build.use_kernels(q):
        return mha_core(q, k, v, mask)
    return xla_mha_core(q, k, v, mask)
