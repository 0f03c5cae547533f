"""Pre-norm CLIP blocks and half-blocks as hand-written CUDA kernels.

Replaces three Pallas kernels of tpu_reid/ops/fused_attention.py:

  * `fused_mha` (`_kernel`): [LN ->] qkv projection -> softmax attention ->
    out-projection [+ residual],
  * `fused_mlp` (`_mlp_kernel`): x + c_proj(QuickGELU(c_fc(LN(x)))),
  * `fused_block` (`_whole_block_kernel`, attention core `_attention_heads`):
    fused_mlp(fused_mha(x)) with the optional deep-prompt splice.

The TPU kernels keep the weights resident in a core's VMEM; they do not fit
an SM's shared memory, so each is a few launches of three kernels
(csrc/block_kernels.cu):

    qkv = ln_gemm(x, ln_1, W_in, b_in)               (deep-prompt splice on load)
    a   = mha_core(q, k, v)                           (strided views of qkv, no copy)
    x1  = gemm_bias_residual(a, W_out, b_out, x)      (same splice on the residual)
    h   = ln_gemm(x1, ln_2, W_fc, b_fc, gelu=True)
    out = gemm_bias_residual(h, W_proj, b_proj, x1)

The first three lines are fused_mha with pre-LN, the last two fused_mlp, all
five fused_block. fused_mha without LN reads the rows as they are and adds
no residual, as the Pallas kernel with pre_ln=False does.

What bounds them on the H100: their GEMMs, 2·B·S·D·(4D + 2S) operations for
fused_mha and 4·B·S·D·hid for fused_mlp against the tensor-core rate; the
attention alone is bound by its bytes. The design gives up the TPU kernels'
one pass over fast memory: qkv, the head output, x1 and the MLP hidden
activation round-trip device memory between launches. What it does about the
bound, in bf16 (csrc/block_kernels.cu, csrc/hopper.cuh): one GEMM kernel
behind `ln_gemm` and `gemm_bias_residual` runs wgmma on 128-byte-swizzled
shared tiles that TMA fills through a ring of mbarrier-guarded stages (one
producer thread, two consumer warpgroups, persistent blocks); with LayerNorm
a block normalises a panel of 128 rows once (fp32 statistics and affine),
keeps it in shared memory in the layout wgmma reads and walks N tiles while
only W streams in, the two warpgroups on alternate tiles so that epilogues
hide under mainloops; `mha_core` stages whole heads by TMA, double-buffered,
and runs both products on wgmma with the score rows in registers. The
wrappers hold the kernels' domain in plain functions of sizes, strides and
addresses (`check_gemm_operands`, `attention.head_row_stride`): TMA needs
16-byte aligned bases and rows. fp32 (the training CLIs' default dtype) runs
the same three entry points on kernels of its own, 3xTF32 on wgmma: each
operand split once into hi = tf32(x) and lo = tf32(x - hi), and every k8
step adds lo*hi, hi*lo, then hi*hi into one fp32 accumulator, which keeps
~22 of fp32's 24 mantissa bits at a third of the TF32 tensor-core rate
(tests/test_torch_tf32x3.py holds the arithmetic on the CPU). The GEMM's
splitter warpgroup writes each W tile transposed and split (tf32 wgmma reads
both shared operands K-major only), its consumers take A from registers,
normalised and split there. PERF.md holds the measured times.

EVA02's block (ops/fused_eva.py) runs the same kernels in modes of its own
(RoPE and SwiGLU epilogues, an LN prologue with the residual epilogue) and
`ln_rows`, a LayerNorm pass over rows.

Each kernel has a wrapper that launches it for CUDA tensors (or raises) and
takes the plain PyTorch version beside it for CPU tensors; the plain versions
repeat the kernels' arithmetic and bf16 rounding points. Each wrapper, and
each of fused_mha / fused_mlp / fused_block, counts the calls in which it
launched kernels in its `launches` attribute. The wrappers are forward-only:
an input that requires grad raises. The model's blocks (serving and
training) go through `fused_block_autograd`, the counterpart of the JAX package's custom VJPs
(`_block_fused`, `_block_fused_spliced`): the forward runs the kernels; the
backward recomputes the block, as JAX's does, and in fp32 writes the
gradient chain out on the same GEMM kernel (`gemm_product`, `gemm_dgrad`,
`gemm_wgrad`: the recompute's three products and the eight gradient
products, 3xTF32 on wgmma), in bf16 differentiates the plain block under
autograd (`fused_block_backward`).

Layouts follow the JAX package: activations (B, S, D), linear weights
(in, out). Weights and biases come in the activations' dtype (float32 or
bfloat16); LayerNorm parameters are used in fp32 (the plain block's choice;
the Pallas kernels round them to the working type first).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_reid_torch.ops import _build
from tpu_reid_torch.ops.attention import HEAD_DIM, mha_core, softmax_attention, xla_mha_core

LN_MAX_WIDTH = 1024  # ln_gemm keeps LayerNorm's gamma/beta and a row in fast memory

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared helpers: the plain math of the blocks (CLIP's conventions: LayerNorm
# statistics in fp32 even under bf16 activations, QuickGELU), over parameter
# dicts with the JAX package's layouts (linear weights (in, out))
# ---------------------------------------------------------------------------


def splice_plane(x: Tensor, plane: Optional[Tensor], pmask: Optional[Tensor]) -> Tensor:
    """The out-of-kernel deep-prompt splice: rows s of every sequence where
    pmask[s] > 0 come from plane[s]; plane None: x as it is."""
    if plane is None:
        return x
    keep = pmask.reshape(1, -1, 1) > 0
    return torch.where(keep, plane.to(x.dtype)[None], x)


def layer_norm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm with fp32 statistics and fp32 affine (p: scale, bias),
    output cast back to the input dtype."""
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


def _qkv_views(qkv: Tensor, n_heads: int) -> tuple[Tensor, Tensor, Tensor]:
    """(B, S, 3D) -> q, k, v as (B, S, H, dh) views (row stride 3D)."""
    d = qkv.shape[-1] // 3
    return tuple(qkv[..., i * d:(i + 1) * d].unflatten(-1, (n_heads, d // n_heads))
                 for i in range(3))


# operands the fp32 GEMM kernel reads element by element (the LayerNorm
# parameters into shared memory, the rest in its epilogue): any address will do
FP32_SCALAR_OPERANDS = frozenset({"b", "pmask", "ln_scale", "ln_bias", "residual"})


# the EVA02 block's modes of the bf16 GEMM kernel (csrc/block_kernels.cu):
# "rope" (ln_gemm without LN, on rows `ln_rows` normalised, with the rotary
# embedding on q and k), "swiglu" (the same, writing SiLU(gate) * up of a
# packed gate | up weight) and "ln_residual" (gemm_bias_residual with a
# LayerNorm prologue: the attention output's sub-LN)
EVA_MODES = ("rope", "swiglu", "ln_residual")


def check_gemm_operands(what: str, m: int, k: int, n: int, has_ln: bool,
                        addresses: dict, fp32: bool = False, mode: Optional[str] = None) -> None:
    """What the GEMM kernel behind `ln_gemm` and `gemm_bias_residual` takes,
    from sizes and base addresses alone (ValueError otherwise): K a multiple
    of 32 (a W stage of the LayerNorm mode; also keeps every row of A and W a
    multiple of 16 bytes, which TMA and the 16-byte loads need), N a multiple
    of 8 (16-byte rows of W, the bias, the residual and the output), with
    LayerNorm K <= LN_MAX_WIDTH (the row panel a block keeps in shared
    memory), sizes within a tensor map's 32-bit extents, and every operand's
    base (`addresses`: name -> address or None) 16-byte aligned. `fp32`: the
    fp32 kernel reads only the activation and W by TMA and the LayerNorm
    plane by 16-byte vectors, so the bases in FP32_SCALAR_OPERANDS are free
    there. M is free: the ragged last row tile is zero-filled on load and
    masked on store. `mode`, one of EVA_MODES: bf16 only; "ln_residual" with
    the LayerNorm prologue, "rope" and "swiglu" without it, and "swiglu" with
    N a multiple of 128 (each 128-column tile is 64 gate columns and their
    64 up columns)."""
    if mode is not None:
        if mode not in EVA_MODES:
            raise ValueError(f"{what}: mode {mode!r} is not one of {EVA_MODES}")
        if fp32 or has_ln != (mode == "ln_residual"):
            raise ValueError(f"{what}: the {mode} mode runs in bf16, "
                             f"{'with' if mode == 'ln_residual' else 'without'} the LayerNorm "
                             "prologue")
        if mode == "swiglu" and n % 128:
            raise ValueError(f"{what}: N = {n}; the swiglu mode needs N % 128 == 0")
    if k <= 0 or n <= 0 or k % 32 or n % 8:
        raise ValueError(f"{what}: K = {k}, N = {n}; needs K % 32 == 0 and N % 8 == 0")
    if has_ln and k > LN_MAX_WIDTH:
        raise ValueError(f"{what}: K = {k}; with LayerNorm the kernel takes K <= {LN_MAX_WIDTH}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"{what}: M, K, N = {m}, {k}, {n} exceed a tensor map's extents")
    for name, address in addresses.items():
        if fp32 and name in FP32_SCALAR_OPERANDS:
            continue
        if address is not None and address % 16:
            raise ValueError(f"{what}: {name} at address {address:#x} is not 16-byte aligned")


# ---------------------------------------------------------------------------
# kernel 1: [LayerNorm prologue +] GEMM + bias (+ QuickGELU)
# ---------------------------------------------------------------------------


def rotate_pairs(t: Tensor, rope: Tensor) -> Tensor:
    """The rotary embedding of (..., S, H, 64) by a (S, 2, 64) cos / sin
    table (each pair's angle twice): interleaved pairs (2p, 2p + 1) turn,
    y0 = x0 cos - x1 sin, y1 = x1 cos + x0 sin, in fp32, cast back."""
    cos, sin = rope[:, 0, None, :].float(), rope[:, 1, None, :].float()
    x = t.float()
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return (x * cos + turned * sin).to(t.dtype)


def _swiglu_packed(acc: Tensor) -> Tensor:
    """SiLU(gate) * up of a packed (..., 2F) product whose 128-column groups
    are 64 gate columns, then their 64 up columns -> (..., F)."""
    gu = acc.unflatten(-1, (-1, 2, 64))
    return (torch.nn.functional.silu(gu[..., 0, :]) * gu[..., 1, :]).flatten(-2)


def ln_gemm_reference(x: Tensor, ln_scale: Optional[Tensor], ln_bias: Optional[Tensor],
                      w: Tensor, b: Tensor, gelu: bool = False,
                      plane: Optional[Tensor] = None,
                      pmask: Optional[Tensor] = None, *, swiglu: bool = False,
                      rope: Optional[Tensor] = None, rope_cols: int = 0,
                      eps: float = 1e-5) -> Tensor:
    """act(LN(splice(x)) @ w + b): LN output cast to x.dtype, fp32 product,
    bias and QuickGELU (or SwiGLU of the packed gate | up, or the rotary
    embedding of the columns below rope_cols) in fp32, then the cast.
    ln_scale None: no LN (and no splice), the rows as they are."""
    if ln_scale is None:
        if plane is not None:
            raise ValueError("ln_gemm: the deep-prompt splice needs the LayerNorm prologue")
        h = x
    else:
        h = layer_norm({"scale": ln_scale, "bias": ln_bias}, splice_plane(x, plane, pmask), eps)
    acc = h.float() @ w.float() + b.float()
    if gelu:
        acc = quick_gelu(acc)
    if swiglu:
        acc = _swiglu_packed(acc)
    if rope is not None and rope_cols:
        head = acc[..., :rope_cols].unflatten(-1, (-1, 64))
        acc = torch.cat([rotate_pairs(head, rope).flatten(-2), acc[..., rope_cols:]], dim=-1)
    return acc.to(x.dtype)


def ln_gemm(x: Tensor, ln_scale: Optional[Tensor], ln_bias: Optional[Tensor], w: Tensor,
            b: Tensor, gelu: bool = False, plane: Optional[Tensor] = None,
            pmask: Optional[Tensor] = None, *, swiglu: bool = False,
            rope: Optional[Tensor] = None, rope_cols: int = 0, eps: float = 1e-5) -> Tensor:
    """(B, S, K) -> (B, S, N), or (B, S, N / 2) with swiglu. CUDA:
    csrc/block_kernels.cu::ln_gemm (with ln_scale None: the same kernel
    without its LayerNorm prologue). EVA02's modes, bf16 without LayerNorm
    (on rows `ln_rows` normalised): swiglu (w and b packed gate | up by
    64-column groups) and rope (a (S, 2, 64) fp32 cos / sin table, applied to
    the columns below rope_cols, a multiple of 64). eps: the LayerNorm's
    epsilon."""
    _build.check_forward_only(x, ln_scale, ln_bias, w, b, plane)
    if x.device.type == "cpu":
        return ln_gemm_reference(x, ln_scale, ln_bias, w, b, gelu, plane, pmask, swiglu=swiglu,
                                 rope=rope, rope_cols=rope_cols, eps=eps)
    bsz, s, k = x.shape
    n = w.shape[1]
    has_ln = ln_scale is not None
    mode = "swiglu" if swiglu else "rope" if rope is not None else None
    if (swiglu and (gelu or rope is not None)) or (rope is not None and (
            rope.shape != (s, 2, 64) or rope.dtype != torch.float32 or rope_cols % 64
            or not 0 < rope_cols <= n)):
        raise ValueError(f"ln_gemm: swiglu takes no other activation; the rope table must be "
                         f"({s}, 2, 64) fp32 and rope_cols a multiple of 64 in (0, N]")
    if (w.shape != (k, n) or b.shape != (n,) or (has_ln != (ln_bias is not None))
            or (plane is not None and not has_ln)):
        raise ValueError(f"ln_gemm: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}; w must be (K, N), b (N,), ln_scale and ln_bias "
                         f"come together and the splice needs LayerNorm")
    plane, pmask = _splice_args(plane, pmask, s, k, x.dtype)
    g = ln_scale.float().contiguous() if has_ln else None
    gb = ln_bias.float().contiguous() if has_ln else None
    _build.require_cuda(x.dtype, x.device, x=x, w=w, b=b, plane=plane)
    ptr = _build.ptr
    rope = None if rope is None else rope.contiguous()
    check_gemm_operands("ln_gemm", bsz * s, k, n, has_ln,
                        dict(x=ptr(x), w=ptr(w), b=ptr(b), plane=ptr(plane), pmask=ptr(pmask),
                             ln_scale=ptr(g), ln_bias=ptr(gb), rope=ptr(rope)),
                        fp32=x.dtype == torch.float32, mode=mode)
    out = torch.empty(bsz, s, n // 2 if swiglu else n, dtype=x.dtype, device=x.device)
    lib = _build.library("block")
    rc = lib.ln_gemm(ptr(x), ptr(plane), ptr(pmask), ptr(g), ptr(gb), ptr(w), ptr(b), ptr(rope),
                     ptr(out), bsz * s, n, k, s, 2 if swiglu else int(gelu),
                     rope_cols if rope is not None else 0, eps, _build.DTYPE_CODES[x.dtype],
                     _build.stream(x))
    _build.check(lib, rc, "ln_gemm")
    ln_gemm.launches += 1
    return out


ln_gemm.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: attention on the packed qkv buffer (the mha_core kernel)
# ---------------------------------------------------------------------------


def attention_reference(qkv: Tensor, n_heads: int, mask: Optional[Tensor] = None,
                        fast: bool = False) -> Tensor:
    """(B, S, 3D) qkv -> (B, S, D): the plain version of the fused kernels'
    attention core `_attention_heads`, normalised late by the row
    reciprocal. exact: max-subtracted exp; fast: exp2(min(s + mask, 120)) in
    log2e units, denominator floored at 1e-30."""
    bsz, s, d3 = qkv.shape
    o = softmax_attention(*_qkv_views(qkv, n_heads), mask, fast, divide=False)
    return o.reshape(bsz, s, d3 // 3)


def _attention_kernel(qkv: Tensor, n_heads: int, mask: Optional[Tensor] = None,
                      fast: bool = False) -> Tensor:
    """The mha_core kernel on strided views of the qkv buffer -> (B, S, D);
    CPU tensors take `attention_reference` (the block's plain version, which
    normalises by the reciprocal as the kernel does)."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv, n_heads, mask, fast)
    bsz, s, d3 = qkv.shape
    return mha_core(*_qkv_views(qkv, n_heads), mask, fast=fast).reshape(bsz, s, d3 // 3)


# ---------------------------------------------------------------------------
# kernel 3: GEMM + bias [+ residual]
# ---------------------------------------------------------------------------


def gemm_bias_residual_reference(a: Tensor, w: Tensor, b: Tensor,
                                 residual: Optional[Tensor] = None,
                                 plane: Optional[Tensor] = None,
                                 pmask: Optional[Tensor] = None, *,
                                 ln_scale: Optional[Tensor] = None,
                                 ln_bias: Optional[Tensor] = None,
                                 eps: float = 1e-5) -> Tensor:
    """[LN(a)] @ w + b [+ splice(residual)] in fp32 (the LN output cast to
    a.dtype first), then the cast."""
    if ln_scale is not None:
        a = layer_norm({"scale": ln_scale, "bias": ln_bias}, a, eps)
    acc = a.float() @ w.float() + b.float()
    if residual is not None:
        acc = acc + splice_plane(residual, plane, pmask).float()
    elif plane is not None:
        raise ValueError("gemm_bias_residual: the deep-prompt splice needs a residual")
    return acc.to(a.dtype)


def gemm_bias_residual(a: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None,
                       plane: Optional[Tensor] = None,
                       pmask: Optional[Tensor] = None, *, ln_scale: Optional[Tensor] = None,
                       ln_bias: Optional[Tensor] = None, eps: float = 1e-5) -> Tensor:
    """(B, S, K) -> (B, S, N). CUDA: csrc/block_kernels.cu::gemm_bias_residual
    (residual None: the same kernel with the bias epilogue alone). With
    ln_scale / ln_bias (bf16, a residual): a LayerNorm of a's rows first, in
    the same launch (EVA02's sub-LN on the attention output); the splice then
    applies to the residual alone."""
    _build.check_forward_only(a, w, b, residual, plane, ln_scale, ln_bias)
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, residual, plane, pmask, ln_scale=ln_scale,
                                            ln_bias=ln_bias, eps=eps)
    bsz, s, k = a.shape
    n = w.shape[1]
    has_ln = ln_scale is not None
    if (w.shape != (k, n) or b.shape != (n,)
            or (residual is not None and residual.shape != (bsz, s, n))
            or (residual is None and plane is not None)
            or has_ln != (ln_bias is not None) or (has_ln and residual is None)):
        raise ValueError(
            f"gemm_bias_residual: a {tuple(a.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)}, residual "
            f"{None if residual is None else tuple(residual.shape)}; w must be (K, N), "
            "b (N,), the residual as the output, and the splice and the LayerNorm "
            "need a residual"
        )
    plane, pmask = _splice_args(plane, pmask, s, n, a.dtype)
    g = ln_scale.float().contiguous() if has_ln else None
    gb = ln_bias.float().contiguous() if has_ln else None
    _build.require_cuda(a.dtype, a.device, a=a, w=w, b=b, residual=residual, plane=plane)
    ptr = _build.ptr
    check_gemm_operands("gemm_bias_residual", bsz * s, k, n, has_ln,
                        dict(a=ptr(a), w=ptr(w), b=ptr(b), residual=ptr(residual),
                             plane=ptr(plane), pmask=ptr(pmask), ln_scale=ptr(g),
                             ln_bias=ptr(gb)),
                        fp32=a.dtype == torch.float32, mode="ln_residual" if has_ln else None)
    out = torch.empty(bsz, s, n, dtype=a.dtype, device=a.device)
    lib = _build.library("block")
    rc = lib.gemm_bias_residual(ptr(a), ptr(g), ptr(gb), ptr(w), ptr(b), ptr(residual),
                                ptr(plane), ptr(pmask), ptr(out), bsz * s, n, k, s, eps,
                                _build.DTYPE_CODES[a.dtype], _build.stream(a))
    _build.check(lib, rc, "gemm_bias_residual")
    gemm_bias_residual.launches += 1
    return out


gemm_bias_residual.launches = 0


# ---------------------------------------------------------------------------
# kernel 4: LayerNorm over rows as a pass of its own (EVA02's block,
# ops/fused_eva.py: LN_1 with the splice, LN_2, the MLP's sub-LN over the
# padded hidden width)
# ---------------------------------------------------------------------------

LN_ROWS_MAX_WIDTH = 4096  # a lane holds its row's 16-byte chunks in registers


def ln_rows_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, n_real: int,
                      eps: float = 1e-5, plane: Optional[Tensor] = None,
                      pmask: Optional[Tensor] = None) -> Tensor:
    """LN over the last axis of splice(x) with the statistics of its first
    n_real columns, the fp32 affine over all of them, cast back to x.dtype."""
    x32 = splice_plane(x, plane, pmask).float()
    real = x32[..., :n_real]
    mean = real.mean(dim=-1, keepdim=True)
    var = (real - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * ln_scale.float() + ln_bias.float()).to(x.dtype)


def check_ln_rows_operands(what: str, m: int, k: int, n_real: int, addresses: dict) -> None:
    """What the ln_rows kernel takes (ValueError otherwise): K a multiple of
    8 up to LN_ROWS_MAX_WIDTH (16-byte chunks, a row in a warp's registers),
    1 <= n_real <= K, M within 32 bits, every base 16-byte aligned."""
    if k <= 0 or k % 8 or k > LN_ROWS_MAX_WIDTH or not 1 <= n_real <= k or m >= 2 ** 31:
        raise ValueError(f"{what}: M, K, n_real = {m}, {k}, {n_real}; needs K % 8 == 0, "
                         f"K <= {LN_ROWS_MAX_WIDTH} and 1 <= n_real <= K")
    for name, address in addresses.items():
        if address is not None and address % 16:
            raise ValueError(f"{what}: {name} at address {address:#x} is not 16-byte aligned")


def ln_rows(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, n_real: int,
            eps: float = 1e-5, plane: Optional[Tensor] = None,
            pmask: Optional[Tensor] = None) -> Tensor:
    """(B, S, K) -> (B, S, K): LayerNorm of splice(x) with the statistics of
    the first n_real columns: EVA02's LN_1 (with the deep-prompt splice) and
    LN_2 before their products (n_real = K), and its MLP's sub-LN over the
    hidden width, stored padded to a multiple of 64 with zero gamma and beta
    past n_real. bf16. CUDA: csrc/block_kernels.cu::ln_rows; CPU tensors take
    the plain version."""
    _build.check_forward_only(x, ln_scale, ln_bias, plane)
    if x.device.type == "cpu":
        return ln_rows_reference(x, ln_scale, ln_bias, n_real, eps, plane, pmask)
    bsz, s, k = x.shape
    if x.dtype != torch.bfloat16 or ln_scale.shape != (k,) or ln_bias.shape != (k,):
        raise ValueError(f"ln_rows: x {tuple(x.shape)} {x.dtype}, gamma "
                         f"{tuple(ln_scale.shape)}; bf16 rows and (K,) parameters")
    plane, pmask = _splice_args(plane, pmask, s, k, x.dtype)
    g = ln_scale.float().contiguous()
    gb = ln_bias.float().contiguous()
    _build.require_cuda(x.dtype, x.device, x=x, plane=plane)
    ptr = _build.ptr
    out = torch.empty_like(x)
    check_ln_rows_operands("ln_rows", bsz * s, k, n_real,
                           dict(x=ptr(x), out=ptr(out), ln_scale=ptr(g), ln_bias=ptr(gb),
                                plane=ptr(plane)))
    lib = _build.library("block")
    rc = lib.ln_rows(ptr(x), ptr(plane), ptr(pmask), ptr(g), ptr(gb), ptr(out), bsz * s, k, s,
                     n_real, eps, _build.stream(x))
    _build.check(lib, rc, "ln_rows")
    ln_rows.launches += 1
    return out


ln_rows.launches = 0


# ---------------------------------------------------------------------------
# fused_mha, fused_mlp and the whole block
# ---------------------------------------------------------------------------

_KERNELS = (ln_gemm, _attention_kernel, gemm_bias_residual)
_PLAIN = (ln_gemm_reference, attention_reference, gemm_bias_residual_reference)


def _mha(x, w_in, b_in, w_out, b_out, n_heads, mask, ln_scale, ln_bias, fast, plane, pmask,
         pieces):
    ln_gemm_fn, attention_fn, gemm_fn = pieces
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("fused_mha: pass both ln_scale and ln_bias, or neither")
    if plane is not None and ln_scale is None:
        raise ValueError("fused_mha: the deep-prompt splice needs the pre-LN mode")
    qkv = ln_gemm_fn(x, ln_scale, ln_bias, w_in, b_in, False, plane, pmask)
    a = attention_fn(qkv, n_heads, mask, fast)
    return gemm_fn(a, w_out, b_out, x if ln_scale is not None else None, plane, pmask)


def _mlp(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, pieces):
    ln_gemm_fn, _, gemm_fn = pieces
    h = ln_gemm_fn(x, ln_scale, ln_bias, w_fc, b_fc, True)
    return gemm_fn(h, w_proj, b_proj, x)


def fused_mha_reference(
    x: Tensor, w_in: Tensor, b_in: Tensor, w_out: Tensor, b_out: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, ln_scale: Optional[Tensor] = None,
    ln_bias: Optional[Tensor] = None, fast: bool = False, *,
    prompt_plane: Optional[Tensor] = None, prompt_mask: Optional[Tensor] = None,
) -> Tensor:
    """Plain version of `fused_mha`, rounding where the kernels do."""
    return _mha(x, w_in, b_in, w_out, b_out, n_heads, mask, ln_scale, ln_bias, fast,
                prompt_plane, prompt_mask, _PLAIN)


def fused_mha(
    x: Tensor, w_in: Tensor, b_in: Tensor, w_out: Tensor, b_out: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, ln_scale: Optional[Tensor] = None,
    ln_bias: Optional[Tensor] = None, fast: bool = False, *,
    prompt_plane: Optional[Tensor] = None, prompt_mask: Optional[Tensor] = None,
) -> Tensor:
    """Multi-head self-attention over (B, S, D), W_in (D, 3D), W_out (D, D).

    With ln_scale/ln_bias: the pre-norm half-block x + attn(LN(x)), with the
    optional deep-prompt splice (prompt_plane (S, D), prompt_mask (S, 1) or
    (S,): rows where the mask is > 0 come from the plane, before the LN and
    in the residual). Without them: attn(x), no residual. `mask` an optional
    additive (S, S) mask. Three launches on CUDA tensors: ln_gemm, mha_core
    on strided views of qkv, gemm_bias_residual; CPU tensors take the plain
    versions."""
    out = _mha(x, w_in, b_in, w_out, b_out, n_heads, mask, ln_scale, ln_bias, fast,
               prompt_plane, prompt_mask, _KERNELS)
    if x.is_cuda:
        fused_mha.launches += 1
    return out


fused_mha.launches = 0


def fused_mlp_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_fc: Tensor,
                        b_fc: Tensor, w_proj: Tensor, b_proj: Tensor) -> Tensor:
    """Plain version of `fused_mlp`, rounding where the kernels do (the
    hidden activation cast to x.dtype after QuickGELU)."""
    return _mlp(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, _PLAIN)


def fused_mlp(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_fc: Tensor, b_fc: Tensor,
              w_proj: Tensor, b_proj: Tensor) -> Tensor:
    """x + c_proj(QuickGELU(c_fc(LN(x)))) over (B, S, D), W_fc (D, hid),
    W_proj (hid, D). Two launches on CUDA tensors: ln_gemm(gelu),
    gemm_bias_residual; CPU tensors take the plain versions."""
    out = _mlp(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, _KERNELS)
    if x.is_cuda:
        fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def _block_xla_impl(p: dict, x: Tensor, n_heads: int,
                    mask: Optional[Tensor]) -> Tensor:
    """Plain pre-norm block body (the name keeps the JAX counterpart's):
    x + attn(ln1 x); x + mlp(ln2 x), the attention `xla_mha_core`. The
    parity path, and the recompute that bf16 blocks differentiate."""
    b, s, d = x.shape
    dh = d // n_heads
    h = layer_norm(p["ln_1"], x)
    qkv = linear(p["attn"]["in_proj"], h)
    q, k, v = qkv.split(d, dim=-1)
    attn = xla_mha_core(
        q.reshape(b, s, n_heads, dh), k.reshape(b, s, n_heads, dh),
        v.reshape(b, s, n_heads, dh), mask,
    )
    x = x + linear(p["attn"]["out_proj"], attn.reshape(b, s, d))
    return x + mlp(p["mlp"], layer_norm(p["ln_2"], x))


def fused_block_reference(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """Plain version of `fused_block`: fused_mlp_reference(fused_mha_reference(x))."""
    x1 = fused_mha_reference(x, w_in, b_in, w_out, b_out, n_heads, mask, ln1_scale,
                             ln1_bias, fast, prompt_plane=prompt_plane,
                             prompt_mask=prompt_mask)
    return fused_mlp_reference(x1, ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj)


def fused_block(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """One pre-norm transformer block, (B, S, D) -> (B, S, D):
    fused_mlp(fused_mha(x)), five launches on CUDA tensors.

    prompt_plane (S, D) / prompt_mask (S, 1) or (S,): optional deep-prompt
    splice — rows where prompt_mask > 0 are replaced by the plane BEFORE the
    block, and the spliced rows are also the out-proj residual. CPU tensors
    go through the plain versions."""
    x1 = fused_mha(x, w_in, b_in, w_out, b_out, n_heads, mask, ln1_scale, ln1_bias, fast,
                   prompt_plane=prompt_plane, prompt_mask=prompt_mask)
    out = fused_mlp(x1, ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj)
    if x.is_cuda:
        fused_block.launches += 1
    return out


fused_block.launches = 0


# ---------------------------------------------------------------------------
# the fp32 block backward's products: the recompute (X W + b), dgrad (dY W^T)
# and wgrad (X^T dY)
# ---------------------------------------------------------------------------

_BACKWARD_MODES = {"dgrad": 0, "dgelu": 1, "wgrad": 2, "product": 3}


def gemm_product(a: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None) -> Tensor:
    """The backward's recompute of a forward product: a (M, K) @ w (K, N) +
    b [+ residual (M, N)], fp32, each 32-deep stage's sum promoted to fp32
    registers (the forward kernels keep one accumulator, whose truncating
    additions drift ~7e-6 at K = 768). CUDA:
    csrc/block_kernels.cu::gemm_tf32x3_backward (mode product); CPU tensors
    take `gemm_bias_residual_reference`."""
    _build.check_forward_only(a, w, b, residual)
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, residual)
    m, k = a.shape
    n = w.shape[1]
    if w.shape != (k, n) or b.shape != (n,) or (
            residual is not None and residual.shape != (m, n)):
        raise ValueError(f"gemm_product: a {tuple(a.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}, residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    _build.require_cuda(torch.float32, a.device, a=a, w=w, b=b, residual=residual)
    ptr = _build.ptr
    check_gemm_operands("gemm_product", m, k, n, False,
                        dict(a=ptr(a), w=ptr(w), b=ptr(b), residual=ptr(residual)), fp32=True)
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    lib = _build.library("block")
    rc = lib.gemm_tf32x3_backward(ptr(a), ptr(w), ptr(b), ptr(residual), ptr(out), None, m, n,
                                  k, 1, _BACKWARD_MODES["product"], _build.stream(a))
    _build.check(lib, rc, "gemm_product")
    gemm_product.launches += 1
    return out


gemm_product.launches = 0


def quick_gelu_grad(h: Tensor) -> Tensor:
    """d/dh of QuickGELU, h sigmoid(1.702 h): s + 1.702 h s (1 - s)."""
    s = torch.sigmoid(1.702 * h)
    return s + 1.702 * h * s * (1 - s)


def gemm_dgrad_reference(dy: Tensor, w: Tensor, h: Optional[Tensor] = None) -> Tensor:
    """dy @ w^T [* QuickGELU'(h)] in fp32."""
    out = dy @ w.t()
    return out if h is None else out * quick_gelu_grad(h)


def gemm_dgrad(dy: Tensor, w: Tensor, h: Optional[Tensor] = None,
               act: Optional[Tensor] = None) -> Tensor:
    """The gradient of a product's input: dy (M, N) @ w^T -> (M, K), w the
    forward product's (K, N) weight as stored (the kernel reads it
    transposed); with h (M, K), the pre-activation of a QuickGELU, times
    QuickGELU'(h), and `act` (M, K), where given, filled with QuickGELU(h)
    (the epilogue reads h anyway: the activation c_proj's wgrad takes). fp32.
    CUDA: csrc/block_kernels.cu::gemm_tf32x3_backward (modes dgrad, dgelu);
    CPU tensors take the plain version."""
    _build.check_forward_only(dy, w, h)
    if act is not None and h is None:
        raise ValueError("gemm_dgrad: the activation needs its pre-activation h")
    if dy.device.type == "cpu":
        if act is not None:
            act.copy_(quick_gelu(h))
        return gemm_dgrad_reference(dy, w, h)
    m, n = dy.shape
    k = w.shape[0]
    if w.shape != (k, n) or (h is not None and h.shape != (m, k)) or (
            act is not None and act.shape != (m, k)):
        raise ValueError(f"gemm_dgrad: dy {tuple(dy.shape)}, w {tuple(w.shape)}, h "
                         f"{None if h is None else tuple(h.shape)}; w must be (K, N), h and "
                         f"the activation (M, K)")
    _build.require_cuda(torch.float32, dy.device, dy=dy, w=w, h=h, act=act)
    ptr = _build.ptr
    # the reduction runs along w's rows: N plays the kernel's K
    check_gemm_operands("gemm_dgrad", m, n, k, False,
                        dict(dy=ptr(dy), w=ptr(w), gelu_input=ptr(h), act=ptr(act)),
                        fp32=True)
    out = torch.empty(m, k, dtype=dy.dtype, device=dy.device)
    lib = _build.library("block")
    rc = lib.gemm_tf32x3_backward(ptr(dy), ptr(w), None, ptr(h), ptr(out), ptr(act), m, k, n,
                                  1, _BACKWARD_MODES["dgrad" if h is None else "dgelu"],
                                  _build.stream(dy))
    _build.check(lib, rc, "gemm_dgrad")
    gemm_dgrad.launches += 1
    return out


gemm_dgrad.launches = 0


def check_wgrad_operands(what: str, r: int, m: int, n: int, addresses: dict) -> None:
    """What the wgrad mode of the fp32 GEMM kernel takes, x (R, M)^T @ dy
    (R, N), from sizes and base addresses alone (ValueError otherwise): x is
    read transposed by TMA in 32 x 32 boxes, so M a multiple of 4 (16-byte
    rows); N a multiple of 8, as the forward product's; R, the reduction over
    the batch's rows, is free (the last stage is zero-filled); sizes within
    a tensor map's 32-bit extents; x and dy at 16-byte aligned bases."""
    if r <= 0 or m <= 0 or n <= 0 or m % 4 or n % 8:
        raise ValueError(f"{what}: R, M, N = {r}, {m}, {n}; needs R > 0, M % 4 == 0 and "
                         f"N % 8 == 0")
    if max(r, m, n) >= 2 ** 31:
        raise ValueError(f"{what}: R, M, N = {r}, {m}, {n} exceed a tensor map's extents")
    for name, address in addresses.items():
        if address is not None and address % 16:
            raise ValueError(f"{what}: {name} at address {address:#x} is not 16-byte aligned")


def wgrad_splits(r: int, m: int, n: int, sms: int) -> int:
    """Ranges of the reduction a wgrad of an (M, N) output over R rows is
    split into, for `sms` persistent blocks: the count of 32-row stages on
    the longest block's path (waves of (M/128 x N/128 tiles x splits) chunks
    times the stages of a range), plus one per split for the partials'
    traffic; the fewest splits among equals. A function of the shapes and
    the card alone, so one shape always sums its partials in one order."""
    tiles = -(-m // 128) * -(-n // 128)
    stages = -(-r // 32)

    def cost(s: int) -> int:
        return -(-tiles * s // sms) * -(-stages // s) + s

    return min(range(1, min(16, stages) + 1), key=lambda s: (cost(s), s))


def gemm_wgrad_reference(x: Tensor, dy: Tensor) -> Tensor:
    """x^T @ dy in fp32."""
    return x.t() @ dy


def gemm_wgrad(x: Tensor, dy: Tensor) -> Tensor:
    """The gradient of a product's weight: x (R, M)^T @ dy (R, N) -> (M, N),
    summed over the R rows of a batch. fp32. CUDA:
    csrc/block_kernels.cu::gemm_tf32x3_backward (mode wgrad; x read
    transposed by TMA, R split into `wgrad_splits` ranges whose partials are
    summed here in one order: equal bits run to run); CPU tensors take the
    plain version."""
    _build.check_forward_only(x, dy)
    if x.device.type == "cpu":
        return gemm_wgrad_reference(x, dy)
    r, m = x.shape
    n = dy.shape[1]
    if dy.shape != (r, n):
        raise ValueError(f"gemm_wgrad: x {tuple(x.shape)}, dy {tuple(dy.shape)}; both (R, .)")
    _build.require_cuda(torch.float32, x.device, x=x, dy=dy)
    ptr = _build.ptr
    check_wgrad_operands("gemm_wgrad", r, m, n, dict(x=ptr(x), dy=ptr(dy)))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = wgrad_splits(r, m, n, sms)
    out = torch.empty(splits, m, n, dtype=x.dtype, device=x.device)
    lib = _build.library("block")
    rc = lib.gemm_tf32x3_backward(ptr(x), ptr(dy), None, None, ptr(out), None, m, n, r,
                                  splits, _BACKWARD_MODES["wgrad"], _build.stream(x))
    _build.check(lib, rc, "gemm_wgrad")
    gemm_wgrad.launches += 1
    return out[0] if splits == 1 else out.sum(0)


gemm_wgrad.launches = 0


# ---------------------------------------------------------------------------
# gradients: forward through the kernels, backward written out
# ---------------------------------------------------------------------------


def _block_params(w) -> dict:
    """The 12 positional block tensors as `_block_xla_impl`'s parameter dict."""
    return {
        "ln_1": {"scale": w[0], "bias": w[1]},
        "attn": {"in_proj": {"w": w[2], "b": w[3]}, "out_proj": {"w": w[4], "b": w[5]}},
        "ln_2": {"scale": w[6], "bias": w[7]},
        "mlp": {"c_fc": {"w": w[8], "b": w[9]}, "c_proj": {"w": w[10], "b": w[11]}},
    }


def block_backward_route(x: Tensor, weights, n_heads: int) -> str:
    """How `fused_block_backward` takes a block: "kernel" (fp32 CUDA tensors
    whose every product, and the attention core, lie in the kernels' domain:
    the written-out chain on the kernels), "chain" (the same on fp32 CPU
    tensors, with the plain versions) or "plain" (bf16, or a shape outside
    the domain: the plain block's recompute under autograd). Decided from
    dtype, device and sizes: the chain's operands are its own fresh tensors,
    aligned."""
    if x.dtype != torch.float32:
        return "plain"
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    if x.is_cuda and d != n_heads * HEAD_DIM:
        return "plain"  # the attention kernels' head width
    d3, hid = weights[2].shape[1], weights[8].shape[1]
    try:
        # the recompute's (K, N) and the dgrads' (N, K) of the four products
        for k, n in {(d, d3), (d, d), (d, hid), (hid, d), (d3, d)}:
            check_gemm_operands("block backward", rows, k, n, False, {}, fp32=True)
        for m, n in ((d, d3), (d, d), (d, hid), (hid, d)):
            check_wgrad_operands("block backward", rows, m, n, {})
    except ValueError:
        return "plain"
    return "kernel" if x.is_cuda else "chain"


def _aligned(t: Tensor) -> Tensor:
    """t contiguous at a 16-byte aligned base (a copy where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _layer_norm_backward(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, scale: Tensor,
                         bias: Tensor, needs: list) -> tuple:
    """dx, dscale, dbias of the fp32 LayerNorm (None where `needs` says no)."""
    return torch.ops.aten.native_layer_norm_backward(dy, x, (x.shape[-1],), mean, rstd, scale,
                                                     bias, needs)


def _written_out_backward(g, x, plane, pmask, mask, n_heads, weights, needs):
    """The fp32 block's gradients, the chain written out (see
    `fused_block_backward`); `needs` is ctx.needs_input_grad."""
    from tpu_reid_torch.ops import attention as A

    ln1_s, ln1_b, w_in, b_in, w_out, b_out, ln2_s, ln2_b, w_fc, b_fc, w_proj, b_proj = weights
    need_w = needs[6:]
    bsz, s, d = x.shape
    rows = bsz * s

    def flat(t):
        return t.reshape(rows, t.shape[-1])

    def unflat(t):
        return t.reshape(bsz, s, t.shape[-1])

    # recompute through the kernel, keeping what the gradients read
    xin = splice_plane(x, plane, pmask)
    h1, mu1, rs1 = torch.native_layer_norm(xin, (d,), ln1_s, ln1_b, 1e-5)
    qkv = unflat(gemm_product(flat(h1), w_in, b_in))
    views = _qkv_views(qkv, n_heads)
    a, lse = A.mha_core_lse(*views, mask)
    a_in = a.reshape(bsz, s, d).contiguous()
    x1 = unflat(gemm_product(flat(a_in), w_out, b_out, flat(xin)))
    h2, mu2, rs2 = torch.native_layer_norm(x1, (d,), ln2_s, ln2_b, 1e-5)
    hpre = gemm_product(flat(h2), w_fc, b_fc)

    dw = [None] * 12
    g = _aligned(flat(g))
    # c_proj, then QuickGELU' in the dgrad's epilogue, which also writes the
    # activation that c_proj's wgrad reads
    hact = torch.empty_like(hpre) if need_w[10] else None
    d_hpre = gemm_dgrad(g, w_proj, hpre, hact)
    if need_w[10]:
        dw[10] = gemm_wgrad(hact, g)
    if need_w[11]:
        dw[11] = g.sum(0)
    # c_fc, LN2, the residual
    dh2 = gemm_dgrad(d_hpre, w_fc)
    if need_w[8]:
        dw[8] = gemm_wgrad(flat(h2), d_hpre)
    if need_w[9]:
        dw[9] = d_hpre.sum(0)
    dx1_ln, dw[6], dw[7] = _layer_norm_backward(unflat(dh2), x1, mu2, rs2, ln2_s, ln2_b,
                                                [True, need_w[6], need_w[7]])
    dx1 = g + flat(dx1_ln)
    # out_proj, the attention core, in_proj
    da = gemm_dgrad(dx1, w_out)
    if need_w[4]:
        dw[4] = gemm_wgrad(flat(a_in), dx1)
    if need_w[5]:
        dw[5] = dx1.sum(0)
    dqkv = flat(A.mha_core_backward(*views, a, da.reshape(bsz, s, n_heads, -1), lse, mask))
    del a
    need_x = needs[0] or needs[1]
    if need_x or need_w[0] or need_w[1]:
        dh1 = gemm_dgrad(dqkv, w_in)
    if need_w[2]:
        dw[2] = gemm_wgrad(flat(h1), dqkv)
    if need_w[3]:
        dw[3] = dqkv.sum(0)
    dx = dplane = None
    if need_x or need_w[0] or need_w[1]:
        dxin_ln, dw[0], dw[1] = _layer_norm_backward(unflat(dh1), xin, mu1, rs1, ln1_s, ln1_b,
                                                     [need_x, need_w[0], need_w[1]])
    if need_x:
        dxin = unflat(dx1) + dxin_ln
        dx = dxin
        if plane is not None:
            # the splice: spliced rows' gradient goes to the plane, summed over the batch
            keep = pmask.reshape(1, -1, 1) > 0
            dplane = torch.where(keep, dxin, 0.0).sum(0).to(plane.dtype)
            dx = torch.where(keep, 0.0, dxin)
    return dx, dplane, dw


def recompute_grads(fn, inputs, grad_out) -> tuple:
    """The backward of an autograd Function whose forward ran kernels: fn
    (the plain version) re-run under autograd on detached copies of
    `inputs`, and the gradients of its output(s) against `grad_out` for each
    input, None where an input is None or the output does not use it."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_() for t in inputs]
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad(fn(*ins), live, grad_out, allow_unused=True))
    return tuple(None if t is None else next(grads) for t in ins)


def fused_block_backward(g, x, plane, pmask, mask, n_heads, weights, needs):
    """The gradients of one block for `_FusedBlockFn`: (dx, dplane, the 12
    tensors' list), as `block_backward_route` routes it.

    fp32 (the training CLIs' default): the written-out chain. It recomputes
    the block (the LayerNorms in plain fp32, keeping their statistics; qkv,
    x1 and the MLP's pre-activation on the fp32 GEMM kernel, `gemm_product`,
    whose promoted sums keep them fp32-accurate; the attention core on the
    exact fp32 `mha_core` kernel with each row's log-sum-exp,
    `mha_core_lse`) and then takes every gradient by hand: each of the four
    products' dgrad (QuickGELU' in c_proj's) and wgrad on the fp32 GEMM
    kernel (`gemm_dgrad`, `gemm_wgrad`), the core's for the packed qkv on
    `mha_core_backward` (the exact softmax's gradient, with the block's
    mask, whatever the fast-softmax profile says), the bias gradients as
    column sums, the LayerNorms' through aten's LayerNorm backward, the
    splice's as a batch sum over the spliced rows; only what `needs` asks
    for. On CPU tensors the same chain runs the plain versions. bf16, or a
    shape outside the kernels' domain (a head width other than 64 on the
    card among them): the plain block's recompute under autograd
    (`recompute_grads` of `_block_xla_impl` after the splice).

    `fused_block_backward.launches` counts the calls that ran the chain on
    the kernels, `.plain` those that took the recompute."""
    route = block_backward_route(x, weights, n_heads)
    if route == "plain":
        fused_block_backward.plain += 1
        dx, dplane, *dws = recompute_grads(
            lambda x, plane, *ws: _block_xla_impl(_block_params(ws),
                                                  splice_plane(x, plane, pmask), n_heads, mask),
            (x, plane, *weights), g)
        return dx, dplane, dws
    grads = _written_out_backward(g, x, plane, pmask, mask, n_heads, weights, needs)
    if route == "kernel":
        fused_block_backward.launches += 1
    return grads


fused_block_backward.launches = 0
fused_block_backward.plain = 0


class _FusedBlockFn(torch.autograd.Function):
    """The counterpart of the JAX package's `_block_fused` /
    `_block_fused_spliced` custom VJPs (models/layers.py): the forward runs
    `fused_block` (the kernels on CUDA tensors) and saves only x, the plane,
    the prompt mask, the attention mask and the 12 tensors passed in — no
    activation of the block. The backward recomputes the block and returns
    the gradients for x, the plane and the 12 tensors that
    `_block_xla_impl(p, splice_plane(x, plane, pmask), n_heads, mask)` has:
    `fused_block_backward`, in fp32 the written-out chain on the kernels, in
    bf16 the plain block under autograd. Under the fast softmax the forward
    takes the kernels' exp2 form and the recompute the exact softmax in fp32
    (`xla_mha_core`'s bf16-probability form in bf16), as in JAX."""

    @staticmethod
    def forward(ctx, x, plane, pmask, mask, n_heads, fast, *weights):
        ctx.n_heads = n_heads
        ctx.save_for_backward(x, plane, pmask, mask, *weights)
        return fused_block(x, *weights, n_heads, mask, plane, pmask, fast)

    @staticmethod
    def backward(ctx, g):
        x, plane, pmask, mask, *weights = ctx.saved_tensors
        dx, dplane, dws = fused_block_backward(g, x, plane, pmask, mask, ctx.n_heads, weights,
                                               ctx.needs_input_grad)
        return (dx, dplane, None, None, None, None, *dws)


def fused_block_autograd(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """`fused_block` with gradients: forward through the kernels, backward
    through `fused_block_backward`; see `_FusedBlockFn`. With no input
    requiring grad (serving) it builds no graph and is `fused_block`. Returns None gradients for the prompt mask and the
    attention mask."""
    return _FusedBlockFn.apply(x, prompt_plane, prompt_mask, mask, n_heads, fast,
                               ln1_scale, ln1_bias, w_in, b_in, w_out, b_out,
                               ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj)
