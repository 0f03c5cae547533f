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

Each kernel has a wrapper that launches it for CUDA tensors (or raises) and
takes the plain PyTorch version beside it for CPU tensors; the plain versions
repeat the kernels' arithmetic and bf16 rounding points. Each wrapper, and
each of fused_mha / fused_mlp / fused_block, counts the calls in which it
launched kernels in its `launches` attribute. The wrappers are forward-only:
an input that requires grad raises. The model's blocks (serving and
training) go through `fused_block_autograd`, the counterpart of the JAX package's custom VJPs
(`_block_fused`, `_block_fused_spliced`): the forward runs the kernels, the
backward recomputes the plain block and differentiates it.

Layouts follow the JAX package: activations (B, S, D), linear weights
(in, out). Weights and biases come in the activations' dtype (float32 or
bfloat16); LayerNorm parameters are used in fp32 (the plain block's choice;
the Pallas kernels round them to the working type first).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_reid_torch.ops import _build
from tpu_reid_torch.ops.attention import mha_core, softmax_attention

LN_MAX_WIDTH = 1024  # ln_gemm keeps LayerNorm's gamma/beta and a row in fast memory

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


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


def _qkv_views(qkv: Tensor, n_heads: int) -> tuple[Tensor, Tensor, Tensor]:
    """(B, S, 3D) -> q, k, v as (B, S, H, dh) views (row stride 3D)."""
    d = qkv.shape[-1] // 3
    return tuple(qkv[..., i * d:(i + 1) * d].unflatten(-1, (n_heads, d // n_heads))
                 for i in range(3))


# operands the fp32 GEMM kernel reads element by element (the LayerNorm
# parameters into shared memory, the rest in its epilogue): any address will do
FP32_SCALAR_OPERANDS = frozenset({"b", "pmask", "ln_scale", "ln_bias", "residual"})


def check_gemm_operands(what: str, m: int, k: int, n: int, has_ln: bool,
                        addresses: dict, fp32: bool = False) -> None:
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
    masked on store."""
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


def ln_gemm_reference(x: Tensor, ln_scale: Optional[Tensor], ln_bias: Optional[Tensor],
                      w: Tensor, b: Tensor, gelu: bool = False,
                      plane: Optional[Tensor] = None,
                      pmask: Optional[Tensor] = None) -> Tensor:
    """act(LN(splice(x)) @ w + b): LN output cast to x.dtype, fp32 product,
    bias and QuickGELU in fp32, then the cast. ln_scale None: no LN (and no
    splice), the rows as they are."""
    if ln_scale is None:
        if plane is not None:
            raise ValueError("ln_gemm: the deep-prompt splice needs the LayerNorm prologue")
        h = x
    else:
        h = _layer_norm_f32(_splice(x, plane, pmask), ln_scale, ln_bias)
    acc = h.float() @ w.float() + b.float()
    if gelu:
        acc = acc * torch.sigmoid(1.702 * acc)
    return acc.to(x.dtype)


def ln_gemm(x: Tensor, ln_scale: Optional[Tensor], ln_bias: Optional[Tensor], w: Tensor,
            b: Tensor, gelu: bool = False, plane: Optional[Tensor] = None,
            pmask: Optional[Tensor] = None) -> Tensor:
    """(B, S, K) -> (B, S, N). CUDA: csrc/block_kernels.cu::ln_gemm (with
    ln_scale None: the same kernel without its LayerNorm prologue)."""
    _build.check_forward_only(x, ln_scale, ln_bias, w, b, plane)
    if x.device.type == "cpu":
        return ln_gemm_reference(x, ln_scale, ln_bias, w, b, gelu, plane, pmask)
    bsz, s, k = x.shape
    n = w.shape[1]
    has_ln = ln_scale is not None
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
    check_gemm_operands("ln_gemm", bsz * s, k, n, has_ln,
                        dict(x=ptr(x), w=ptr(w), b=ptr(b), plane=ptr(plane), pmask=ptr(pmask),
                             ln_scale=ptr(g), ln_bias=ptr(gb)),
                        fp32=x.dtype == torch.float32)
    out = torch.empty(bsz, s, n, dtype=x.dtype, device=x.device)
    lib = _build.library("block")
    rc = lib.ln_gemm(ptr(x), ptr(plane), ptr(pmask), ptr(g), ptr(gb), ptr(w), ptr(b),
                     ptr(out), bsz * s, n, k, s, int(gelu), _build.DTYPE_CODES[x.dtype],
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
                                 pmask: Optional[Tensor] = None) -> Tensor:
    """a @ w + b [+ splice(residual)] in fp32, then the cast."""
    acc = a.float() @ w.float() + b.float()
    if residual is not None:
        acc = acc + _splice(residual, plane, pmask).float()
    elif plane is not None:
        raise ValueError("gemm_bias_residual: the deep-prompt splice needs a residual")
    return acc.to(a.dtype)


def gemm_bias_residual(a: Tensor, w: Tensor, b: Tensor, residual: Optional[Tensor] = None,
                       plane: Optional[Tensor] = None,
                       pmask: Optional[Tensor] = None) -> Tensor:
    """(B, S, K) -> (B, S, N). CUDA: csrc/block_kernels.cu::gemm_bias_residual
    (residual None: the same kernel with the bias epilogue alone)."""
    _build.check_forward_only(a, w, b, residual, plane)
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, residual, plane, pmask)
    bsz, s, k = a.shape
    n = w.shape[1]
    if (w.shape != (k, n) or b.shape != (n,)
            or (residual is not None and residual.shape != (bsz, s, n))
            or (residual is None and plane is not None)):
        raise ValueError(
            f"gemm_bias_residual: a {tuple(a.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)}, residual "
            f"{None if residual is None else tuple(residual.shape)}; w must be (K, N), "
            "b (N,), the residual as the output, and the splice needs a residual"
        )
    plane, pmask = _splice_args(plane, pmask, s, n, a.dtype)
    _build.require_cuda(a.dtype, a.device, a=a, w=w, b=b, residual=residual, plane=plane)
    ptr = _build.ptr
    check_gemm_operands("gemm_bias_residual", bsz * s, k, n, False,
                        dict(a=ptr(a), w=ptr(w), b=ptr(b), residual=ptr(residual),
                             plane=ptr(plane), pmask=ptr(pmask)),
                        fp32=a.dtype == torch.float32)
    out = torch.empty(bsz, s, n, dtype=a.dtype, device=a.device)
    lib = _build.library("block")
    rc = lib.gemm_bias_residual(ptr(a), ptr(w), ptr(b), ptr(residual), ptr(plane),
                                ptr(pmask), ptr(out), bsz * s, n, k, s,
                                _build.DTYPE_CODES[a.dtype], _build.stream(a))
    _build.check(lib, rc, "gemm_bias_residual")
    gemm_bias_residual.launches += 1
    return out


gemm_bias_residual.launches = 0


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
# gradients: forward through the kernels, backward through the plain block
# ---------------------------------------------------------------------------


def _block_params(w) -> dict:
    """The 12 positional block tensors as models.layers' parameter dict."""
    return {
        "ln_1": {"scale": w[0], "bias": w[1]},
        "attn": {"in_proj": {"w": w[2], "b": w[3]}, "out_proj": {"w": w[4], "b": w[5]}},
        "ln_2": {"scale": w[6], "bias": w[7]},
        "mlp": {"c_fc": {"w": w[8], "b": w[9]}, "c_proj": {"w": w[10], "b": w[11]}},
    }


class _FusedBlockFn(torch.autograd.Function):
    """The counterpart of the JAX package's `_block_fused` /
    `_block_fused_spliced` custom VJPs (models/layers.py): the forward runs
    `fused_block` (the kernels on CUDA tensors) and saves only x, the plane,
    the prompt mask, the attention mask and the 12 tensors passed in — no
    activation of the block. The backward recomputes
    `_block_xla_impl(p, splice(x, plane, pmask), n_heads, mask)` under
    autograd and returns its gradients for x, the plane and the 12 tensors.
    Under the fast softmax the forward takes the kernels' exp2 form and the
    recompute `xla_mha_core`'s bf16-probability form, as in JAX."""

    @staticmethod
    def forward(ctx, x, plane, pmask, mask, n_heads, fast, *weights):
        ctx.n_heads = n_heads
        ctx.save_for_backward(x, plane, pmask, mask, *weights)
        return fused_block(x, *weights, n_heads, mask, plane, pmask, fast)

    @staticmethod
    def backward(ctx, g):
        from tpu_reid_torch.models.layers import _apply_splice_plane, _block_xla_impl

        x, plane, pmask, mask, *weights = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_()
            ws = [w.detach().requires_grad_() for w in weights]
            inputs = [xs] + ws
            xin = xs
            if plane is not None:
                ps = plane.detach().requires_grad_()
                inputs.append(ps)
                xin = _apply_splice_plane(xs, ps, pmask)
            out = _block_xla_impl(_block_params(ws), xin, ctx.n_heads, mask)
            grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        dx, dws = grads[0], grads[1:13]
        dplane = grads[13] if plane is not None else None
        return (dx, dplane, None, None, None, None, *dws)


def fused_block_autograd(
    x: Tensor, ln1_scale: Tensor, ln1_bias: Tensor, w_in: Tensor, b_in: Tensor,
    w_out: Tensor, b_out: Tensor, ln2_scale: Tensor, ln2_bias: Tensor,
    w_fc: Tensor, b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, n_heads: int,
    mask: Optional[Tensor] = None, prompt_plane: Optional[Tensor] = None,
    prompt_mask: Optional[Tensor] = None, fast: bool = False,
) -> Tensor:
    """`fused_block` with gradients: forward through the kernels, backward
    through the plain block's recompute; see `_FusedBlockFn`. With no input
    requiring grad (serving) it builds no graph and is `fused_block`. Returns None gradients for the prompt mask and the
    attention mask."""
    return _FusedBlockFn.apply(x, prompt_plane, prompt_mask, mask, n_heads, fast,
                               ln1_scale, ln1_bias, w_in, b_in, w_out, b_out,
                               ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj)
