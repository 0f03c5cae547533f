"""CLS tail: ln_post + projection in one hand-written CUDA kernel.

Replaces tpu_reid/ops/fused_tail.py::_tail_pallas (the Pallas `_tail_kernel`):
for (B, D) CLS rows, y = LN(x) with fp32 statistics and an fp32 affine, cast
to x.dtype, and p = y @ proj with fp32 accumulation from the rounded y — both
from one load of x (csrc/tail_kernel.cu). What bounds it on the H100 is
latency, not bytes or operations (0.1 GFLOP over 1.3 MB at the main path's
shape), so the bf16 kernel is built to be short: blocks of (32 rows, 64
columns) normalise their rows into a swizzled bf16 panel in shared memory
while TMA brings their (D, 64) slice of proj in bulk, and two warpgroups run
the product on wgmma, splitting K; rows up to D = 2048 (EVA02-CLIP-E/14's
1792). The fp32 kernel (the training CLIs' default dtype) runs 3xTF32 on
wgmma in clusters of 8 blocks that split K, reduced in a fixed order through
distributed shared memory, up to D = 1024. Shapes and
addresses neither takes run an FMA kernel; `tail_kernel_route` holds the
domains as a plain function of sizes and addresses. The plain version
`ln_proj_tail_reference` mirrors the JAX package's `_tail_xla`, the plain
layer_norm + dot composition. The kernel wrapper is forward-only: an input
that requires grad raises; the model's tail goes through `_TailFn`, the
counterpart of the JAX package's `_tail_fused` custom VJP (forward through the
kernel, backward through the plain composition's recompute).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_reid_torch.ops import _build
from tpu_reid_torch.ops.fused_attention import layer_norm, recompute_grads

Tensor = torch.Tensor

MAX_WIDTH = 2048  # the bf16 and FMA kernels keep a block's rows of D values in shared memory
TF32_MAX_WIDTH = 1024  # the 3xTF32 kernel: a lane of each of 8 ranks owns 16 bytes of a row


def ln_proj_tail_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, proj: Tensor,
                           proj_bias: Optional[Tensor] = None,
                           eps: float = 1e-5) -> tuple[Tensor, Tensor]:
    """(B, D) -> (LN(x), LN(x) @ proj [+ proj_bias]), the product accumulated
    in fp32 and the bias added in fp32 before the cast."""
    y = layer_norm({"scale": ln_scale, "bias": ln_bias}, x, eps)
    p = y.float() @ proj.to(y.dtype).float()
    if proj_bias is not None:
        p = p + proj_bias.float()
    return y, p.to(y.dtype)


def tail_kernel_route(b: int, d: int, e: int, bf16: bool, addresses: dict) -> str:
    """Which kernel of csrc/tail_kernel.cu takes x (B, D) and proj (D, E), from
    sizes and base addresses (`addresses`: name -> address) alone: "wgmma"
    (bf16), "tf32x3" (fp32) or "fma", or ValueError where none does. All need
    1 <= D <= MAX_WIDTH (a block keeps its rows over the whole of D in shared
    memory) and sizes within 32 bits. The two tensor-core kernels move every
    operand as 16-byte vectors or by TMA, so every base must be 16-byte
    aligned, and they read proj and store p in 16-byte rows: E a multiple of
    8 in bf16, of 4 in fp32. D must fill whole 128-byte swizzled rows of a K
    block: a multiple of 64 in bf16, of 32 in fp32, and in fp32 at most
    TF32_MAX_WIDTH (each rank's lane owns one 16-byte chunk of the rank's
    share). The FMA kernel reads and writes element by element and takes what
    lies outside those domains."""
    if not 1 <= d <= MAX_WIDTH or e < 1 or max(b, d, e) >= 2 ** 31:
        raise ValueError(f"ln_proj_tail: x ({b}, {d}), proj ({d}, {e}); needs "
                         f"1 <= D <= {MAX_WIDTH}, E >= 1 and sizes below 2^31")
    if not all(a % 16 == 0 for a in addresses.values()):
        return "fma"
    if bf16:
        return "wgmma" if d % 64 == 0 and e % 8 == 0 else "fma"
    return "tf32x3" if d % 32 == 0 and d <= TF32_MAX_WIDTH and e % 4 == 0 else "fma"


def _launch_tail(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, proj: Tensor,
                 fma: bool, proj_bias: Optional[Tensor] = None,
                 eps: float = 1e-5) -> tuple[Tensor, Tensor]:
    b, d = x.shape
    if proj.dim() != 2 or proj.shape[0] != d:
        raise ValueError(f"ln_proj_tail: x {tuple(x.shape)}, proj {tuple(proj.shape)}; "
                         "proj must be (D, E)")
    e = proj.shape[1]
    x = x.contiguous()
    proj = proj.to(x.dtype).contiguous()
    g = ln_scale.float().contiguous()
    gb = ln_bias.float().contiguous()
    hb = None if proj_bias is None else proj_bias.float().contiguous()
    if hb is not None and hb.shape != (e,):
        raise ValueError(f"ln_proj_tail: the head's bias {tuple(hb.shape)} is not ({e},)")
    _build.require_cuda(x.dtype, x.device, x=x, proj=proj)
    y = torch.empty(b, d, dtype=x.dtype, device=x.device)
    p = torch.empty(b, e, dtype=x.dtype, device=x.device)
    ptr = _build.ptr
    route = tail_kernel_route(b, d, e, x.dtype == torch.bfloat16,
                              dict(x=ptr(x), proj=ptr(proj), ln_scale=ptr(g), ln_bias=ptr(gb),
                                   y=ptr(y), p=ptr(p)))
    lib = _build.library("tail")
    rc = lib.ln_proj_tail(ptr(x), ptr(g), ptr(gb), ptr(proj), ptr(hb), ptr(y), ptr(p), b, d, e,
                          eps, _build.DTYPE_CODES[x.dtype], int(fma or route == "fma"),
                          _build.stream(x))
    _build.check(lib, rc, "ln_proj_tail")
    return y, p


def ln_proj_tail_kernel(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, proj: Tensor,
                        proj_bias: Optional[Tensor] = None,
                        eps: float = 1e-5) -> tuple[Tensor, Tensor]:
    """CUDA: csrc/tail_kernel.cu::ln_proj_tail (the bf16 wgmma kernel, the
    fp32 3xTF32 kernel, or the FMA kernel outside their domains:
    `tail_kernel_route`); CPU tensors take the plain version. proj_bias (E,):
    the head's bias (EVA02's), added in fp32 before the cast; eps the
    LayerNorm's epsilon."""
    _build.check_forward_only(x, ln_scale, ln_bias, proj, proj_bias)
    if x.device.type == "cpu":
        return ln_proj_tail_reference(x, ln_scale, ln_bias, proj, proj_bias, eps)
    out = _launch_tail(x, ln_scale, ln_bias, proj, False, proj_bias, eps)
    ln_proj_tail_kernel.launches += 1
    return out


ln_proj_tail_kernel.launches = 0


def ln_proj_tail_fma(x: Tensor, ln_scale: Tensor, ln_bias: Tensor,
                     proj: Tensor) -> tuple[Tensor, Tensor]:
    """The FMA kernel on CUDA tensors of either type: the tail of both types
    before the wgmma kernels, kept callable so that a run can time the
    designs side by side. No path of the package calls it."""
    _build.check_forward_only(x, ln_scale, ln_bias, proj)
    return _launch_tail(x, ln_scale, ln_bias, proj, fma=True)


class _TailFn(torch.autograd.Function):
    """Forward: the kernel (saving only its inputs); backward: the
    gradients of `ln_proj_tail_reference` recomputed under autograd, as
    `_tail_fused`'s VJP takes them from `_tail_xla`."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, proj, proj_bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_scale, ln_bias, proj, proj_bias)
        return ln_proj_tail_kernel(x, ln_scale, ln_bias, proj, proj_bias, eps)

    @staticmethod
    def backward(ctx, gy, gp):
        grads = recompute_grads(lambda *ins: ln_proj_tail_reference(*ins, eps=ctx.eps),
                                ctx.saved_tensors, (gy, gp))
        return (*grads, None)


def ln_proj_tail(x: Tensor, ln_params: dict, proj: Tensor, proj_bias: Optional[Tensor] = None,
                 eps: float = 1e-5) -> tuple[Tensor, Tensor]:
    """(B, D) CLS rows -> (ln(x), ln(x) @ proj [+ proj_bias]): the kernel
    where `_build.kernel_impl` selects kernels (always through `_TailFn`,
    which builds no graph when no input needs grad), else the plain
    composition. eps: the LayerNorm's epsilon."""
    args = (x, ln_params["scale"], ln_params["bias"], proj, proj_bias)
    if _build.use_kernels(x):
        return _TailFn.apply(*args, eps)
    return ln_proj_tail_reference(*args, eps)
