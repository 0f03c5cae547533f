"""CLS tail: ln_post + projection in one hand-written CUDA kernel.

Replaces tpu_reid/ops/fused_tail.py::_tail_pallas (the Pallas `_tail_kernel`):
for (B, D) CLS rows, y = LN(x) with fp32 statistics and an fp32 affine, cast
to x.dtype, and p = y @ proj with fp32 accumulation — both from one load of
x (csrc/tail_kernel.cu). The plain version `ln_proj_tail_reference` mirrors
the JAX package's `_tail_xla`, the plain layer_norm + dot composition. The
kernel wrapper is forward-only: an input that requires grad raises; the
model's tail goes through `_TailFn`, the counterpart of the JAX package's `_tail_fused`
custom VJP (forward through the kernel, backward through the plain
composition's recompute).
"""

from __future__ import annotations

import torch

from tpu_reid_torch.ops import _build
from tpu_reid_torch.ops.fused_attention import _layer_norm_f32

Tensor = torch.Tensor

MAX_WIDTH = 1024  # the kernel keeps 16 rows of D fp32 values in shared memory


def ln_proj_tail_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor,
                           proj: Tensor) -> tuple[Tensor, Tensor]:
    """(B, D) -> (LN(x), LN(x) @ proj), the product accumulated in fp32."""
    y = _layer_norm_f32(x, ln_scale, ln_bias)
    return y, (y.float() @ proj.to(y.dtype).float()).to(y.dtype)


def ln_proj_tail_kernel(x: Tensor, ln_scale: Tensor, ln_bias: Tensor,
                        proj: Tensor) -> tuple[Tensor, Tensor]:
    """CUDA: csrc/tail_kernel.cu::ln_proj_tail; CPU tensors take the plain
    version."""
    _build.check_forward_only(x, ln_scale, ln_bias, proj)
    if x.device.type == "cpu":
        return ln_proj_tail_reference(x, ln_scale, ln_bias, proj)
    b, d = x.shape
    e = proj.shape[1]
    if proj.shape != (d, e) or d > MAX_WIDTH:
        raise ValueError(f"ln_proj_tail: x {tuple(x.shape)}, proj {tuple(proj.shape)}; "
                         f"needs D <= {MAX_WIDTH}")
    x = x.contiguous()
    proj = proj.to(x.dtype).contiguous()
    g = ln_scale.float().contiguous()
    gb = ln_bias.float().contiguous()
    _build.require_cuda(x.dtype, x.device, x=x, proj=proj)
    y = torch.empty(b, d, dtype=x.dtype, device=x.device)
    p = torch.empty(b, e, dtype=x.dtype, device=x.device)
    lib = _build.library("tail")
    ptr = _build.ptr
    rc = lib.ln_proj_tail(ptr(x), ptr(g), ptr(gb), ptr(proj), ptr(y), ptr(p), b, d, e,
                          _build.DTYPE_CODES[x.dtype], _build.stream(x))
    _build.check(lib, rc, "ln_proj_tail")
    ln_proj_tail_kernel.launches += 1
    return y, p


ln_proj_tail_kernel.launches = 0


class _TailFn(torch.autograd.Function):
    """Forward: the kernel (saving only its four inputs); backward: the
    gradients of `ln_proj_tail_reference` recomputed under autograd, as
    `_tail_fused`'s VJP takes them from `_tail_xla`."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, proj):
        ctx.save_for_backward(x, ln_scale, ln_bias, proj)
        return ln_proj_tail_kernel(x, ln_scale, ln_bias, proj)

    @staticmethod
    def backward(ctx, gy, gp):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, p = ln_proj_tail_reference(*inputs)
            return torch.autograd.grad((y, p), inputs, (gy, gp), allow_unused=True)


def ln_proj_tail(x: Tensor, ln_params: dict, proj: Tensor) -> tuple[Tensor, Tensor]:
    """(B, D) CLS rows -> (ln(x), ln(x) @ proj): the kernel where
    `layers.kernel_impl` selects kernels (always through `_TailFn`, which
    builds no graph when no input needs grad), else the plain composition."""
    from tpu_reid_torch.models.layers import use_kernels

    args = (x, ln_params["scale"], ln_params["bias"], proj)
    if use_kernels(x):
        return _TailFn.apply(*args)
    return ln_proj_tail_reference(*args)
