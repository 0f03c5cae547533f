"""Min-sum contraction: ``t[i, j] = sum_c min(a[i, c] * sa[i], b[j, c] * sb[j])``.

The Jaccard numerator of k-reciprocal re-ranking. The operands are
row-quantized (fp8 e4m3fn, bf16 or fp32 values with one fp32 scale per row)
and the output is (Na, Nb) fp32.

  * `minsum_kernel` — the hand-written CUDA kernel (csrc/minsum_kernel.cu),
    which replaces tpu_reid/ops/minsum.py::minsum_tiled (the Pallas
    `_minsum_kernel`); CPU tensors take the plain version;
  * `minsum_reference` — the plain version, chunked over rows, columns and
    C so that no temporary exceeds `_CHUNK_ELEMS` fp32 values;
  * `minsum` — the dispatcher: the kernel where `_build.kernel_impl`
    selects kernels (CUDA tensors under "auto"), else the plain version.
"""

from __future__ import annotations

import torch

from tpu_reid_torch.ops import _build

Tensor = torch.Tensor

# the `dtype` argument of csrc/minsum_kernel.cu::minsum (its own codes)
OPERAND_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

_CHUNK_ELEMS = 1 << 25  # 128 MB of fp32 per broadcast-min temporary


def _dequantize(x: Tensor, scale: Tensor) -> Tensor:
    return x.float() * scale.float()[:, None]


def minsum_reference(a: Tensor, a_scale: Tensor, b: Tensor, b_scale: Tensor) -> Tensor:
    """(Na, Nb) fp32 min-sum by broadcast-min-reduce over (rows, cols, C)
    chunks; each chunk is dequantized when it is used."""
    na, c = a.shape
    nb = b.shape[0]
    out = torch.empty(na, nb, dtype=torch.float32, device=a.device)
    cc = max(1, min(c, 2048))
    cb = max(1, min(nb, 512))
    rb = max(1, min(na, _CHUNK_ELEMS // (cb * cc)))
    for j in range(0, nb, cb):
        bf = _dequantize(b[j: j + cb], b_scale[j: j + cb])
        for i in range(0, na, rb):
            af = _dequantize(a[i: i + rb], a_scale[i: i + rb])
            acc = torch.zeros(af.shape[0], bf.shape[0], dtype=torch.float32, device=a.device)
            for k in range(0, c, cc):
                acc += torch.minimum(af[:, None, k: k + cc], bf[None, :, k: k + cc]).sum(-1)
            out[i: i + rb, j: j + cb] = acc
    return out


def minsum_kernel(a: Tensor, a_scale: Tensor, b: Tensor, b_scale: Tensor) -> Tensor:
    """CUDA: csrc/minsum_kernel.cu::minsum; CPU tensors take the plain
    version. The operands must be contiguous (a multi-GB copy is never made
    here) and of one operand dtype."""
    if a.device.type == "cpu":
        return minsum_reference(a, a_scale, b, b_scale)
    na, c = a.shape
    nb = b.shape[0]
    if a.dtype not in OPERAND_CODES or b.dtype != a.dtype:
        raise TypeError(f"minsum takes float32, bfloat16 or float8_e4m3fn operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if b.shape != (nb, c) or a_scale.shape != (na,) or b_scale.shape != (nb,):
        raise ValueError(f"minsum: a {tuple(a.shape)}, b {tuple(b.shape)}, scales "
                         f"{tuple(a_scale.shape)}, {tuple(b_scale.shape)}")
    for name, t in (("a", a), ("b", b), ("a_scale", a_scale), ("b_scale", b_scale)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minsum operands must be contiguous")
    sa = a_scale.float().contiguous()
    sb = b_scale.float().contiguous()
    out = torch.empty(na, nb, dtype=torch.float32, device=a.device)
    if na == 0 or nb == 0:
        return out
    lib = _build.library("minsum")
    ptr = _build.ptr
    rc = lib.minsum(ptr(a), ptr(sa), ptr(b), ptr(sb), ptr(out), na, nb, c,
                    OPERAND_CODES[a.dtype], _build.stream(a))
    _build.check(lib, rc, "minsum")
    minsum_kernel.launches += 1
    return out


minsum_kernel.launches = 0


def minsum(a: Tensor, a_scale: Tensor, b: Tensor, b_scale: Tensor) -> Tensor:
    """(Na, Nb) fp32 min-sum: the kernel where `_build.kernel_impl` selects
    kernels (the JAX package's `use_pallas`), else the plain version."""
    if _build.use_kernels(a):
        return minsum_kernel(a, a_scale, b, b_scale)
    return minsum_reference(a, a_scale, b, b_scale)
