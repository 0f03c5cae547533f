"""Build the hand-written CUDA kernels in `csrc/` and bind them with ctypes.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface under `build/kernels/` at the repository
root, the first time a kernel of that file is launched (or when `build()` is
called, which starts one `nvcc` per source, all at once). The library name
carries a digest of the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing here runs at import time: the CPU
tests import every module on a machine without `nvcc`.

Every C entry point takes device pointers and the CUDA stream as `void*`
(ctypes would otherwise pass them as 32-bit ints) and returns
`cudaGetLastError()`; `check()` raises on anything but 0.

The rules of where a kernel runs live here too: `kernel_impl` (the one policy
every dispatcher reads, `use_kernels`), `check_forward_only` and
`require_cuda`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# library name -> source file in csrc/
SOURCES = {"block": "block_kernels.cu", "tail": "tail_kernel.cu",
           "minsum": "minsum_kernel.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures (argtypes) of each library's entry points
SIGNATURES = {
    "block": {
        # x, plane, pmask, ln_g, ln_b, w, bias, rope, out, M, N, K, S, act, rope_cols, eps,
        # dtype, stream
        "ln_gemm": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
        # a, ln_g, ln_b, w, bias, res, plane, pmask, out, M, N, K, S, eps, dtype, stream
        "gemm_bias_residual": [_P] * 9 + [_I] * 4 + [_F, _I, _P],
        # x, plane, pmask, ln_g, ln_b, out, M, K, S, n_real, eps, stream
        "ln_rows": [_P] * 6 + [_I] * 4 + [_F, _P],
        # q, k, v, ld, mask, out, lse, B, S, H, scale, fast, dtype, stream
        "mha_core": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3 + [_F] + [_I] * 2 + [_P],
        # q, k, v, ld, o, dout, ld_o, lse, mask, delta, dq, dk, dv, ld_out, B, S, H, scale,
        # stream
        "mha_core_backward": [_P] * 3 + [_I] + [_P] * 2 + [_I] + [_P] * 6 + [_I] * 4 + [_F, _P],
        # a, w, bias, res, out, out2, M, N, K, splits, mode, stream
        "gemm_tf32x3_backward": [_P] * 6 + [_I] * 5 + [_P],
    },
    "tail": {
        # x, ln_g, ln_b, proj, bias, y, p, B, D, E, eps, dtype, fma, stream
        "ln_proj_tail": [_P] * 7 + [_I] * 3 + [_F, _I, _I, _P],
    },
    "minsum": {
        # a, a_scale, b, b_scale, out, Na, Nb, C, operand dtype, stream
        "minsum": [_P] * 5 + [_I] * 4 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}

# the `dtype` argument of the block and tail entry points (minsum has its
# own operand codes, ops/minsum.py::OPERAND_CODES)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where library `name` is built: the name carries a digest of its
    source, the shared headers and the flags."""
    h = hashlib.sha1((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, one
    `nvcc` per source, all started together. Returns the seconds each build
    took (0.0 for a library already built). Raises with the compiler's
    output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{SOURCES[name]} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text()[-8000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_forward_only(*tensors: Optional[torch.Tensor]) -> None:
    """The kernel wrappers refuse inputs that require grad: training reaches
    the kernels only through the autograd Functions of ops/fused_attention.py
    and ops/fused_tail.py, which carry the gradients."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "the block and tail kernels are forward-only: call them under "
            "torch.no_grad(), or through residual_block / ln_proj_tail, whose "
            "autograd Functions take the backward"
        )


def require_cuda(dtype: torch.dtype, device: torch.device,
                 **tensors: Optional[torch.Tensor]) -> None:
    """The kernels take contiguous tensors of one dtype on one CUDA device."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")


_KERNEL_IMPL = "auto"  # "auto" | "kernel" | "plain"


def set_kernel_impl(impl: str) -> None:
    """Select how blocks, the tail, the attention core and minsum run:
      * "kernel" — the hand-written CUDA kernels; their wrappers take the
        plain versions on CPU tensors,
      * "plain" — the plain PyTorch versions (the parity path),
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


def use_kernels(x: torch.Tensor) -> bool:
    """Whether the kernel path takes x, as `kernel_impl` selects."""
    if _KERNEL_IMPL == "auto":
        return x.is_cuda
    return _KERNEL_IMPL == "kernel"
