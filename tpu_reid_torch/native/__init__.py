"""Native (C++) image decoding: build on first use, bind with ctypes (the
port's counterpart of tpu_reid/native).

`decode_resize_batch(paths, size_hw)` decodes JPEGs and resizes them
(PIL-compatible antialiased bicubic) into one (N, H, W, 3) uint8 batch with
a C++ thread pool (libjpeg); `DecodePool` keeps such a pool alive between
batches; `decode_jpeg(path)` decodes one image. The source is `loader.cc`
beside this file, a copy of the JAX package's, so both decode to the same
pixels. It is compiled with g++ (`-O3 ... -ljpeg -lpthread`) the first time
it is needed, into `build/native/` at the repository root, under a name that
carries a digest of the source and the flags (an edited source is rebuilt);
the build writes a temporary file and renames it, so concurrent processes
never load a half-written library. Nothing is built at import time.

Without g++ or libjpeg the build fails: `available()` is then False (and
stays so for the process) and every entry point raises `NativeUnavailable`.
`data/loader.BatchLoader(backend="auto")` then decodes with PIL, as the JAX
package's does; `backend="native"` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libreid_loader_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        raise NativeUnavailable(f"native loader build failed: {getattr(e, 'stderr', e)}")
    finally:
        tmp.unlink(missing_ok=True)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    paths_t = ctypes.POINTER(ctypes.c_char_p)
    lib.reid_decode_resize_batch.restype = ctypes.c_int
    lib.reid_decode_resize_batch.argtypes = [paths_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             u8p, ctypes.c_int]
    lib.reid_decode_jpeg.restype = ctypes.c_long
    lib.reid_decode_jpeg.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.reid_pool_create.restype = ctypes.c_void_p
    lib.reid_pool_create.argtypes = [ctypes.c_int]
    lib.reid_pool_run.restype = ctypes.c_int
    lib.reid_pool_run.argtypes = [ctypes.c_void_p, paths_t, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, u8p]
    lib.reid_pool_destroy.restype = None
    lib.reid_pool_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            target = library_path()
            try:
                if not target.exists():
                    _build(target)
                _lib = _bind(target)
            except (NativeUnavailable, OSError) as e:
                _error = str(e)
        if _lib is None:
            raise NativeUnavailable(_error)
        return _lib


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(max(os.cpu_count() or 8, 1), 16)


def _out(n: int, size_hw, out: Optional[np.ndarray]) -> np.ndarray:
    h, w = size_hw
    if out is None:
        return np.zeros((n, h, w, 3), np.uint8)
    if out.shape != (n, h, w, 3) or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {(n, h, w, 3)}, got "
                         f"{out.dtype} {out.shape}")
    return out


def _c_paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _check_failures(failures: int, paths: Sequence[str]) -> None:
    if failures == len(paths) and paths:
        raise ValueError(f"all {len(paths)} JPEG decodes failed (first: {paths[0]})")


def decode_resize_batch(paths: Sequence[str], size_hw: Tuple[int, int],
                        out: Optional[np.ndarray] = None, n_threads: int = 0) -> np.ndarray:
    """Decode and resize JPEGs into (N, H, W, 3) uint8 on a pool of
    `n_threads` threads started for this call. A failed decode leaves its
    row zero; ValueError if every decode failed."""
    lib = _load()
    out = _out(len(paths), size_hw, out)
    failures = lib.reid_decode_resize_batch(
        _c_paths(paths), len(paths), size_hw[0], size_hw[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _threads(n_threads))
    _check_failures(failures, paths)
    return out


class DecodePool:
    """A native worker pool that lives across batches (BatchLoader keeps
    one for its lifetime): `run` is `decode_resize_batch` without starting
    threads per call."""

    def __init__(self, n_threads: int = 0):
        self._lib = _load()
        self._pool = self._lib.reid_pool_create(_threads(n_threads))

    def run(self, paths: Sequence[str], size_hw: Tuple[int, int],
            out: Optional[np.ndarray] = None) -> np.ndarray:
        if not self._pool:
            raise RuntimeError("the decode pool is closed")
        out = _out(len(paths), size_hw, out)
        failures = self._lib.reid_pool_run(self._pool, _c_paths(paths), len(paths), size_hw[0],
                                           size_hw[1],
                                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        _check_failures(failures, paths)
        return out

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.reid_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()


def decode_jpeg(path: str) -> np.ndarray:
    """Decode one JPEG to (H, W, 3) uint8 (at most 32 MB of pixels)."""
    lib = _load()
    w, h = ctypes.c_int(), ctypes.c_int()
    buf = np.zeros(32 * 1024 * 1024, np.uint8)
    got = lib.reid_decode_jpeg(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                               buf.size, ctypes.byref(w), ctypes.byref(h))
    if got <= 0:
        raise ValueError(f"decode failed for {path}")
    return buf[:got].reshape(h.value, w.value, 3).copy()
