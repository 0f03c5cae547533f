"""Batched, prefetching data loader (the port of tpu_reid/data/loader.py).

The host decodes and resizes crops while the device computes the previous
batch; the device finishes preprocessing (normalize) in the extraction
step. Batches are fixed-shape: the final partial batch is zero-padded and
carries a validity mask.

Decoders, as in the JAX package: the native C++ pool (tpu_reid_torch/native,
the same source as the JAX package's) or PIL bicubic on a thread pool.
backend="auto" (the default) takes the native one when it builds and there
is no host transform, PIL otherwise; "native" raises NativeUnavailable when
the library cannot be built; "pil" always decodes with PIL.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from tpu_reid_torch.data.datasets import Record


@dataclasses.dataclass
class Batch:
    images: np.ndarray  # (B, H, W, 3) uint8 or float32
    pids: np.ndarray  # (B,) int32
    camids: np.ndarray  # (B,) int32
    seqids: np.ndarray  # (B,) int32
    idxs: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) bool — False for zero-padded tail entries

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


def _decode_resize(path: str, size_hw) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size_hw[1], size_hw[0]), Image.BICUBIC)
        return np.asarray(im, np.uint8)


class BatchLoader:
    """Iterate fixed-shape batches over a record list.

    order: None (sequential), "shuffle", or an iterable of index arrays.
    transform: optional per-image host transform (receives the decoded uint8
    (h, w, 3) array, returns float32); when None, batches carry uint8 and
    the device step normalizes. backend: "auto" | "native" | "pil" (module
    docstring)."""

    def __init__(
        self,
        records: Sequence[Record],
        batch_size: int,
        size_hw,
        order=None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        drop_tail: bool = False,
        backend: str = "auto",
    ):
        if backend not in ("auto", "native", "pil"):
            raise ValueError(f"backend must be 'auto', 'native' or 'pil': {backend!r}")
        self._native = False
        self._native_pool = None
        if transform is None and backend in ("auto", "native"):
            from tpu_reid_torch import native

            if native.available():
                self._native = True
            elif backend == "native":
                raise native.NativeUnavailable("the native loader was asked for and does not "
                                               "build here")
        self.records = list(records)
        self.batch_size = batch_size
        self.size_hw = tuple(size_hw)
        self.order = order
        self.transform = transform
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.drop_tail = drop_tail

    def __len__(self) -> int:
        n = len(self.records)
        return n // self.batch_size if self.drop_tail else -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[np.ndarray]:
        if self.order is None or self.order == "shuffle":
            idx = np.arange(len(self.records))
            if self.order == "shuffle":
                self.rng.shuffle(idx)
            end = len(idx) - len(idx) % self.batch_size if self.drop_tail else len(idx)
            for i in range(0, end, self.batch_size):
                yield idx[i: i + self.batch_size]
        else:
            yield from self.order

    def _make_batch(self, pool: cf.ThreadPoolExecutor, idx: np.ndarray) -> Batch:
        b = self.batch_size
        h, w = self.size_hw
        dtype = np.uint8 if self.transform is None else np.float32
        images = np.zeros((b, h, w, 3), dtype)
        meta = np.zeros((4, b), np.int32)
        valid = np.zeros((b,), bool)

        if self._native:
            from tpu_reid_torch import native

            if self._native_pool is None:  # one persistent pool per loader
                self._native_pool = native.DecodePool(self.num_workers)
            self._native_pool.run([self.records[i][0] for i in idx], self.size_hw,
                                  out=images[: len(idx)])
            for slot, rec_i in enumerate(idx):
                meta[:, slot] = self.records[rec_i][1:5]
                valid[slot] = True
            return Batch(images, meta[0], meta[1], meta[2], meta[3], valid)

        def load(slot: int, rec_i: int):
            rec = self.records[rec_i]
            img = _decode_resize(rec[0], self.size_hw)
            if self.transform is not None:
                img = self.transform(img)
            images[slot] = img
            meta[:, slot] = rec[1:5]
            valid[slot] = True

        list(pool.map(load, range(len(idx)), idx))
        return Batch(images, meta[0], meta[1], meta[2], meta[3], valid)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for idx in self._index_batches():
                        if stop.is_set():
                            return
                        q.put(self._make_batch(pool, np.asarray(idx)))
                except BaseException as e:  # surface decode errors to the consumer
                    q.put(e)
                    return
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
