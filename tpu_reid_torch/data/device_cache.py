"""Device-resident training-image cache (the port of
tpu_reid/data/device_cache.py, one device).

A ReID train split is small beside the card (Market-1501: 12,936 images x
256x128x3 uint8 = 1.27 GB; VeRi-776: 37,778 x 256x256x3 = 7.43 GB), so it
is decoded and resized once on the host and kept on the device as one
(N, H, W, 3) uint8 tensor. Every epoch's batches are then an index gather
on the device feeding the train transform: no decode and no host-to-device
image copy in the epoch loop, and a step's only host inputs are an index
row and its metadata (train/trainer.run_stage2_cached and friends).

The upload goes through the port's BatchLoader in sequential order, in
chunks of 256 images, each copied from pinned memory into its rows of a
tensor allocated once at full size: the JAX package concatenates the
chunks, which holds the split twice at the peak. On the CPU the same class
keeps the split in host memory.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from tpu_reid_torch.device import DeviceLike, resolve_device


class DeviceImageCache:
    """Upload a record list's images once; serve index-gather batches.

    `gather(idx)` is bit-identical to the rows BatchLoader yields for the
    same records: the same host decode and resize ran at build time.
    """

    def __init__(
        self,
        records: Sequence,
        size_hw,
        chunk: int = 256,
        mesh=None,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise NotImplementedError("a device cache sharded over a mesh is not ported yet "
                                      "(ROADMAP.md queue 1 item 7)")
        from tpu_reid_torch.data.loader import BatchLoader

        self.device = resolve_device(device)
        self.n = len(records)
        self.size_hw = tuple(size_hw)
        self.pids = np.asarray([r[1] for r in records], np.int32)
        self.camids = np.asarray([r[2] for r in records], np.int32)
        h, w = self.size_hw
        self.images = torch.empty((self.n, h, w, 3), dtype=torch.uint8, device=self.device)
        cuda = self.device.type == "cuda"
        done = 0
        for b in BatchLoader(records, chunk, self.size_hw):  # sequential order
            k = b.n_valid
            part = torch.from_numpy(np.ascontiguousarray(b.images[:k]))
            if cuda:  # pinned, so the copy runs while the loader decodes the next chunk
                part = part.pin_memory()
            self.images[done:done + k].copy_(part, non_blocking=cuda)
            done += k
        if done != self.n:
            raise RuntimeError(f"device cache: staged {done} of {self.n} images")
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def nbytes(self) -> int:
        h, w = self.size_hw
        return self.n * h * w * 3

    def gather(self, idx) -> torch.Tensor:
        """(B,) indices (numpy or a tensor) -> (B, H, W, 3) uint8 on the
        cache's device."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.asarray(idx, np.int64))
        return self.images.index_select(0, idx.to(self.device, torch.long))

    def epoch_index_batches(
        self, order, batch_size: int, drop_tail: bool = False
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (idx, pids, camids, valid) per batch for an epoch order.

        `order`: an iterable of index arrays (PKSampler.epoch()) or a flat
        index array; the tail batch is zero-padded with valid=False rows
        (zeroed pids and camids), BatchLoader's fixed-shape contract, or
        dropped with drop_tail.
        """
        if hasattr(order, "__iter__") and not isinstance(order, np.ndarray):
            flat = np.concatenate([np.asarray(o) for o in order])
        else:
            flat = np.asarray(order)
        b = batch_size
        for lo in range(0, len(flat), b):
            sel = flat[lo: lo + b].astype(np.int32)
            if len(sel) < b:
                if drop_tail:
                    return
                pad = np.zeros((b - len(sel),), np.int32)
                valid = np.concatenate([np.ones(len(sel), bool), np.zeros(len(pad), bool)])
                sel = np.concatenate([sel, pad])
            else:
                valid = np.ones((b,), bool)
            # padded rows gather row 0; every loss masks them by `valid`
            pids = np.where(valid, self.pids[sel], 0).astype(np.int32)
            camids = np.where(valid, self.camids[sel], 0).astype(np.int32)
            yield sel, pids, camids, valid
