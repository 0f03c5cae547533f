"""Device-resident training-image cache (the port of
tpu_reid/data/device_cache.py).

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

Over a "data" mesh (parallel/mesh.py) rank r holds the contiguous rows
[r*N/n, (r+1)*N/n) of the split, zero-padded to divisibility, and decodes
only those. A gather then takes the GLOBAL index row of a batch (the same on
every rank) and returns this rank's rows of the batch: every rank sends the
rows of the batch it holds, in batch order, padded to the most rows any rank
holds (m, worked out on the host from the index row), one all-gather
exchanges them, and each rank picks its rows from their owners'. A rank
receives n x m rows, about the batch when the batch spreads evenly over the
split. The result is bit-identical to the single-device cache's rows.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from tpu_reid_torch.device import DeviceLike, resolve_device
from tpu_reid_torch.parallel.mesh import all_gather_rows, pad_to_multiple, require_mesh


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
        from tpu_reid_torch.data.loader import BatchLoader

        self.mesh = None if mesh is None else require_mesh(mesh)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.n = len(records)
        self.size_hw = tuple(size_hw)
        self.pids = np.asarray([r[1] for r in records], np.int32)
        self.camids = np.asarray([r[2] for r in records], np.int32)
        h, w = self.size_hw
        # this rank's rows [lo, lo + n_local) of the split (all of it
        # without a mesh); rows past the split stay zero
        self.n_local = self.n if mesh is None else pad_to_multiple(self.n, mesh.size) // mesh.size
        self.lo = 0 if mesh is None else mesh.rank * self.n_local
        mine = list(records[self.lo:self.lo + self.n_local])
        self.images = torch.zeros((self.n_local, h, w, 3), dtype=torch.uint8,
                                  device=self.device)
        cuda = self.device.type == "cuda"
        done = 0
        for b in BatchLoader(mine, chunk, self.size_hw):  # sequential order
            k = b.n_valid
            part = torch.from_numpy(np.ascontiguousarray(b.images[:k]))
            if cuda:  # pinned, so the copy runs while the loader decodes the next chunk
                part = part.pin_memory()
            self.images[done:done + k].copy_(part, non_blocking=cuda)
            done += k
        if done != len(mine):
            raise RuntimeError(f"device cache: staged {done} of {len(mine)} images")
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def nbytes(self) -> int:
        """Bytes held on this rank's device."""
        h, w = self.size_hw
        return self.n_local * h * w * 3

    def gather(self, idx) -> torch.Tensor:
        """(B,) indices (numpy or a tensor) -> (B, H, W, 3) uint8 on the
        cache's device; over a mesh, `idx` is the global batch's and the
        result this rank's rows of it (B must divide by the world size)."""
        if self.mesh is None:
            if not isinstance(idx, torch.Tensor):
                idx = torch.from_numpy(np.asarray(idx, np.int64))
            return self.images.index_select(0, idx.to(self.device, torch.long))
        idx = (idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
               ).astype(np.int64)
        owner = idx // self.n_local
        order = np.argsort(owner, kind="stable")  # positions grouped by owner
        counts = np.bincount(owner, minlength=self.mesh.size)
        starts = np.cumsum(counts) - counts
        slot = np.empty_like(owner)  # a position's row in its owner's message
        slot[order] = np.arange(len(owner)) - starts[owner[order]]
        r, m = self.mesh.rank, int(counts.max())
        held = torch.from_numpy(idx[order[starts[r]:starts[r] + counts[r]]] - self.lo)
        send = torch.zeros((m, *self.images.shape[1:]), dtype=torch.uint8, device=self.device)
        send[:counts[r]] = self.images.index_select(0, held.to(self.device))
        every = all_gather_rows(self.mesh, send).view(self.mesh.size, *send.shape)
        s, e = self.mesh.row_range(len(idx))
        return every[torch.from_numpy(owner[s:e]).to(self.device),
                     torch.from_numpy(slot[s:e]).to(self.device)]

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
