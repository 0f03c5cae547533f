"""PK identity sampler: batches of P identities x K instances (a copy of
tpu_reid/data/sampler.py: the same numpy Generator calls, so one seed gives
the same orders in both packages).

Behavioral contract (reference: data_prepare.py:16-76):
  * identities with fewer than K images are oversampled with replacement,
  * each identity's images are shuffled and chunked into K-sized groups,
  * batches draw P distinct identities at random until fewer than P remain
    with unconsumed groups (the epoch tail is dropped).

Differences from the reference: an explicit numpy Generator seed replaces
the global random module (reproducibility), and the sampler yields
whole index batches rather than a flat index stream.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, List, Sequence

import numpy as np


class PKSampler:
    def __init__(
        self,
        labels: Sequence[int],
        batch_size: int,
        num_instances: int = 4,
        seed: int = 0,
    ):
        assert batch_size % num_instances == 0, (
            f"batch {batch_size} not divisible by K={num_instances}"
        )
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.k = num_instances
        self.p = batch_size // num_instances
        self.rng = np.random.default_rng(seed)
        self.index_by_pid = defaultdict(list)
        for idx, pid in enumerate(self.labels):
            self.index_by_pid[int(pid)].append(idx)
        self.pids = sorted(self.index_by_pid)
        if len(self.pids) < self.p:
            raise ValueError(
                f"need >= {self.p} identities for P={self.p}, have {len(self.pids)}"
            )

    def epoch(self) -> Iterator[np.ndarray]:
        """Yield (batch_size,) int index arrays for one epoch."""
        groups = {}
        for pid in self.pids:
            idxs = np.array(self.index_by_pid[pid])
            if len(idxs) < self.k:
                idxs = self.rng.choice(idxs, size=self.k, replace=True)
            else:
                self.rng.shuffle(idxs)
            n_groups = len(idxs) // self.k
            groups[pid] = [
                idxs[i * self.k : (i + 1) * self.k] for i in range(n_groups)
            ]

        avail = [pid for pid in self.pids if groups[pid]]
        while len(avail) >= self.p:
            chosen = self.rng.choice(len(avail), size=self.p, replace=False)
            batch: List[np.ndarray] = []
            for pid in [avail[i] for i in sorted(chosen, reverse=True)]:
                batch.append(groups[pid].pop(0))
                if not groups[pid]:
                    avail.remove(pid)
            yield np.concatenate(batch)

    def batches_per_epoch(self) -> int:
        """Lower-bound estimate (identities with spare groups can extend it)."""
        total = 0
        for pid in self.pids:
            n = max(len(self.index_by_pid[pid]), self.k)
            total += n - n % self.k
        return total // self.batch_size
