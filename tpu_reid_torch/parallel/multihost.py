"""Multi-host embedding extraction (the port of tpu_reid/parallel/multihost.py).

Every host runs the same command with `--multihost HOST:PORT --num_hosts H
--host_id h`; the ranks of all hosts form one "data" mesh. The JAX package's
`init_distributed` is `parallel/launch.run` here (the TCP rendezvous; host
h's local rank l is global rank h * L + l), and a port mesh spans hosts as
it is, so `mesh.replicate` and `mesh.shard_batch` serve where the JAX
package has `replicate_multihost` and `shard_batch_multihost`. The
extraction sweep scales with the ranks: each rank decodes only ITS rows of
every global batch (`host_slice_records`), embeds them with its own copy of
the parameters, and one all-gather at the end leaves every rank with the
same features on its device, so the retrieval tail runs identically on
each. It is the CLIs' sweep under any mesh, one host or several.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_reid_torch.parallel.extract import global_batch_order


def host_slice_records(
    records: Sequence,
    global_batch: int,
    process_id: int,
    process_count: int,
) -> Tuple[list, int, int]:
    """This rank's record stream for a lock-step global sweep.

    The global order is `records` padded (wrap-around) to a whole number of
    global batches; batch i covers rows [i*B, (i+1)*B) and rank p owns the
    contiguous sub-slice [p*B/P, (p+1)*B/P) of each. Concatenating rank p's
    sub-slices gives a list that a plain BatchLoader(batch_size=B/P) walks
    in the right order.

    Returns (host_records, n_valid_total, n_batches); the padded rows are
    the global rows [n_valid_total:], dropped after the sweep."""
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} must divide by process count "
                         f"{process_count}")
    if not records:
        raise ValueError("empty record list")
    per_host = global_batch // process_count
    n = len(records)
    n_batches = -(-n // global_batch)
    padded = list(records)
    while len(padded) < n_batches * global_batch:
        padded.extend(records[: n_batches * global_batch - len(padded)])
    host_records = []
    for i in range(n_batches):
        base = i * global_batch + process_id * per_host
        host_records.extend(padded[base: base + per_host])
    return host_records, n, n_batches


def extract_embeddings_multihost(
    extractor,
    params: dict,
    records: Sequence,
    global_batch: int,
    size_hw,
    mesh,
    hang_timeout_s: float = 600.0,
    on_hang=None,
    loader_kwargs: Optional[dict] = None,
    cv_ids_of=None,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, np.ndarray]:
    """Lock-step multi-rank sweep; returns (features on the mesh's device,
    pids, camids, seqids as host numpy), identical on every rank.

    extractor: a make_extractor(..., mesh=mesh) step. Each rank decodes only
    its slice of every global batch (host_slice_records, wrap-around padding:
    every batch is full); features are all-gathered once at the end.
    cv_ids_of(batch) -> (B_local,) ids feeds the extractor's third argument
    (the SIE path)."""
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.device import to_device
    from tpu_reid_torch.runtime.guard import StepWatchdog

    host_records, n_valid, n_batches = host_slice_records(records, global_batch, mesh.rank,
                                                          mesh.size)
    dev = mesh.device
    params = to_device(params, dev)
    watchdog = StepWatchdog(hang_timeout_s, on_hang=on_hang)
    cuda = dev.type == "cuda"
    feats, queued = [], None  # queued: the previous batch's CUDA event
    for b in BatchLoader(host_records, global_batch // mesh.size, size_hw,
                         **(loader_kwargs or {})):
        extra = ((torch.as_tensor(np.asarray(cv_ids_of(b), np.int64), device=dev),)
                 if cv_ids_of is not None else ())
        # the watchdog as in extract_embeddings: around the wait on the
        # previous batch on CUDA, around the call on the CPU
        with contextlib.nullcontext() if cuda else watchdog:
            feats.append(extractor(params, torch.as_tensor(b.images).to(dev), *extra))
        if cuda:
            done = torch.cuda.Event()
            done.record()
            if queued is not None:
                with watchdog:
                    queued.synchronize()
            queued = done
    if queued is not None:
        with watchdog:
            queued.synchronize()
    if len(feats) != n_batches:
        raise RuntimeError(f"swept {len(feats)} batches, expected {n_batches}")
    all_feats = global_batch_order(mesh, torch.cat(feats), n_batches)[:n_valid]
    # metadata comes from the (globally known) record list, not the sweep
    meta = np.asarray([r[1:5] for r in records], np.int64).T
    return all_feats, meta[0], meta[1], meta[2]
