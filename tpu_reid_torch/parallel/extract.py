"""Gallery/query embedding extraction.

The step runs preprocessing, the encoder and flip-TTA on the device and
leaves the features there for the retrieval tail. Over a "data" mesh
(parallel/mesh.py) every rank runs the whole step on its rows of each global
batch with its own copy of the parameters, and the features are gathered
once at the end into global batch order (the counterpart of the JAX
package's shard_map sweep).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.device import DeviceLike, resolve_device, to_device
from tpu_reid_torch.parallel.mesh import all_gather_rows, shard_batch
from tpu_reid_torch.runtime.guard import StepWatchdog
from tpu_reid_torch.runtime.observe import span

Tensor = torch.Tensor


def _embed(embed_fn, pre, params, images_u8, flip_tta, dtype, cv=()):
    with span("reid.embed.preprocess"):
        x = pre(images_u8).to(dtype)
    feats = embed_fn(params, x, *cv)
    if flip_tta:
        with span("reid.embed.preprocess"):
            flipped = x.flip(2)
        feats = (feats + embed_fn(params, flipped, *cv)) * 0.5
    return feats.float()


def make_extractor(
    embed_fn: Callable[..., Tensor],
    preprocess: DevicePreprocess,
    flip_tta: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    with_cv_ids: bool = False,
    fold=None,
    device: DeviceLike = None,
    mesh=None,
):
    """Build a step: uint8 images -> (B, E) fp32 embeddings on `device`
    (CUDA unless device="cpu"; the mesh's device when `mesh` is given: the
    step then embeds whatever rows of a batch this rank is handed, and
    extract_embeddings(mesh=) hands it its share).

    embed_fn(params, images_normalized) -> (B, E); with flip_tta the plain
    and flipped passes are averaged (the mean, not the sum: in mm mode the
    two halves of the embedding have independent scales).

    with_cv_ids=True: the step takes (params, images_u8, cv_ids) and
    embed_fn takes (params, x, cv_ids) — the SIE camera-embedding path (the
    flipped pass keeps the same camera ids).

    fold: optional params -> params transform that folds the input
    normalization into the patch-embed weights (e.g. a wrapper of
    models.vit.fold_visual_input_norm). When given, the step applies it and
    feeds RAW-scale images — the normalization pass disappears (exact)."""
    dev = mesh.device if mesh is not None else resolve_device(device)

    @torch.no_grad()
    def step(params, images_u8, *cv):
        if len(cv) != int(with_cv_ids):
            raise TypeError(f"step takes {int(with_cv_ids)} camera-id argument(s), "
                            f"got {len(cv)}")
        images_u8 = torch.as_tensor(images_u8).to(dev)
        cv = tuple(torch.as_tensor(c).to(dev) for c in cv)
        pre = preprocess.eval_batch
        if fold is not None:
            with span("reid.embed.preprocess"):
                params = fold(params)
            pre = preprocess.eval_batch_raw
        return _embed(embed_fn, pre, params, images_u8, flip_tta, dtype, cv)

    return step


def make_scan_extractor(
    embed_fn: Callable[..., Tensor],
    preprocess: DevicePreprocess,
    flip_tta: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    fold=None,
    device: DeviceLike = None,
):
    """Multi-batch extractor: fn(params, images_u8) with images_u8
    (K, B, H, W, 3) -> (K, B, E). A plain loop over the K batches with the
    semantics of make_extractor's step; the fold is applied once."""
    dev = resolve_device(device)

    @torch.no_grad()
    def scan_fn(params, images_kb):
        images_kb = torch.as_tensor(images_kb).to(dev)
        pre = preprocess.eval_batch
        if fold is not None:
            with span("reid.embed.preprocess"):
                params = fold(params)
            pre = preprocess.eval_batch_raw
        return torch.stack([
            _embed(embed_fn, pre, params, images_kb[k], flip_tta, dtype)
            for k in range(images_kb.shape[0])
        ])

    return scan_fn


def global_batch_order(mesh, local: Tensor, n_batches: int) -> Tensor:
    """Every rank's rows of `n_batches` equal batches (`local`: this rank's
    rows of each, batch after batch) -> the global batches in order, on
    every rank (one all-gather)."""
    every = all_gather_rows(mesh, local)  # rank-major
    per = local.shape[0] // n_batches
    return (every.reshape(mesh.size, n_batches, per, *local.shape[1:]).transpose(0, 1)
            .reshape(mesh.size * local.shape[0], *local.shape[1:]))


def extract_embeddings(
    extractor,
    params: dict,
    batches: Iterable,
    cv_ids_of=None,
    device: DeviceLike = None,
    hang_timeout_s: float = 600.0,
    on_hang=None,
    mesh=None,
) -> Tuple[Tensor, np.ndarray, np.ndarray, np.ndarray]:
    """Sweep batches; returns (features_on_device, pids, camids, seqids).

    batches yield objects with .images (B, H, W, 3) uint8 (fixed B), .pids,
    .camids, .seqids, .valid. Features stay on `device` (CUDA unless
    device="cpu"); metadata stays on the host. cv_ids_of(batch) -> (B,) int
    ids feeds the extractor's third argument (pair with
    make_extractor(with_cv_ids=True)).

    Each batch is a span `reid.extract.batch` (its index and rows) holding
    the spans of its upload, its extractor call, the wait on the previous
    batch and the pull of the next batch from `batches` (runtime/observe).

    hang_timeout_s / on_hang: a runtime.guard.StepWatchdog guards the wait
    for each batch's device work. A CUDA launch returns before the device
    has run it, so a CUDA event is recorded after each batch and the
    watchdog is armed around the wait on the previous batch's event (and
    the last one's at the end): the device time is covered while one batch
    stays queued behind the one being waited for. On the CPU the
    extractor call itself is the device work and is what is guarded. One
    watchdog is re-armed for every wait (no thread per batch).

    mesh: every rank sweeps the same global batches and embeds its
    contiguous rows of each (the batch size must divide by the world
    size); one all-gather at the end puts the features of every rank, in
    global batch order, on every rank, and the valid masks then drop the
    padded tail rows as on one device. The watchdog guards each rank's
    waits."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    params = to_device(params, dev)  # moved once, not per batch
    cuda = dev.type == "cuda"
    watchdog = StepWatchdog(hang_timeout_s, on_hang=on_hang)
    feats, pids, camids, seqids, valids = [], [], [], [], []
    queued = None  # the previous batch's CUDA event
    place = (lambda x: x) if mesh is None else (lambda x: shard_batch(mesh, x))
    it = iter(batches)
    with span("reid.extract.next"):
        b = next(it, None)
    i = 0
    while b is not None:
        with span("reid.extract.batch", batch=i, rows=len(b.images)):
            with span("reid.extract.upload"):
                extra = (
                    (torch.as_tensor(place(np.asarray(cv_ids_of(b), np.int64)), device=dev),)
                    if cv_ids_of is not None else ()
                )
                images = torch.as_tensor(place(b.images)).to(dev)
            with span("reid.extract.embed"), contextlib.nullcontext() if cuda else watchdog:
                f = extractor(params, images, *extra)
            with span("reid.extract.wait"):
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                    if queued is not None:
                        with watchdog:
                            queued.synchronize()
                    queued = done
            valid = np.asarray(b.valid, bool)
            if mesh is not None:  # masked after the gather
                feats.append(f)
                valids.append(valid)
                pids.append(b.pids[valid])
                camids.append(b.camids[valid])
                seqids.append(b.seqids[valid])
            elif valid.all():
                feats.append(f)
                pids.append(b.pids)
                camids.append(b.camids)
                seqids.append(b.seqids)
            else:
                feats.append(f[torch.from_numpy(valid).to(f.device)])
                pids.append(b.pids[valid])
                camids.append(b.camids[valid])
                seqids.append(b.seqids[valid])
            with span("reid.extract.next"):
                b = next(it, None)
        i += 1
    if queued is not None:
        with span("reid.extract.wait"), watchdog:
            queued.synchronize()
    out = torch.cat(feats, dim=0)
    if mesh is not None:
        out = global_batch_order(mesh, out, len(feats))
        out = out[torch.from_numpy(np.concatenate(valids)).to(dev)]
    return (
        out,
        np.concatenate(pids),
        np.concatenate(camids),
        np.concatenate(seqids),
    )
