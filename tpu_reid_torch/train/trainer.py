"""Two-stage prompt-learning trainers (the port of tpu_reid/train/trainer.py).

Stage 1 — learn text prompts:
  * coop/adapter: image features are computed ONCE with the frozen encoder,
    then every step runs only the text side against the cached features,
  * ivlp/promptsrc/maple: the prompt tokens change the image encoder, so
    image features are computed live each step,
  * loss = SupCon(i2t) + SupCon(t2i), Adam lr 3.5e-4 wd 1e-4, cosine
    schedule with 5-epoch warmup; promptsrc keeps a gaussian-weighted
    parameter average (GPA mu=60 sigma=45).

Stage 2 — fine-tune the image tower:
  * text features for all classes computed once with frozen prompts,
  * loss = 0.25*smoothCE(id logits) per head + smoothCE(proj @ text.T)
    + triplet(margin 0.3) on all three feature levels (four with JPM, whose
    BNNeck and ID head join), the triplet gated on Σvalid >= 4 (+ SmoothL1
    against the frozen teacher for promptsrc),
  * Adam lr 5e-6 (bias x2) wd 1e-4, WarmupMultiStepLR([30, 50], warmup 10),
  * the BNNeck running statistics (JPM's too) threaded as state through
    `frozen`,
  * GPA mu=30 sigma=30 for promptsrc (swapped in at the end of training).

A step takes (trainable, frozen) trees: the trainable leaves are fp32
master tensors that require grad, updated in place by torch.optim.Adam; the
input parameter dict is not modified. A batch may carry a 4th element, the
SIE camera/view ids of its images. On CUDA every block of both towers
runs forward through the hand-written kernels and backward through a
recompute of the block (in fp32 with its gradient products on the kernels;
models/layers.residual_block). Epoch loops read the
loss on the host one step late (`LossPipeline`), so the card is not
synchronised every step.

Mid-stage resume: both runners take start_epoch / init_opt_state (the
optimizer's saved state dict) / init_gpa, and their checkpoint_cb hands over
{"optimizer", "opt_paths", "gpa"} after every epoch
(runtime/checkpoint.two_stage_cb). The live paths and stage 2 draw each
epoch's batches on their own, so a resumed run follows the uninterrupted
one exactly; the cached coop/adapter path draws every epoch's permutation
from one generator seeded at the start of run_stage1, so a resumed run
starts that stream again, as in the JAX package.

Input: the host loops (the live stage 1, stage 2) take their batches
through parallel/prefetch.device_prefetch, `depth` batches ahead on a worker
thread and, on CUDA, a copy stream (synchronously under a mesh:
`_prefetch`). The device-resident paths serve every
batch from a data/device_cache.DeviceImageCache (`run_stage2_cached`,
`run_stage1_live_cached`) or from the precomputed features (the cached
coop/adapter stage 1): a step's host inputs are then an index row, its
labels and its valid mask, and on CUDA the whole step (gather, transform,
forward through the kernels, backward, Adam) is one CUDA graph replayed
per batch (train/step_graph.py); on the CPU the same step runs eagerly.
`chunk` is the number of steps whose index rows go to the card in one
pinned copy; results do not depend on it.

State is updated and rolled back in place on every path: Adam's state is
made with the optimizer (in its capturable mode on CUDA, the host loops
too, so that both do the same arithmetic), the BN statistics are written
with copy_, and the
guard (runtime/guard.TrainGuard) writes a snapshot back into the live
tensors, since a graph reads fixed addresses. The guard stays per step on
the cached paths too: a non-finite loss rolls back to the last snapshot and
re-runs the step already queued, from the inputs already in its buffers
(the JAX package checks and replays a whole chunk instead).

Data parallelism (`mesh=`, a parallel/mesh.Mesh; one process per device):
a batch then carries this rank's rows of the images (and SIE ids) and the
GLOBAL labels and valid mask. Each rank encodes only its rows, through the
kernels and the block Function, and the features of every rank are gathered
(`sharded_encoder`), so the losses, the triplet mining, SupCon and the BNNeck
statistics see the global batch on every rank, as in the JAX package; the
text side of stage 1 is sharded the same way. The gradients are averaged
over the ranks (`parallel/mesh.all_reduce_grads`), so every rank applies the
single-device update of the global batch and the ranks' parameters and Adam
state stay identical; the guard's rollback decision is checked to agree on
every rank. On the device-resident paths a mesh runs every step eagerly, as
the JAX package runs its chunked paths only without a mesh: no CUDA graph
holds the collectives.

Spans (runtime/observe.span, recorded only under a profiler): every loop's
step is `reid.train.step` (its global step index), the pull of its input
`reid.train.next`; inside the step `reid.train.forward` (forward and
losses), `reid.train.backward` (`loss.backward()` and the zero fills),
`reid.train.optimizer` (the all-reduce, Adam, the BNNeck statistics) and
`reid.train.sync` (the host's read of the previous step's loss).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.models import reid_clip as M
from tpu_reid_torch.parallel.mesh import agree, all_reduce_grads, check_replicated, gathered, \
    require_mesh, shard_batch
from tpu_reid_torch.parallel.prefetch import StreamPlacer, device_prefetch
from tpu_reid_torch.runtime.observe import span
from tpu_reid_torch.train import losses as L
from tpu_reid_torch.train import optim as O
from tpu_reid_torch.train import schedules as S
from tpu_reid_torch.train.step_graph import StepGraph

Tensor = torch.Tensor
_END = object()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs_stage1: int = 120
    epochs_stage2: int = 60
    lr_stage1: float = 3.5e-4
    lr_stage2: float = 5e-6
    weight_decay: float = 1e-4
    triplet_margin: float = 0.3
    id_loss_weight: float = 0.25
    label_smooth_eps: float = 0.1
    gpa_stage1: Tuple[float, float] = (60.0, 45.0)
    gpa_stage2: Tuple[float, float] = (30.0, 30.0)


def _device_of(params: dict) -> torch.device:
    return params["clip"]["visual"]["conv"]["w"].device


def _as_tensor(x, dev: torch.device) -> Tensor:
    return torch.as_tensor(x, device=dev)


def _trainable_copy(tree):
    """Fresh fp32 master leaves that require grad (the caller's dict stays
    as it is)."""
    if isinstance(tree, dict):
        return {k: _trainable_copy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.detach().clone().requires_grad_(True)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return None if tree is None else tree.detach()


def _leaves(tree) -> list:
    return [t for _, t in O.paths(tree) if t is not None]


def _apply_grads(loss: Tensor, trainable: dict, optimizer: torch.optim.Optimizer,
                 mesh=None) -> None:
    """loss.backward() over the trainable leaves, a zero gradient for any
    leaf the loss does not reach (so Adam's coupled decay still moves it,
    as the JAX chain does), the gradients averaged over a mesh's ranks, then
    the Adam step."""
    leaves = _leaves(trainable)
    with span("reid.train.backward"):
        for t in leaves:
            t.grad = None
        loss.backward()
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
    with span("reid.train.optimizer"):
        if mesh is not None:
            all_reduce_grads(mesh, leaves)
        optimizer.step()


def sharded_encoder(cfg, mesh, fn):
    """fn(params, cfg, images, cv_ids) of this rank's rows -> the features
    of the global batch, gathered from every rank (the backward keeps this
    rank's share; parallel/mesh.gather_rows). The counterpart of the JAX
    package's shard_map encoder: the kernels run on each rank's rows."""
    return gathered(mesh, lambda params, _cfg, images, cv_ids=None: fn(params, cfg, images,
                                                                        cv_ids))


def _prefetch(batches: Iterable, placer, mesh):
    """device_prefetch of the host loops; synchronous (depth 0) under a
    mesh: a batch source may run collectives (a sharded cache's gather),
    and a worker thread would interleave them with the step's in another
    order on each rank."""
    if mesh is None:
        return device_prefetch(batches, placer)
    return device_prefetch(batches, placer, 0)


def _spanned_next(items: Iterable) -> Iterator:
    """`items` with each pull (the wait for the next prefetched batch) in a
    span `reid.train.next`."""
    it = iter(items)
    while True:
        with span("reid.train.next"):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def _check_start(mesh, params: dict, what: str) -> None:
    """Under a mesh, every rank must start from the same parameters."""
    if mesh is not None:
        check_replicated(require_mesh(mesh), params, f"{what}'s parameters")


def _step_runner(body, state, dev, name: str, mesh, log):
    """The device-resident paths' step: a CUDA graph (train/step_graph.py),
    or under a mesh the eager body (said in the log)."""
    if mesh is None:
        return StepGraph(body, state, dev, name=name)
    log(f"[{name}] over a {mesh.size}-rank mesh: every step runs eagerly, not as a CUDA "
        f"graph")
    return body


class LossPipeline:
    """Lag-1 loss resolution: step N's scalar loss is read on the host only
    after step N+1 has been queued, so reading it does not drain the card's
    queue every step.

    Guard semantics are kept exactly: before a snapshot step the pending
    loss is resolved first, so a snapshot never captures parameters whose
    producing step later turns out non-finite. On a rollback the
    already-queued next step (computed from the poisoned state) is redone
    from the restored state (`redo`), so the diverged batch is skipped and
    the next one consumed, as a synchronous loop would.

    get_state() -> tuple / set_state(tuple) close over the caller's live
    state."""

    def __init__(self, guard, get_state, set_state, mesh=None):
        self.guard = guard
        self.get_state = get_state
        self.set_state = set_state
        self.mesh = mesh
        self.losses: list = []
        self._pending = None

    def before_step(self, gstep: int):
        if self.guard is not None:
            if self._pending is not None and self.guard.will_snapshot(gstep):
                self._resolve()
            self.guard.maybe_snapshot(gstep, *self.get_state())

    def after_step(self, loss, redo=None):
        """Call right after queuing a step; `redo()` re-runs that step from
        the (possibly rolled-back) state and returns its loss."""
        if self._pending is not None and not self._resolve():
            loss = redo() if redo is not None else None
        self._pending = loss

    def _resolve(self) -> bool:
        with span("reid.train.sync"):
            lf = float(self._pending)
        self._pending = None
        if self.guard is not None and self.mesh is not None:
            agree(self.mesh, np.isfinite(lf), "the guard's rollback decision")
        if self.guard is not None:
            state, ok = self.guard.check(lf, *self.get_state())
            if not ok:
                self.set_state(state)
                return False
        self.losses.append(lf)
        return True

    def drain_epoch(self) -> list:
        """Resolve the in-flight loss and hand back (and reset) the epoch's
        losses."""
        if self._pending is not None:
            self._resolve()
        out = self.losses
        self.losses = []
        return out


def stage1_leaf_order(params: dict, cfg: M.ReidModelConfig) -> list:
    """The leaf order of run_stage1's optimizer (its saved state dict keys
    the moments by position; runtime/checkpoint checks it on restore)."""
    return O.leaf_order(O.partition(params, lambda p: M.stage1_trainable(p, cfg))[0])


def stage2_leaf_order(params: dict, cfg: M.ReidModelConfig) -> list:
    """The leaf order of run_stage2's optimizer."""
    return O.leaf_order(O.partition(params, lambda p: M.stage2_trainable(p, cfg))[0],
                        bias_lr_mult=2.0)


def _restore_into(live: dict, saved: dict) -> None:
    """Copy a snapshot's values into the live leaves in place (the optimizer
    holds references to them; leaves that already are the live ones are
    skipped)."""
    with torch.no_grad():
        for (_, t), (_, s) in zip(O.paths(live), O.paths(saved)):
            if t is not None and t is not s:
                t.copy_(s)


class _TrainState:
    """What a step updates: the trained leaves, Adam's state and, in stage
    2, the BN statistics. `get` / `set` are the loss pipeline's state
    callbacks, `set` writing in place; `tensors` lists them all for a
    step graph."""

    def __init__(self, trainable: dict, optimizer: torch.optim.Optimizer,
                 bn: Optional[dict] = None):
        self.trainable, self.optimizer, self.bn = trainable, optimizer, bn

    def get(self) -> tuple:
        opt = O.state_tensors(self.optimizer)
        if self.bn is None:
            return self.trainable, opt
        return self.trainable, self.bn, opt

    def set(self, state: tuple) -> None:
        _restore_into(self.trainable, state[0])
        if self.bn is not None:
            _restore_into(self.bn, state[1])
        O.restore_state(self.optimizer, state[-1])

    def tensors(self) -> list:
        out = _leaves(self.trainable) + ([] if self.bn is None else _leaves(self.bn))
        for st in O.state_tensors(self.optimizer)["state"]:
            out.extend(v for v in st.values() if isinstance(v, Tensor))
        return out


def _bn_state(frozen: dict, cfg: M.ReidModelConfig) -> Tuple[dict, dict]:
    """(frozen with its own copies of the BNNeck running statistics, a tree
    of just those statistics): stage 2 writes them in place, and the
    caller's parameter dict stays as it is."""
    frozen, stats = dict(frozen), {}
    for name in (("head", "jpm_head") if cfg.use_jpm else ("head",)):
        head = frozen[name] = dict(frozen[name])
        for bn in ("bn", "bn_proj"):
            if isinstance(head.get(bn), dict):
                head[bn] = dict(head[bn], mean=head[bn]["mean"].clone(),
                                var=head[bn]["var"].clone())
                stats.setdefault(name, {})[bn] = {k: head[bn][k] for k in ("mean", "var")}
    return frozen, stats


def _replay_epoch(rows: list, chunk: int, bufs: dict, run: StepGraph, pipe: "LossPipeline",
                  gstep: int, dev: torch.device, draw: Optional[Callable[[], dict]] = None
                  ) -> int:
    """One epoch of a device-resident path: rows are (sel, labels, valid)
    host arrays of one batch each. Every `chunk` rows go to the device in one
    pinned copy; then for each row, the augmentation draws (`draw()`, for
    every row in order, as the host loop makes them), and unless the row has
    no valid entry, its static buffers are written in place and the step
    runs through the loss pipeline (a redo runs it again on the same
    buffers). Returns the global step count."""
    for lo in range(0, len(rows), chunk):
        block = rows[lo:lo + chunk]
        with span("reid.train.next"):
            packed = torch.from_numpy(np.stack([np.stack([np.asarray(a, np.int64) for a in r])
                                                for r in block]))
            if dev.type == "cuda":
                packed = packed.pin_memory()
            packed = packed.to(dev, non_blocking=True)
        for j, (_sel, _labels, valid) in enumerate(block):
            draws = draw() if draw is not None else None
            if not np.asarray(valid).any():
                continue  # a step with no valid row is not run
            with span("reid.train.step", step=gstep):
                pipe.before_step(gstep)
                with torch.no_grad():
                    bufs["idx"].copy_(packed[j, 0])
                    bufs["labels"].copy_(packed[j, 1])
                    bufs["valid"].copy_(packed[j, 2])
                    if draws is not None:
                        if "draws" not in bufs:
                            bufs["draws"] = {k: torch.empty_like(t) for k, t in draws.items()}
                        for k, t in draws.items():
                            bufs["draws"][k].copy_(t)
                gstep += 1
                pipe.after_step(run(), redo=run)
    return gstep


def _static_buffers(bs: int, dev: torch.device) -> dict:
    """A step's static inputs: the index row, labels and valid mask (the
    augmentation draws join at the first draw)."""
    return {"idx": torch.zeros(bs, dtype=torch.long, device=dev),
            "labels": torch.zeros(bs, dtype=torch.long, device=dev),
            "valid": torch.zeros(bs, dtype=torch.bool, device=dev)}


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------


def stage1_loss(cfg: M.ReidModelConfig, params: dict, batch: dict, mesh=None) -> Tensor:
    """SupCon(i2t) + SupCon(t2i) of one stage-1 batch: with
    "image_features" (the cached path) or "images" (the live encoder, and
    "cv_ids" with SIE); batch["valid"] (B,) bool masks padded rows out of
    both directions. mesh: "images" / "cv_ids" are this rank's rows, the
    rest global; both encoders run on this rank's rows and gather."""
    labels = batch["labels"]
    valid = batch.get("valid")
    encode_image, encode_text = M.encode_image_features, M.encode_text_features
    if mesh is not None:
        encode_image = sharded_encoder(cfg, mesh, M.encode_image_features)
        encode_text = gathered(mesh, lambda p, c, lab: M.encode_text_features(
            p, c, shard_batch(mesh, lab)))
    if "image_features" in batch:
        image_features = batch["image_features"]
    else:
        image_features = encode_image(params, cfg, batch["images"], batch.get("cv_ids"))["proj"]
    text_features = encode_text(params, cfg, labels)
    loss = L.supcon_loss(image_features, text_features, labels, labels,
                         anchor_valid=valid, contrast_valid=valid)
    return loss + L.supcon_loss(text_features, image_features, labels, labels,
                                anchor_valid=valid, contrast_valid=valid)


def make_stage1_step(cfg: M.ReidModelConfig, optimizer: torch.optim.Optimizer, cached: bool,
                     mesh=None):
    """Stage-1 step(trainable, frozen, batch) -> loss (a 0-dim tensor, not
    read on the host). cached=True: the batch carries precomputed
    "image_features"; cached=False (ivlp/promptsrc): it carries "images" and
    the encoder runs live inside the step. mesh: see the module notes."""

    def step(trainable, frozen, batch):
        if cached != ("image_features" in batch):
            raise ValueError("a cached step takes image_features, a live step images")
        with span("reid.train.forward"):
            loss = stage1_loss(cfg, O.combine(trainable, frozen), batch, mesh)
        _apply_grads(loss, trainable, optimizer, mesh)
        return loss.detach()

    return step


@torch.no_grad()
def precompute_image_features(params: dict, cfg: M.ReidModelConfig,
                              batches: Iterable, mesh=None) -> Tuple[Tensor, Tensor]:
    """Frozen-encoder sweep caching the proj features for the coop/adapter
    stage 1; batches yield (images, labels, valid[, cv_ids]): camera ids go
    through the SIE embedding at its frozen initial values. Stays on the
    device. mesh: the images and ids are this rank's rows; every rank gets
    the features of the global batches."""
    dev = _device_of(params)
    encode = (M.encode_image_features if mesh is None
              else sharded_encoder(cfg, mesh, M.encode_image_features))
    feats, labels = [], []
    for images, lab, valid, *rest in batches:
        cv = _as_tensor(rest[0], dev) if rest else None
        v = _as_tensor(valid, dev).bool()
        f = encode(params, cfg, _as_tensor(images, dev), cv)["proj"]
        feats.append(f[v])
        labels.append(_as_tensor(lab, dev)[v])
    return torch.cat(feats), torch.cat(labels)


def run_stage1(
    params: dict,
    cfg: M.ReidModelConfig,
    tcfg: TrainConfig,
    epoch_batches: Callable[[int], Iterable],
    epochs: Optional[int] = None,
    seed: int = 0,
    batch_size: int = 64,
    log: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    cached_order: Optional[Callable[[int, np.ndarray], Iterable]] = None,
    guard=None,
    start_epoch: int = 1,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
    mesh=None,
) -> dict:
    """epoch_batches(epoch) yields (images, labels, valid[, cv_ids]) batches
    (epoch 0 is the coop/adapter feature precompute's sequential pass);
    under a mesh the images and ids are this rank's rows.
    batch_size drives the cached-feature path's step size. Returns the
    trained parameters (GPA-averaged for promptsrc). checkpoint_cb(epoch,
    params, state) fires after every epoch with state = {"optimizer":
    optimizer state dict, "opt_paths": its leaf order, "gpa": the GPA sum}.

    cached_order(epoch, labels) -> iterable of index arrays overrides the
    cached path's batch order (the soft-multitask per-dataset alternation);
    tail batches shorter than batch_size are padded and masked.
    start_epoch / init_opt_state / init_gpa resume a run mid-stage.

    The live modes take their batches through device_prefetch. The cached
    coop/adapter path is the JAX package's chunked branch: each step
    gathers its features and labels on the device by an index row, on CUDA
    as a CUDA graph replay (32 index rows per host copy; eager under a
    mesh)."""
    epochs = epochs or tcfg.epochs_stage1
    dev = _device_of(params)
    _check_start(mesh, params, "run_stage1")
    cached = cfg.mode in ("coop", "adapter")
    trainable, frozen = O.partition(params, lambda path: M.stage1_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage1, tcfg.weight_decay,
                                       capturable=dev.type == "cuda")
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable)
    step = make_stage1_step(cfg, optimizer, cached, mesh)
    state = _TrainState(trainable, optimizer)
    pipe = LossPipeline(guard, state.get, state.set, mesh)

    if cached:
        feats, labels = precompute_image_features(params, cfg, epoch_batches(0), mesh)
        n = labels.shape[0]
        bs = min(batch_size, n)
        rng = np.random.default_rng(seed)
        bufs = _static_buffers(bs, dev)

        def body():
            idx = bufs["idx"]
            return step(trainable, frozen, {"image_features": feats[idx], "labels": labels[idx],
                                            "valid": bufs["valid"]})

        run = _step_runner(body, state.tensors, dev, "cached stage-1 step", mesh, log)

        def cached_rows(epoch):
            if cached_order is not None:
                sels = cached_order(epoch, labels.cpu().numpy())
            else:
                order = rng.permutation(n)
                sels = (order[i:i + bs] for i in range(0, n, bs))
            rows = []
            for sel in sels:
                sel = np.asarray(sel)
                valid = np.ones((bs,), bool)
                if len(sel) < bs:  # padded tail, masked out of the loss
                    valid[len(sel):] = False
                    sel = np.concatenate([sel, np.zeros((bs - len(sel),), sel.dtype)])
                rows.append((sel, np.zeros((bs,), np.int64), valid))
            return rows

    def live_batch(item):
        images, lab, valid, *rest = item
        batch = {"images": _as_tensor(images, dev), "labels": _as_tensor(lab, dev),
                 "valid": _as_tensor(valid, dev).bool()}
        if rest:  # SIE camera ids
            batch["cv_ids"] = _as_tensor(rest[0], dev)
        return batch

    placer = StreamPlacer(dev)
    gw = O.gauss_weights(*tcfg.gpa_stage1, epochs)
    gpa = init_gpa
    gstep = 0
    try:
        for epoch in range(start_epoch, epochs + 1):
            lr = S.cosine_warmup_lr(epoch, tcfg.lr_stage1, epochs)
            O.set_lr(optimizer, lr)
            if cached:
                gstep = _replay_epoch(cached_rows(epoch), 32, bufs, run, pipe, gstep, dev)
            else:
                for item in _spanned_next(_prefetch(epoch_batches(epoch), placer, mesh)):
                    with span("reid.train.step", step=gstep):
                        batch = live_batch(item)
                        pipe.before_step(gstep)
                        gstep += 1
                        pipe.after_step(step(trainable, frozen, batch),
                                        redo=lambda batch=batch: step(trainable, frozen, batch))
            losses = pipe.drain_epoch()
            if cfg.mode == "promptsrc":
                gpa = O.gpa_update(gpa, O.combine(_detached(trainable), frozen), gw[epoch - 1])
            if losses:
                log(f"[stage1] epoch {epoch}/{epochs} loss {np.mean(losses):.4f} lr {lr:.2e}")
            if checkpoint_cb is not None:
                checkpoint_cb(epoch, O.combine(_detached(trainable), frozen),
                              {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                               "gpa": gpa})
    finally:
        if cached and mesh is None:
            run.release(_leaves(trainable))
    if cfg.mode == "promptsrc" and gpa is not None:
        return gpa
    return O.combine(_detached(trainable), frozen)


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------


def stage2_loss(cfg: M.ReidModelConfig, tcfg: TrainConfig, params: dict, images: Tensor,
                labels: Tensor, text_features: Tensor, valid: Optional[Tensor] = None,
                cv_ids: Optional[Tensor] = None, mesh=None):
    """(loss, new BN statistics) of one stage-2 batch: 0.25 x smoothed CE
    per ID head + smoothed CE of proj @ text.T + the triplet on every
    feature level (gated on >= 4 real rows) [+ SmoothL1 to the teacher].
    cv_ids: the SIE camera ids. mesh: images / cv_ids are this rank's
    rows; the features are gathered before the heads."""
    encode = None if mesh is None else sharded_encoder(cfg, mesh, M.encode_train_features)
    out = M.forward_train(params, cfg, images, train=True, valid=valid, cv_ids=cv_ids,
                          encode_fn=encode)
    loss = torch.zeros((), device=images.device)
    if cfg.mode == "promptsrc":
        loss = loss + L.smooth_l1(out["features"][1], out["zs_non_proj"], valid)
    for score in out["cls_scores"]:
        loss = loss + tcfg.id_loss_weight * L.cross_entropy_label_smooth(
            score, labels, tcfg.label_smooth_eps, valid=valid)
    logits = out["proj"].float() @ text_features.T.float()
    loss = loss + L.cross_entropy_label_smooth(logits, labels, tcfg.label_smooth_eps,
                                               valid=valid)
    tri = sum(L.triplet_loss(f, labels, margin=tcfg.triplet_margin, valid=valid)
              for f in out["features"])
    if valid is None:
        loss = loss + tri
    else:
        # a padded tail batch with fewer than 4 real rows has no meaningful
        # hard mining
        loss = loss + torch.where(valid.sum() >= 4, tri, torch.zeros_like(tri))
    return loss, out["bn_stats"]


def make_stage2_step(cfg: M.ReidModelConfig, tcfg: TrainConfig,
                     optimizer: torch.optim.Optimizer, mesh=None):
    """Stage-2 step(trainable, frozen, images, labels, text_features,
    valid=None, cv_ids=None) -> loss (a 0-dim tensor): the BNNeck's (and
    JPM's BNNeck's) new running statistics are written into frozen's tensors
    with copy_, so frozen must own them (`_bn_state`). mesh: see the module
    notes."""

    def step(trainable, frozen, images, labels, text_features, valid=None, cv_ids=None):
        with span("reid.train.forward"):
            loss, bn_stats = stage2_loss(cfg, tcfg, O.combine(trainable, frozen), images,
                                         labels, text_features, valid, cv_ids, mesh)
        _apply_grads(loss, trainable, optimizer, mesh)
        # thread the BNNeck running stats (state lives in the frozen tree)
        new = [(("head", name), bn_stats[name]) for name in ("bn", "bn_proj")
               if bn_stats[name] is not None]
        if bn_stats.get("jpm") is not None:  # use_jpm: the 4th BNNeck, on the jigsaw branch
            new.append((("jpm_head", "bn"), bn_stats["jpm"]))
        with span("reid.train.optimizer"), torch.no_grad():
            for (head, name), stats in new:
                for k in ("mean", "var"):
                    frozen[head][name][k].copy_(stats[k])
        return loss.detach()

    return step


def run_stage2(
    params: dict,
    cfg: M.ReidModelConfig,
    tcfg: TrainConfig,
    epoch_batches: Callable[[int], Iterable],
    epochs: Optional[int] = None,
    log: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    guard=None,
    start_epoch: int = 0,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
    mesh=None,
) -> dict:
    """epoch_batches(epoch) yields (images, labels, valid[, cv_ids]) batches
    (epochs 0-based; the SIE camera ids are required when cfg.sie_ids > 0),
    taken through device_prefetch; under a mesh the images and ids are this
    rank's rows. guard: optional
    runtime.guard.TrainGuard — snapshots the trainable leaves, the BNNeck
    statistics and the optimizer state, and rolls all three back in place
    when a step yields a non-finite loss.
    checkpoint_cb and start_epoch / init_opt_state / init_gpa: as in
    run_stage1."""
    epochs = epochs or tcfg.epochs_stage2
    dev = _device_of(params)
    _check_start(mesh, params, "run_stage2")
    with torch.no_grad():
        text_features = M.all_class_text_features(params, cfg)
    trainable, frozen = O.partition(params, lambda path: M.stage2_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    frozen, bn = _bn_state(frozen, cfg)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage2, tcfg.weight_decay,
                                       bias_lr_mult=2.0, capturable=dev.type == "cuda")
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable, bias_lr_mult=2.0)
    step = make_stage2_step(cfg, tcfg, optimizer, mesh)
    state = _TrainState(trainable, optimizer, bn)
    pipe = LossPipeline(guard, state.get, state.set, mesh)
    placer = StreamPlacer(dev)
    gw = O.gauss_weights(*tcfg.gpa_stage2, epochs)
    gpa = init_gpa
    gstep = 0
    for epoch in range(start_epoch, epochs):
        lr = S.warmup_multistep_lr(epoch, tcfg.lr_stage2)
        O.set_lr(optimizer, lr)
        for images, labels, valid, *rest in _spanned_next(
                _prefetch(epoch_batches(epoch), placer, mesh)):
            if cfg.sie_ids > 0 and not rest:
                raise ValueError("sie_ids > 0: stage-2 batches must carry camera ids")
            with span("reid.train.step", step=gstep):
                batch = (_as_tensor(images, dev), _as_tensor(labels, dev),
                         _as_tensor(valid, dev).bool(),
                         _as_tensor(rest[0], dev) if cfg.sie_ids > 0 else None)
                pipe.before_step(gstep)

                def dispatch(batch=batch):
                    return step(trainable, frozen, *batch[:2], text_features, *batch[2:])

                gstep += 1
                pipe.after_step(dispatch(), redo=dispatch)
        losses = pipe.drain_epoch()
        if cfg.mode == "promptsrc":
            gpa = O.gpa_update(gpa, O.combine(_detached(trainable), frozen), gw[epoch])
        if losses:
            log(f"[stage2] epoch {epoch + 1}/{epochs} loss {np.mean(losses):.4f} lr {lr:.2e}")
        if checkpoint_cb is not None:
            checkpoint_cb(epoch, O.combine(_detached(trainable), frozen),
                          {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                           "gpa": gpa})
    if cfg.mode == "promptsrc" and gpa is not None:
        return gpa
    return O.combine(_detached(trainable), frozen)


# ---------------------------------------------------------------------------
# the device-resident paths (a DeviceImageCache; CUDA graphs on the card)
# ---------------------------------------------------------------------------


def _refuse_sie(cfg: M.ReidModelConfig) -> None:
    if cfg.sie_ids > 0:
        raise ValueError("the device-resident paths carry no SIE camera ids; train an SIE "
                         "model through run_stage1 / run_stage2")


def _rows(order) -> list:
    """(sel, pids, valid) of each (sel, pids, camids, valid) batch of an
    epoch order (DeviceImageCache.epoch_index_batches)."""
    return [(sel, pids, valid) for sel, pids, _camids, valid in order]


def run_stage2_cached(
    params: dict,
    cfg: M.ReidModelConfig,
    tcfg: TrainConfig,
    cache,
    order_of_epoch: Callable[[int], Iterable],
    pp,
    epoch_gen: Callable[[int], torch.Generator],
    epochs: Optional[int] = None,
    pad_hw: Tuple[int, int] = (10, 10),
    log: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    guard=None,
    start_epoch: int = 0,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
    chunk: int = 32,
    mesh=None,
) -> dict:
    """Stage 2 served from a DeviceImageCache: each step gathers its images
    on the device by an index row, runs the train transform (`pp`) and the
    stage-2 step; on CUDA the whole step is a CUDA graph replay. mesh: the
    cache is sharded over it (DeviceImageCache(mesh=)): a gather returns this
    rank's rows, which take this rank's rows of the global batch's draws,
    and every step runs eagerly.

    order_of_epoch(epoch) -> (sel, pids, camids, valid) batches
    (DeviceImageCache.epoch_index_batches); epoch_gen(epoch) -> the
    torch.Generator of that epoch's augmentation draws, made outside the
    graph as the host loop makes them (pp.train_draws(gen, B) per batch, in
    order) and copied into the step's buffers. With the same order and
    generators this equals run_stage2 fed the same gathers. Steps with no
    valid row are not run; an epoch's mean loss counts the steps that ran.
    chunk: index rows per host-to-device copy (results do not depend on
    it). Guard, checkpoint_cb and the resume arguments as in run_stage2."""
    _refuse_sie(cfg)
    epochs = epochs or tcfg.epochs_stage2
    dev = _device_of(params)
    _check_start(mesh, params, "run_stage2_cached")
    with torch.no_grad():
        text_features = M.all_class_text_features(params, cfg)
    trainable, frozen = O.partition(params, lambda path: M.stage2_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    frozen, bn = _bn_state(frozen, cfg)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage2, tcfg.weight_decay,
                                       bias_lr_mult=2.0, capturable=dev.type == "cuda")
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable, bias_lr_mult=2.0)
    step = make_stage2_step(cfg, tcfg, optimizer, mesh)
    state = _TrainState(trainable, optimizer, bn)
    pipe = LossPipeline(guard, state.get, state.set, mesh)
    bs = None
    bufs: dict = {}
    rows_of = (lambda x: x) if mesh is None else (lambda x: shard_batch(mesh, x))

    def body():
        imgs = pp.train_batch(cache.gather(bufs["idx"]), rows_of(bufs["draws"]), pad_hw=pad_hw)
        return step(trainable, frozen, imgs, bufs["labels"], text_features, bufs["valid"])

    run = _step_runner(body, state.tensors, dev, "stage-2 step", mesh, log)
    gw = O.gauss_weights(*tcfg.gpa_stage2, epochs)
    gpa = init_gpa
    gstep = 0
    try:
        for epoch in range(start_epoch, epochs):
            lr = S.warmup_multistep_lr(epoch, tcfg.lr_stage2)
            O.set_lr(optimizer, lr)
            rows = _rows(order_of_epoch(epoch))
            if not rows:
                continue
            gen = epoch_gen(epoch)
            if bs is None:
                bs = len(rows[0][0])
                bufs.update(_static_buffers(bs, dev))
            gstep = _replay_epoch(rows, chunk, bufs, run, pipe, gstep, dev,
                                  draw=lambda: pp.train_draws(gen, bs, pad_hw))
            losses = pipe.drain_epoch()
            if cfg.mode == "promptsrc":
                gpa = O.gpa_update(gpa, O.combine(_detached(trainable), frozen), gw[epoch])
            if losses:
                log(f"[stage2] epoch {epoch + 1}/{epochs} loss {np.mean(losses):.4f} "
                    f"lr {lr:.2e}")
            if checkpoint_cb is not None:
                checkpoint_cb(epoch, O.combine(_detached(trainable), frozen),
                              {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                               "gpa": gpa})
    finally:
        if mesh is None:
            run.release(_leaves(trainable))
    if cfg.mode == "promptsrc" and gpa is not None:
        return gpa
    return O.combine(_detached(trainable), frozen)


def run_stage1_live_cached(
    params: dict,
    cfg: M.ReidModelConfig,
    tcfg: TrainConfig,
    cache,
    order_of_epoch: Callable[[int], Iterable],
    pp,
    epochs: Optional[int] = None,
    log: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    guard=None,
    start_epoch: int = 1,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
    chunk: int = 32,
    mesh=None,
) -> dict:
    """Live stage 1 (ivlp/promptsrc/maple: the prompt tokens change the
    image encoder, so features are computed every step) served from a
    DeviceImageCache: each step gathers its images by an index row, runs
    the deterministic eval transform (`pp.eval_batch`) and the live step; on
    CUDA the whole step is a CUDA graph replay. order_of_epoch(epoch) ->
    (sel, pids, camids, valid) batches; with the order of run_stage1's
    batches it equals run_stage1. Guard, checkpoint_cb, resume, chunk and
    mesh as in run_stage2_cached."""
    _refuse_sie(cfg)
    epochs = epochs or tcfg.epochs_stage1
    dev = _device_of(params)
    _check_start(mesh, params, "run_stage1_live_cached")
    trainable, frozen = O.partition(params, lambda path: M.stage1_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage1, tcfg.weight_decay,
                                       capturable=dev.type == "cuda")
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable)
    step = make_stage1_step(cfg, optimizer, cached=False, mesh=mesh)
    state = _TrainState(trainable, optimizer)
    pipe = LossPipeline(guard, state.get, state.set, mesh)
    bufs: dict = {}

    def body():
        return step(trainable, frozen, {"images": pp.eval_batch(cache.gather(bufs["idx"])),
                                        "labels": bufs["labels"], "valid": bufs["valid"]})

    run = _step_runner(body, state.tensors, dev, "live stage-1 step", mesh, log)
    gw = O.gauss_weights(*tcfg.gpa_stage1, epochs)
    gpa = init_gpa
    gstep = 0
    try:
        for epoch in range(start_epoch, epochs + 1):
            lr = S.cosine_warmup_lr(epoch, tcfg.lr_stage1, epochs)
            O.set_lr(optimizer, lr)
            rows = _rows(order_of_epoch(epoch))
            if rows and not bufs:
                bufs.update(_static_buffers(len(rows[0][0]), dev))
            gstep = _replay_epoch(rows, chunk, bufs, run, pipe, gstep, dev)
            losses = pipe.drain_epoch()
            if cfg.mode == "promptsrc":
                gpa = O.gpa_update(gpa, O.combine(_detached(trainable), frozen), gw[epoch - 1])
            if losses:
                log(f"[stage1] epoch {epoch}/{epochs} loss {np.mean(losses):.4f} lr {lr:.2e}")
            if checkpoint_cb is not None:
                checkpoint_cb(epoch, O.combine(_detached(trainable), frozen),
                              {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                               "gpa": gpa})
    finally:
        if mesh is None:
            run.release(_leaves(trainable))
    if cfg.mode == "promptsrc" and gpa is not None:
        return gpa
    return O.combine(_detached(trainable), frozen)
