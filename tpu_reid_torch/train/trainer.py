"""Two-stage prompt-learning trainers (the port of tpu_reid/train/trainer.py,
single device).

Stage 1 — learn text prompts:
  * coop/adapter: image features are computed ONCE with the frozen encoder,
    then every step runs only the text side against the cached features,
  * ivlp/promptsrc: the VPT tokens change the image encoder, so image
    features are computed live each step,
  * loss = SupCon(i2t) + SupCon(t2i), Adam lr 3.5e-4 wd 1e-4, cosine
    schedule with 5-epoch warmup; promptsrc keeps a gaussian-weighted
    parameter average (GPA mu=60 sigma=45).

Stage 2 — fine-tune the image tower:
  * text features for all classes computed once with frozen prompts,
  * loss = 0.25*smoothCE(id logits) per head + smoothCE(proj @ text.T)
    + triplet(margin 0.3) on all three feature levels, the triplet gated on
    Σvalid >= 4 (+ SmoothL1 against the frozen teacher for promptsrc),
  * Adam lr 5e-6 (bias x2) wd 1e-4, WarmupMultiStepLR([30, 50], warmup 10),
  * the BNNeck running statistics threaded as state through `frozen`,
  * GPA mu=30 sigma=30 for promptsrc (swapped in at the end of training).

A step takes (trainable, frozen) trees: the trainable leaves are fp32
master tensors that require grad, updated in place by torch.optim.Adam; the
input parameter dict is not modified. On CUDA every block of both towers
runs forward through the hand-written kernels and backward through the
plain block's recompute (models/layers.residual_block). Epoch loops read the
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

Later slices: the multi-device paths (`sharded_encoder`, the `mesh=`
arguments) and the device-resident chunked epochs (`run_stage2_cached`,
`run_stage1_live_cached`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.models import reid_clip as M
from tpu_reid_torch.train import losses as L
from tpu_reid_torch.train import optim as O
from tpu_reid_torch.train import schedules as S

Tensor = torch.Tensor


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


def _apply_grads(loss: Tensor, trainable: dict, optimizer: torch.optim.Optimizer) -> None:
    """loss.backward() over the trainable leaves, a zero gradient for any
    leaf the loss does not reach (so Adam's coupled decay still moves it,
    as the JAX chain does), then the Adam step."""
    leaves = _leaves(trainable)
    for t in leaves:
        t.grad = None
    loss.backward()
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    optimizer.step()


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

    def __init__(self, guard, get_state, set_state):
        self.guard = guard
        self.get_state = get_state
        self.set_state = set_state
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
        lf = float(self._pending)
        self._pending = None
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
    holds references to them)."""
    with torch.no_grad():
        for (_, t), (_, s) in zip(O.paths(live), O.paths(saved)):
            if t is not None:
                t.copy_(s)


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------


def stage1_loss(cfg: M.ReidModelConfig, params: dict, batch: dict) -> Tensor:
    """SupCon(i2t) + SupCon(t2i) of one stage-1 batch: with
    "image_features" (the cached path) or "images" (the live encoder);
    batch["valid"] (B,) bool masks padded rows out of both directions."""
    labels = batch["labels"]
    valid = batch.get("valid")
    if "image_features" in batch:
        image_features = batch["image_features"]
    else:
        image_features = M.encode_image_features(params, cfg, batch["images"])["proj"]
    text_features = M.encode_text_features(params, cfg, labels)
    loss = L.supcon_loss(image_features, text_features, labels, labels,
                         anchor_valid=valid, contrast_valid=valid)
    return loss + L.supcon_loss(text_features, image_features, labels, labels,
                                anchor_valid=valid, contrast_valid=valid)


def make_stage1_step(cfg: M.ReidModelConfig, optimizer: torch.optim.Optimizer, cached: bool):
    """Stage-1 step(trainable, frozen, batch) -> loss (a 0-dim tensor, not
    read on the host). cached=True: the batch carries precomputed
    "image_features"; cached=False (ivlp/promptsrc): it carries "images" and
    the encoder runs live inside the step."""

    def step(trainable, frozen, batch):
        if cached != ("image_features" in batch):
            raise ValueError("a cached step takes image_features, a live step images")
        loss = stage1_loss(cfg, O.combine(trainable, frozen), batch)
        _apply_grads(loss, trainable, optimizer)
        return loss.detach()

    return step


@torch.no_grad()
def precompute_image_features(params: dict, cfg: M.ReidModelConfig,
                              batches: Iterable) -> Tuple[Tensor, Tensor]:
    """Frozen-encoder sweep caching the proj features for the coop/adapter
    stage 1; batches yield (images, labels, valid). Stays on the device."""
    dev = _device_of(params)
    feats, labels = [], []
    for images, lab, valid, *rest in batches:
        if rest:
            raise NotImplementedError(
                "camera ids feed SIE, not ported yet (ROADMAP.md queue 1 item 5)")
        v = _as_tensor(valid, dev).bool()
        f = M.encode_image_features(params, cfg, _as_tensor(images, dev))["proj"]
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
) -> dict:
    """epoch_batches(epoch) yields (images, labels, valid) batches
    (epoch 0 is the coop/adapter feature precompute's sequential pass).
    batch_size drives the cached-feature path's step size. Returns the
    trained parameters (GPA-averaged for promptsrc). checkpoint_cb(epoch,
    params, state) fires after every epoch with state = {"optimizer":
    optimizer state dict, "opt_paths": its leaf order, "gpa": the GPA sum}.

    cached_order(epoch, labels) -> iterable of index arrays overrides the
    cached path's batch order (the soft-multitask per-dataset alternation);
    tail batches shorter than batch_size are padded and masked.
    start_epoch / init_opt_state / init_gpa resume a run mid-stage."""
    epochs = epochs or tcfg.epochs_stage1
    dev = _device_of(params)
    cached = cfg.mode in ("coop", "adapter")
    trainable, frozen = O.partition(params, lambda path: M.stage1_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage1, tcfg.weight_decay)
    if init_opt_state is not None:
        optimizer.load_state_dict(init_opt_state)
    opt_paths = O.leaf_order(trainable)
    step = make_stage1_step(cfg, optimizer, cached)

    if cached:
        feats, labels = precompute_image_features(params, cfg, epoch_batches(0))
        n = labels.shape[0]
        bs = min(batch_size, n)
        rng = np.random.default_rng(seed)

        def cached_batches(epoch):
            if cached_order is not None:
                sels = cached_order(epoch, labels.cpu().numpy())
            else:
                order = rng.permutation(n)
                sels = (order[i:i + bs] for i in range(0, n, bs))
            for sel in sels:
                sel = np.asarray(sel)
                valid = np.ones((bs,), bool)
                if len(sel) < bs:  # padded tail, masked out of the loss
                    valid[len(sel):] = False
                    sel = np.concatenate([sel, np.zeros((bs - len(sel),), sel.dtype)])
                idx = torch.as_tensor(sel, device=dev)
                yield {"image_features": feats[idx], "labels": labels[idx],
                       "valid": torch.as_tensor(valid, device=dev)}

    def live_batches(epoch):
        for images, lab, valid, *rest in epoch_batches(epoch):
            if rest:
                raise NotImplementedError(
                    "camera ids feed SIE, not ported yet (ROADMAP.md queue 1 item 5)")
            yield {"images": _as_tensor(images, dev), "labels": _as_tensor(lab, dev),
                   "valid": _as_tensor(valid, dev).bool()}

    def get_state():
        return trainable, optimizer.state_dict()

    def set_state(state):
        _restore_into(trainable, state[0])
        optimizer.load_state_dict(state[1])

    pipe = LossPipeline(guard, get_state, set_state)
    gw = O.gauss_weights(*tcfg.gpa_stage1, epochs)
    gpa = init_gpa
    gstep = 0
    for epoch in range(start_epoch, epochs + 1):
        lr = S.cosine_warmup_lr(epoch, tcfg.lr_stage1, epochs)
        O.set_lr(optimizer, lr)
        for batch in (cached_batches(epoch) if cached else live_batches(epoch)):
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
    if cfg.mode == "promptsrc" and gpa is not None:
        return gpa
    return O.combine(_detached(trainable), frozen)


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------


def stage2_loss(cfg: M.ReidModelConfig, tcfg: TrainConfig, params: dict, images: Tensor,
                labels: Tensor, text_features: Tensor, valid: Optional[Tensor] = None):
    """(loss, new BN statistics) of one stage-2 batch: 0.25 x smoothed CE
    per ID head + smoothed CE of proj @ text.T + the triplet on the three
    feature levels (gated on >= 4 real rows) [+ SmoothL1 to the teacher]."""
    out = M.forward_train(params, cfg, images, train=True, valid=valid)
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
                     optimizer: torch.optim.Optimizer):
    """Stage-2 step(trainable, frozen, images, labels, text_features,
    valid=None) -> (frozen, loss): the returned frozen tree carries the
    BNNeck's new running statistics; loss is a 0-dim tensor."""

    def step(trainable, frozen, images, labels, text_features, valid=None):
        loss, bn_stats = stage2_loss(cfg, tcfg, O.combine(trainable, frozen), images, labels,
                                     text_features, valid)
        _apply_grads(loss, trainable, optimizer)
        # thread the BNNeck running stats (state lives in the frozen tree)
        frozen = dict(frozen, head=dict(frozen["head"]))
        for name in ("bn", "bn_proj"):
            stats = bn_stats[name]
            if stats is not None:
                frozen["head"][name] = dict(frozen["head"][name], mean=stats["mean"].detach(),
                                            var=stats["var"].detach())
        return frozen, loss.detach()

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
) -> dict:
    """epoch_batches(epoch) yields (images, labels, valid) batches (epochs
    0-based). guard: optional runtime.guard.TrainGuard — snapshots the
    trainable leaves, the BNNeck statistics and the optimizer state, and
    rolls all three back when a step yields a non-finite loss.
    checkpoint_cb and start_epoch / init_opt_state / init_gpa: as in
    run_stage1."""
    epochs = epochs or tcfg.epochs_stage2
    dev = _device_of(params)
    with torch.no_grad():
        text_features = M.all_class_text_features(params, cfg)
    trainable, frozen = O.partition(params, lambda path: M.stage2_trainable(path, cfg))
    trainable = _trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage2, tcfg.weight_decay,
                                       bias_lr_mult=2.0)
    if init_opt_state is not None:
        optimizer.load_state_dict(init_opt_state)
    opt_paths = O.leaf_order(trainable, bias_lr_mult=2.0)
    step = make_stage2_step(cfg, tcfg, optimizer)

    def get_state():
        return trainable, frozen["head"], optimizer.state_dict()

    def set_state(state):
        nonlocal frozen
        _restore_into(trainable, state[0])
        frozen = dict(frozen, head=state[1])
        optimizer.load_state_dict(state[2])

    pipe = LossPipeline(guard, get_state, set_state)
    gw = O.gauss_weights(*tcfg.gpa_stage2, epochs)
    gpa = init_gpa
    gstep = 0
    for epoch in range(start_epoch, epochs):
        lr = S.warmup_multistep_lr(epoch, tcfg.lr_stage2)
        O.set_lr(optimizer, lr)
        for images, labels, valid, *rest in epoch_batches(epoch):
            if rest:
                raise NotImplementedError(
                    "camera ids feed SIE, not ported yet (ROADMAP.md queue 1 item 5)")
            batch = (_as_tensor(images, dev), _as_tensor(labels, dev),
                     _as_tensor(valid, dev).bool())
            pipe.before_step(gstep)

            def dispatch(batch=batch):
                nonlocal frozen
                frozen, loss = step(trainable, frozen, *batch[:2], text_features, batch[2])
                return loss

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
