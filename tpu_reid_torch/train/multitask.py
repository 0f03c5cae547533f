"""Multitask prompt learning across two datasets, one shared CLIP trunk (the
port of tpu_reid/train/multitask.py).

Variants (the soft one, one model over the merged label space, runs on the
single-task trainers: cli/multitask.py):
  * hard — shared CLIP trunk; per-dataset prompt learner and BNNeck/ID
    heads; per-dataset XBM memory with a 0.2-weighted memory triplet from
    epoch 10; GPA in stage 2 unconditionally,
  * hard_ivlp — as hard, with IVLP prompt tokens in both towers, a SECOND
    text tower (a clone of the CLIP one, with its own language prompts) for
    dataset 2, stage-1 GPA, and optional per-dataset image resolutions: a
    second positional embedding, bicubic-resized from the shared one,
    serves dataset 2's patch grid.

Every step takes one task's batch and applies its own update of the one
optimizer (reference: one optimizer step per task batch). On CUDA every
block of both towers runs forward through the hand-written kernels and
backward through the plain block's recompute, as in train/trainer.py.

Input: both runners take their batches through
parallel/prefetch.device_prefetch (a worker thread and, on CUDA, a copy
stream; synchronous under a mesh, train/trainer._prefetch), and roll back in
place as train/trainer.py does.

Resume: both runners take start_epoch / init_opt_state / init_gpa (and
init_xbms for stage 2); their checkpoint_cb hands over {"optimizer",
"opt_paths", "gpa"} (+ "xbms") after every epoch.

Data parallelism (`mesh=`): as in train/trainer.py, a task batch carries
this rank's rows of the images and the global labels and valid mask; both
encoders run on this rank's rows and gather (`_mt_sharded_encoder`), the XBM
memory is filled from the gathered global batch, and the gradients are
averaged over the ranks.
"""

from __future__ import annotations

import dataclasses
from itertools import zip_longest
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.configs import CLIPConfig
from tpu_reid_torch.device import clone, to_device
from tpu_reid_torch.models import heads as H
from tpu_reid_torch.models import prompts as P
from tpu_reid_torch.models import text as T
from tpu_reid_torch.models import vit as V
from tpu_reid_torch.models.clip_model import resize_pos_embed
from tpu_reid_torch.parallel.mesh import gathered, shard_batch
from tpu_reid_torch.parallel.prefetch import StreamPlacer
from tpu_reid_torch.train import losses as L
from tpu_reid_torch.train import optim as O
from tpu_reid_torch.train import schedules as S
from tpu_reid_torch.train import trainer as TR
from tpu_reid_torch.train import xbm as X
from tpu_reid_torch.train.trainer import TrainConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MultitaskModelConfig:
    variant: str  # "hard" | "hard_ivlp"
    clip: CLIPConfig  # dataset-1 geometry
    clip2: CLIPConfig  # dataset-2 geometry (may differ in grid only)
    prompt1: P.PromptLearnerConfig
    prompt2: P.PromptLearnerConfig

    def __post_init__(self):
        if self.variant not in ("hard", "hard_ivlp"):
            raise ValueError(f"variant must be 'hard' or 'hard_ivlp': {self.variant!r}")

    @property
    def dual_text(self) -> bool:
        return self.variant == "hard_ivlp"


def init_multitask_model(gen: torch.Generator, cfg: MultitaskModelConfig, clip_params: dict,
                         temb1, tok1, temb2, tok2) -> dict:
    """The multitask parameter dict around converted CLIP weights: two prompt
    learners and two heads from `gen` (on the CLIP weights' device), the
    second text tower as a clone of the CLIP one (hard_ivlp: it trains its
    own language prompts), and `pos_embed2` when dataset 2's grid differs."""
    dev = clip_params["visual"]["conv"]["w"].device
    width = cfg.clip.vision.width
    new = {
        "prompt1": P.init_prompt_learner(gen, cfg.prompt1, temb1, tok1),
        "prompt2": P.init_prompt_learner(gen, cfg.prompt2, temb2, tok2),
        "head1": H.init_classifier(gen, cfg.prompt1.n_cls, dim_nonproj=width,
                                   dim_proj=cfg.clip.embed_dim),
        "head2": H.init_classifier(gen, cfg.prompt2.n_cls, dim_nonproj=width,
                                   dim_proj=cfg.clip.embed_dim),
    }
    params = {"clip": clip_params, **to_device(new, dev)}
    if cfg.dual_text:
        params["text2"] = clone(clip_params["text"])
    g1 = (cfg.clip.vision.h_grid, cfg.clip.vision.w_grid)
    g2 = (cfg.clip2.vision.h_grid, cfg.clip2.vision.w_grid)
    if g2 != g1:
        pos = clip_params["visual"]["positional_embedding"]
        params["pos_embed2"] = torch.from_numpy(resize_pos_embed(
            pos.detach().cpu().numpy(), g2[0], g2[1], in_hw=g1)).to(pos.device)
    return params


def _visual_for_task(params: dict, cfg: MultitaskModelConfig, task: int):
    visual = params["clip"]["visual"]
    if task == 1 and "pos_embed2" in params:
        visual = dict(visual, positional_embedding=params["pos_embed2"])
    return visual, (cfg.clip if task == 0 else cfg.clip2).vision


def encode_image_mt(params: dict, cfg: MultitaskModelConfig, task: int, images: Tensor):
    """CLS features (x11, x12, xproj) of one task's images."""
    visual, vcfg = _visual_for_task(params, cfg, task)
    x11, x12, xproj = V.apply_vit(visual, vcfg, images, cls_only=True)
    return x11[:, 0], x12[:, 0], xproj[:, 0]


def encode_text_mt(params: dict, cfg: MultitaskModelConfig, task: int, label: Tensor) -> Tensor:
    pl = params["prompt1"] if task == 0 else params["prompt2"]
    pcfg = cfg.prompt1 if task == 0 else cfg.prompt2
    text_params = params["text2"] if (task == 1 and cfg.dual_text) else params["clip"]["text"]
    prompts, eot = P.apply_prompt_learner(pl, pcfg, label)
    return T.encode_text_embeddings(text_params, cfg.clip.text, prompts, eot)


def all_class_text_features_mt(params: dict, cfg: MultitaskModelConfig, task: int,
                               batch: int = 256) -> Tensor:
    """Text features of every class of one task, over class chunks of
    `batch` (the stage-2 precompute)."""
    n = (cfg.prompt1 if task == 0 else cfg.prompt2).n_cls
    dev = params["prompt1"]["cls_ctx"].device
    labels = torch.arange(n, device=dev)
    return torch.cat([encode_text_mt(params, cfg, task, labels[i:i + batch])
                      for i in range(0, n, batch)], dim=0)


def eval_embed_mt(params: dict, cfg: MultitaskModelConfig, task: int, images: Tensor) -> Tensor:
    """Retrieval embedding of one task's images: cat(non_proj, proj)."""
    _, non_proj, proj = encode_image_mt(params, cfg, task, images)
    return torch.cat([non_proj, proj], dim=-1)


# ---------------------------------------------------------------------------
# trainable partitions
# ---------------------------------------------------------------------------


def mt_stage1_trainable(path: Tuple[str, ...], cfg: MultitaskModelConfig) -> bool:
    if path[0] in ("prompt1", "prompt2"):
        return path[-1] == "cls_ctx"
    if cfg.variant == "hard_ivlp" and any(p.startswith("vpt_") for p in path):
        return True
    return False


def mt_stage2_trainable(path: Tuple[str, ...], cfg: MultitaskModelConfig) -> bool:
    if path[0] in ("prompt1", "prompt2"):
        return False
    # the text towers take no gradient in stage 2 (precomputed text features)
    if path[0] == "text2" or (path[0] == "clip" and path[1] == "text"):
        return False
    if path[-1] == "logit_scale":
        return False
    if any(p.startswith("vpt_") for p in path):
        return False
    if path[0] in ("head1", "head2") and path[1] in ("bn", "bn_proj") and path[-1] == "bias":
        return False
    if path[-1] in ("mean", "var"):
        return False
    return True


def mt_stage1_leaf_order(params: dict, cfg: MultitaskModelConfig) -> list:
    """The leaf order of run_mt_stage1's optimizer (checked on restore)."""
    return O.leaf_order(O.partition(params, lambda p: mt_stage1_trainable(p, cfg))[0])


def mt_stage2_leaf_order(params: dict, cfg: MultitaskModelConfig) -> list:
    return O.leaf_order(O.partition(params, lambda p: mt_stage2_trainable(p, cfg))[0],
                        bias_lr_mult=2.0)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _mt_sharded_encoder(mesh, fn):
    """fn(params, cfg, task, this rank's rows) -> the gathered global-batch
    features (identity without a mesh)."""
    return fn if mesh is None else gathered(mesh, fn)


def mt_stage1_loss(cfg: MultitaskModelConfig, task: int, params: dict, images: Tensor,
                   labels: Tensor, valid: Optional[Tensor] = None, mesh=None) -> Tensor:
    """SupCon(i2t) + SupCon(t2i) of one task's batch (mesh: `images` are
    this rank's rows; both sides are encoded on this rank's share and
    gathered)."""
    image_features = _mt_sharded_encoder(mesh, encode_image_mt)(params, cfg, task, images)[2]
    text_labels = labels if mesh is None else shard_batch(mesh, labels)
    text_features = _mt_sharded_encoder(mesh, encode_text_mt)(params, cfg, task, text_labels)
    return (L.supcon_loss(image_features, text_features, labels, labels,
                          anchor_valid=valid, contrast_valid=valid)
            + L.supcon_loss(text_features, image_features, labels, labels,
                            anchor_valid=valid, contrast_valid=valid))


def make_mt_stage1_step(cfg: MultitaskModelConfig, optimizer: torch.optim.Optimizer, task: int,
                        mesh=None):
    """step(trainable, frozen, images, labels, valid=None) -> loss (0-dim,
    not read on the host); one update of `optimizer`."""

    def step(trainable, frozen, images, labels, valid=None):
        loss = mt_stage1_loss(cfg, task, O.combine(trainable, frozen), images, labels, valid,
                              mesh)
        TR._apply_grads(loss, trainable, optimizer, mesh)
        return loss.detach()

    return step


def mt_stage2_loss(cfg: MultitaskModelConfig, tcfg: TrainConfig, task: int, params: dict,
                   images: Tensor, labels: Tensor, text_features: Tensor, xbm_state: dict,
                   use_xbm: bool, valid: Optional[Tensor] = None, xbm_weight: float = 0.2,
                   mesh=None):
    """(loss, new BN statistics, new XBM state) of one task's stage-2 batch:
    0.25 x smoothed CE per ID head + smoothed CE of proj @ text.T + the
    triplet on the three feature levels (gated on >= 4 real rows) + with
    use_xbm, xbm_weight x the memory triplet. The batch is enqueued BEFORE
    the mining (it is part of the bank; each anchor's own slot is
    excluded), margin 0.3 as in both hard-sharing references. mesh: the
    images are this rank's rows; the features, and so the memory, are the
    global batch's."""
    head_key = "head1" if task == 0 else "head2"
    last, non_proj, proj = _mt_sharded_encoder(mesh, encode_image_mt)(params, cfg, task, images)
    head = H.apply_classifier(params[head_key], non_proj, proj, train=True, valid=valid)
    loss = torch.zeros((), device=images.device)
    for score in (head["logits"], head["logits_proj"]):
        loss = loss + tcfg.id_loss_weight * L.cross_entropy_label_smooth(
            score, labels, tcfg.label_smooth_eps, valid=valid)
    logits = proj.float() @ text_features.T.float()
    loss = loss + L.cross_entropy_label_smooth(logits, labels, tcfg.label_smooth_eps,
                                               valid=valid)
    tri = sum(L.triplet_loss(f, labels, margin=tcfg.triplet_margin, valid=valid)
              for f in (last, non_proj, proj))
    if valid is None:
        loss = loss + tri
    else:  # bs >= 4 triplet gate
        loss = loss + torch.where(valid.sum() >= 4, tri, torch.zeros_like(tri))
    new_xbm, slots = X.xbm_enqueue(xbm_state, proj, labels, valid=valid)
    if use_xbm:
        bank_f, bank_l, bank_valid = X.xbm_get(new_xbm)
        loss = loss + xbm_weight * L.triplet_loss_xbm(
            proj, labels, bank_f, bank_l, margin=tcfg.triplet_margin, self_cols=slots,
            valid_cols=bank_valid, valid=valid)
    return loss, head["new_stats"], new_xbm


def make_mt_stage2_step(cfg: MultitaskModelConfig, tcfg: TrainConfig,
                        optimizer: torch.optim.Optimizer, task: int, xbm_weight: float = 0.2,
                        mesh=None):
    """step(trainable, frozen, images, labels, text_features, xbm_state,
    use_xbm, valid=None) -> (frozen, xbm_state, loss): the returned frozen
    tree carries the task head's new BN running statistics."""
    head_key = "head1" if task == 0 else "head2"

    def step(trainable, frozen, images, labels, text_features, xbm_state, use_xbm,
             valid=None):
        loss, bn_stats, new_xbm = mt_stage2_loss(
            cfg, tcfg, task, O.combine(trainable, frozen), images, labels, text_features,
            xbm_state, use_xbm, valid, xbm_weight, mesh)
        TR._apply_grads(loss, trainable, optimizer, mesh)
        frozen = dict(frozen, **{head_key: dict(frozen[head_key])})
        for name in ("bn", "bn_proj"):
            stats = bn_stats[name]
            if stats is not None:
                frozen[head_key][name] = dict(frozen[head_key][name],
                                              mean=stats["mean"].detach(),
                                              var=stats["var"].detach())
        return frozen, new_xbm, loss.detach()

    return step


# ---------------------------------------------------------------------------
# schedulers over two loaders
# ---------------------------------------------------------------------------


def alternate(it1: Iterable, it2: Iterable) -> Iterator[Tuple[int, object]]:
    """Strict 1:1 alternation until EITHER iterator is exhausted (the
    hard-sharing-ivlp `while i <= iter1 and j <= iter2`)."""
    a, b = iter(it1), iter(it2)
    while True:
        try:
            yield 0, next(a)
            yield 1, next(b)
        except StopIteration:
            return


def alternate_longest(it1: Iterable, it2: Iterable) -> Iterator[Tuple[int, object]]:
    """Alternation that drains BOTH iterators: once one is exhausted the
    other goes on (the `while i <= iter1 or j <= iter2` toggle of the soft
    and plain-hard stage-1 loops)."""
    for b1, b2 in zip_longest(it1, it2):
        if b1 is not None:
            yield 0, b1
        if b2 is not None:
            yield 1, b2


def chain_tasks(it1: Iterable, it2: Iterable) -> Iterator[Tuple[int, object]]:
    """zip pairing: one batch of each per pair, stopping at the shorter
    loader (hard-ivlp stage 2)."""
    for b1, b2 in zip(it1, it2):
        yield 0, b1
        yield 1, b2


def chain_tasks_longest(it1: Iterable, it2: Iterable) -> Iterator[Tuple[int, object]]:
    """zip_longest pairing: after the shorter loader drains, the longer one
    keeps stepping alone (plain-hard stage 2)."""
    return alternate_longest(it1, it2)


# ---------------------------------------------------------------------------
# epoch loops
# ---------------------------------------------------------------------------


def _task_batch(item, dev):
    task, (images, labels, valid) = item
    return task, (TR._as_tensor(images, dev), TR._as_tensor(labels, dev),
                  TR._as_tensor(valid, dev).bool())


def run_mt_stage1(
    params: dict,
    cfg: MultitaskModelConfig,
    tcfg: TrainConfig,
    epoch_batches: Callable[[int], Iterable],  # yields (task, (images, labels, valid))
    epochs: int,
    log: Callable[[str], None] = print,
    mesh=None,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    guard=None,
    start_epoch: int = 1,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
) -> dict:
    """Stage 1 over both tasks (epochs 1-based): the prompts (and, for
    hard_ivlp, the VPT tokens of the image tower and both text towers)
    train on SupCon. GPA only for hard_ivlp (the plain hard-sharing
    reference has its stage-1 averaging commented out). mesh: see the
    module notes (the images of a batch are this rank's rows)."""
    dev = TR._device_of(params)
    TR._check_start(mesh, params, "run_mt_stage1")
    trainable, frozen = O.partition(params, lambda p: mt_stage1_trainable(p, cfg))
    trainable = TR._trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage1, tcfg.weight_decay)
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable)
    steps = [make_mt_stage1_step(cfg, optimizer, t, mesh) for t in (0, 1)]

    def get_state():
        return trainable, O.state_tensors(optimizer)

    def set_state(state):
        TR._restore_into(trainable, state[0])
        O.restore_state(optimizer, state[1])

    pipe = TR.LossPipeline(guard, get_state, set_state, mesh)
    placer = StreamPlacer(dev)
    gw = O.gauss_weights(*tcfg.gpa_stage1, epochs)
    gpa = init_gpa
    gstep = 0
    for epoch in range(start_epoch, epochs + 1):
        O.set_lr(optimizer, S.cosine_warmup_lr(epoch, tcfg.lr_stage1, epochs))
        for item in TR._prefetch(epoch_batches(epoch), placer, mesh):
            task, batch = _task_batch(item, dev)
            pipe.before_step(gstep)
            gstep += 1
            pipe.after_step(steps[task](trainable, frozen, *batch),
                            redo=lambda task=task, batch=batch:
                            steps[task](trainable, frozen, *batch))
            if len(pipe.losses) % 50 == 1:
                log(f"[mt-stage1] epoch {epoch} step {len(pipe.losses)} "
                    f"loss {pipe.losses[-1]:.4f}")
        losses = pipe.drain_epoch()
        if cfg.variant == "hard_ivlp":
            gpa = O.gpa_update(gpa, O.combine(TR._detached(trainable), frozen), gw[epoch - 1])
        if losses:
            log(f"[mt-stage1] epoch {epoch}/{epochs} loss {np.mean(losses):.4f}")
        if checkpoint_cb is not None:
            checkpoint_cb(epoch, O.combine(TR._detached(trainable), frozen),
                          {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                           "gpa": gpa})
    return gpa if gpa is not None else O.combine(TR._detached(trainable), frozen)


def run_mt_stage2(
    params: dict,
    cfg: MultitaskModelConfig,
    tcfg: TrainConfig,
    epoch_batches: Callable[[int], Iterable],
    epochs: int,
    xbm_capacity: int = 128,
    xbm_start_epoch: int = 10,
    log: Callable[[str], None] = print,
    mesh=None,
    checkpoint_cb: Optional[Callable[[int, dict, dict], None]] = None,
    guard=None,
    start_epoch: int = 0,
    init_opt_state: Optional[dict] = None,
    init_gpa: Optional[dict] = None,
    init_xbms: Optional[list] = None,
) -> dict:
    """Stage 2 over both tasks (epochs 0-based): the image tower and both
    heads train; the text features of both tasks are computed once under
    no_grad; each task mines against its own XBM bank from
    `xbm_start_epoch`; GPA always. The guard snapshots the trainable
    leaves, both heads' BN statistics, the optimizer state and both banks.
    init_xbms restores the banks, so a resumed run mines against the same
    memory. mesh: as in run_mt_stage1."""
    dev = TR._device_of(params)
    TR._check_start(mesh, params, "run_mt_stage2")
    with torch.no_grad():
        text_features = [all_class_text_features_mt(params, cfg, t) for t in (0, 1)]
    trainable, frozen = O.partition(params, lambda p: mt_stage2_trainable(p, cfg))
    trainable = TR._trainable_copy(trainable)
    optimizer = O.make_stage_optimizer(trainable, tcfg.lr_stage2, tcfg.weight_decay,
                                       bias_lr_mult=2.0)
    if init_opt_state is not None:
        O.load_state(optimizer, init_opt_state)
    opt_paths = O.leaf_order(trainable, bias_lr_mult=2.0)
    steps = [make_mt_stage2_step(cfg, tcfg, optimizer, t, mesh=mesh) for t in (0, 1)]
    dim = cfg.clip.embed_dim
    xbms = (list(init_xbms) if init_xbms is not None
            else [X.init_xbm(xbm_capacity, dim, device=dev) for _ in (0, 1)])

    def get_state():
        return (trainable, {k: frozen[k] for k in ("head1", "head2")},
                O.state_tensors(optimizer), xbms[0], xbms[1])

    def set_state(state):
        nonlocal frozen
        TR._restore_into(trainable, state[0])
        frozen = dict(frozen, **state[1])
        O.restore_state(optimizer, state[2])
        xbms[0], xbms[1] = state[3], state[4]

    pipe = TR.LossPipeline(guard, get_state, set_state, mesh)
    placer = StreamPlacer(dev)
    gw = O.gauss_weights(*tcfg.gpa_stage2, epochs)
    gpa = init_gpa
    gstep = 0
    for epoch in range(start_epoch, epochs):
        O.set_lr(optimizer, S.warmup_multistep_lr(epoch, tcfg.lr_stage2))
        use_xbm = epoch >= xbm_start_epoch
        for item in TR._prefetch(epoch_batches(epoch), placer, mesh):
            task, batch = _task_batch(item, dev)
            pipe.before_step(gstep)

            def dispatch(task=task, batch=batch):
                nonlocal frozen
                frozen, xbms[task], loss = steps[task](
                    trainable, frozen, batch[0], batch[1], text_features[task], xbms[task],
                    use_xbm, batch[2])
                return loss

            gstep += 1
            pipe.after_step(dispatch(), redo=dispatch)
            if len(pipe.losses) % 50 == 1:
                log(f"[mt-stage2] epoch {epoch + 1} step {len(pipe.losses)} "
                    f"loss {pipe.losses[-1]:.4f}")
        losses = pipe.drain_epoch()
        gpa = O.gpa_update(gpa, O.combine(TR._detached(trainable), frozen), gw[epoch])
        if losses:
            log(f"[mt-stage2] epoch {epoch + 1}/{epochs} loss {np.mean(losses):.4f}")
        if checkpoint_cb is not None:
            checkpoint_cb(epoch, O.combine(TR._detached(trainable), frozen),
                          {"optimizer": optimizer.state_dict(), "opt_paths": opt_paths,
                           "gpa": gpa, "xbms": list(xbms)})
    return gpa if gpa is not None else O.combine(TR._detached(trainable), frozen)
