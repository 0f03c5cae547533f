"""Two-stage prompt-learning CLI of the PyTorch/CUDA port (CoOp / IVLP /
PromptSRC / CLIP-Adapter / MaPLe): stage-1 prompt learning, stage-2 vision
fine-tuning, then flip-TTA embedding extraction and CMC/mAP/mINP.

The flags of tpu_reid/cli/prompt_learning.py, plus --device (default cuda;
`--device cpu` runs the plain PyTorch versions on the host):

    python -m tpu_reid_torch.cli.prompt_learning --root /data \\
        --model_path ViT-B-16.pt --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --training_mode ivlp --train_dataset market1501 \\
        --epochs_stage1 120 --epochs_stage2 60 --save_path ./out [--dtype bf16]

Checkpoints (runtime/checkpoint.py, torch.save files) go under
<save_path>/<mode>/<train_dataset>: the parameters with their stage markers
every 20 epochs and at the end of each stage, the optimizer state and the
GPA sum beside them. --resume continues from the newest one, mid-stage
included; --keep_best keeps the best-mAP parameters among the evaluated
ones (--eval_every, and the final test) under .../best. The port cannot
read the JAX package's orbax checkpoints.

Variants: --jpm adds the jigsaw-patch branch (coop and adapter only: no
vision prompt tokens); --sie_camera / --sie_view learn a camera (x view)
embedding added to the CLS token, in training and at inference, scaled by
--sie_coe; --augmented_prompts encodes 4 article-variant templates per class
and averages them; --captions_file takes per-identity caption prompts
("label: description" lines).

--cache_device keeps the train split on the device
(data/device_cache.DeviceImageCache, built once after the model): the
epoch-0 precompute and the coop/adapter stage 1 gather their batches from
it, the live stage 1 runs train/trainer.run_stage1_live_cached and stage 2
run_stage2_cached, each step a CUDA graph replay on the card. The orders
and augmentation draws are the loader path's, so the flag changes no
result. It carries no SIE ids (--sie_camera / --sie_view: ValueError).

Not ported yet, and refused with their ROADMAP.md queue-1 item:
--devices > 1 and --multihost (item 7).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

# evaluation extracts in bf16 whatever --dtype says, as the JAX CLI's
# make_extractor does by default
EXTRACT_DTYPE = torch.bfloat16


def params_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default="./", type=str)
    p.add_argument("--bs", default=64, type=int)
    p.add_argument("--model_path", required=True, type=str)
    p.add_argument("--bpe_path", required=True, type=str)
    p.add_argument("--height", default=256, type=int)
    p.add_argument("--ratio", default=0.5, type=float)
    p.add_argument("--stride", default=12, type=int)
    p.add_argument("--epochs_stage1", default=120, type=int)
    p.add_argument("--epochs_stage2", default=60, type=int)
    p.add_argument("--save_path", default="./checkpoints", type=str)
    p.add_argument("--vpt_ctx", default=2, type=int)
    p.add_argument("--training_mode", default="ivlp", type=str,
                   choices=["coop", "ivlp", "promptsrc", "adapter", "maple"])
    p.add_argument("--train_dataset", default="market1501", type=str)
    p.add_argument("--test_dataset", default=None, type=str,
                   help="defaults to --train_dataset")
    p.add_argument("--zs_weights", default=None, type=str,
                   help="separate checkpoint for the promptsrc zero-shot teacher")
    p.add_argument("--pretrained_vpt", default=None, type=str,
                   help="IVLP pretrained VPT checkpoint (its VPT keys are laid over the "
                        "fresh prompt tokens where the shapes match)")
    p.add_argument("--augmented_prompts", action="store_true")
    p.add_argument("--jpm", action="store_true")
    p.add_argument("--captions_file", default=None, type=str)
    p.add_argument("--sie_camera", action="store_true")
    p.add_argument("--sie_view", action="store_true")
    p.add_argument("--sie_coe", default=1.0, type=float)
    p.add_argument("--devices", default=1, type=int)
    p.add_argument("--dtype", default="fp32", type=str, choices=["fp32", "bf16"],
                   help="activation dtype for training; the parameters stay fp32 master "
                        "weights (bf16 engages the bf16 kernels)")
    p.add_argument("--eval_every", default=0, type=int,
                   help="evaluate retrieval every N stage-2 epochs (0: only at the end)")
    p.add_argument("--keep_best", action="store_true",
                   help="keep the best-mAP parameters among the evaluated ones under "
                        "<save_path>/<mode>/<dataset>/best")
    p.add_argument("--multihost", default=None, type=str, metavar="HOST:PORT")
    p.add_argument("--num_hosts", default=1, type=int)
    p.add_argument("--host_id", default=0, type=int)
    p.add_argument("--cache_device", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint under "
                        "<save_path>/<mode>/<dataset> (same epoch counts)")
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--fast_softmax", action="store_true",
                   help="throughput profile for the attention softmax "
                        "(ops.attention.set_fast_softmax)")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for the flags whose code is not ported yet, naming its item, and
    for --cache_device with SIE ids, which the cache does not carry."""
    if args.devices > 1 or args.multihost:
        raise NotImplementedError("not ported yet: --devices > 1 and --multihost need the "
                                  "multi-device slice (ROADMAP.md queue 1 item 7)")
    if args.cache_device and (args.sie_camera or args.sie_view):
        # the JAX CLI's assertion, as a ValueError
        raise ValueError("--cache_device is a single-process feature (no --multihost) and "
                         "does not carry SIE side-info ids")


def build_model(args, n_cls: int, car_types=None, device=None, n_sie_ids: int = 0):
    """Load + convert CLIP and assemble the ReID model for the chosen mode:
    (ReidModelConfig, params on `device`, (h, w)). n_sie_ids > 0 (from
    --sie_camera / --sie_view) sizes the SIE embedding table."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.device import clone
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.models.tokenizer import ClipTokenizer
    from tpu_reid_torch.weights.convert import (
        _convert_text_np, _convert_vit_np, convert_clip, init_vpt, load_state_dict,
    )

    h, w = args.height, int(args.height * args.ratio)
    design = PromptDesign()
    if args.training_mode in ("ivlp", "promptsrc"):
        design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=args.vpt_ctx,
                              language_depth=12, language_ctx=args.vpt_ctx)
    elif args.training_mode == "maple":
        design = PromptDesign(trainer="MaPLe", vision_depth=12, vision_ctx=args.vpt_ctx,
                              language_depth=12, language_ctx=args.vpt_ctx,
                              maple_length=args.vpt_ctx)
    if args.jpm and args.training_mode not in ("coop", "adapter"):
        raise ValueError("--jpm requires a prompt-free vision tower "
                         "(--training_mode coop or adapter)")
    sd = load_state_dict(args.model_path)
    cfg, clip_params = convert_clip(sd, image_hw=(h, w), stride=args.stride, design=design,
                                    device=device)
    if design.has_vision_prompts:
        # fresh prompt tokens (the checkpoint may carry none; a MaPLe design
        # gets no tower-level deep ones: its deep prompts are projected),
        # then the VPT keys of a pretrained checkpoint laid over them where
        # shapes match
        clip_params = init_vpt(torch.Generator().manual_seed(1), cfg, clip_params)
        if args.pretrained_vpt:
            vpt_only = {k: v for k, v in load_state_dict(args.pretrained_vpt).items()
                        if "VPT" in k}
            if vpt_only:
                full = dict(sd, **vpt_only)
                upd = {"visual": _convert_vit_np(full, cfg.vision),
                       "text": _convert_text_np(full, cfg.text)}
                for tower, keys in (("visual", ("vpt_shallow", "vpt_deep")),
                                    ("text", ("vpt_deep",))):
                    for k in keys:
                        old, new = clip_params[tower].get(k), upd[tower].get(k)
                        if new is None or old is None:
                            continue
                        if tuple(new.shape) == tuple(old.shape):
                            clip_params[tower][k] = torch.from_numpy(new).to(old.device)
                        else:
                            print(f"[weights] skip {tower}.{k}: checkpoint {new.shape} "
                                  f"vs model {tuple(old.shape)}")

    tokenizer = ClipTokenizer(args.bpe_path)
    if args.train_dataset == "veri" and car_types is not None:
        if args.training_mode in ("ivlp", "promptsrc"):
            pcfg, texts = P.PromptLearnerConfig.veri_ivlp(n_cls), P.veri_templates(car_types, 4)
        else:
            pcfg, texts = P.PromptLearnerConfig.veri(n_cls), P.veri_templates(car_types, 3)
        tokens = tokenizer.tokenize(texts, context_length=cfg.text.context_length,
                                    truncate=True)
    elif args.captions_file:
        # per-class caption templates: the frozen prefix is SOT and the first
        # 4 caption tokens, 4 learnable ctx spliced in, EOT shifted past them
        pcfg = P.PromptLearnerConfig.captions(n_cls)
        tokens = tokenizer.tokenize(P.read_caption_prompts(args.captions_file, n_cls),
                                    context_length=cfg.text.context_length, truncate=True)
    elif args.augmented_prompts:
        # 4 article-variant templates, shared per-class ctx, mean-pooled
        # text features
        if args.train_dataset not in P.PERSON_DATASETS:
            raise ValueError("--augmented_prompts templates are person-phrased; use the "
                             "default template for vehicle datasets")
        pcfg = P.PromptLearnerConfig.augmented(n_cls)
        tokens = tokenizer.tokenize(list(P.AUGMENTED_TEMPLATES),
                                    context_length=cfg.text.context_length)
    else:
        # ivlp geometry for maple too (per-class ctx + coupled deep prompts)
        pcfg = (P.PromptLearnerConfig.coop(n_cls) if args.training_mode in ("coop", "adapter")
                else P.PromptLearnerConfig.ivlp(n_cls))
        tokens = tokenizer.tokenize(P.base_template(args.train_dataset),
                                    context_length=cfg.text.context_length)
    tokens = np.asarray(tokens)
    temb = clip_params["text"]["token_embedding"][torch.as_tensor(tokens, dtype=torch.long,
                                                                  device=device)]
    mcfg = M.ReidModelConfig(mode=args.training_mode, clip=cfg, prompt=pcfg, use_jpm=args.jpm,
                             sie_ids=n_sie_ids, sie_coe=args.sie_coe)
    zs = None
    if args.training_mode == "promptsrc":
        if args.zs_weights:
            zs_cfg, zs_params = convert_clip(load_state_dict(args.zs_weights), image_hw=(h, w),
                                             stride=args.stride, device=device)
            v, zv = cfg.vision, zs_cfg.vision
            if (zv.width, zv.layers, zv.patch_size) != (v.width, v.layers, v.patch_size):
                raise ValueError("the zero-shot teacher's architecture must match the "
                                 "student tower")
            zs = zs_params["visual"]
        else:
            # the teacher is a copy of the pretrained tower
            zs = {k: v for k, v in clip_params["visual"].items() if not k.startswith("vpt_")}
            zs = clone(zs)
    params = M.init_reid_model(torch.Generator().manual_seed(args.seed), mcfg, clip_params,
                               temb, tokens, zs_visual_params=zs)
    return mcfg, params, (h, w)


def sie_table(args, dataset):
    """(table size, batch -> (B,) int ids, or (0, None) without SIE): with
    --sie_camera and --sie_view the table is cameras x views (TransReID's
    composition), with one flag that factor alone; ids are camera * n_views
    + view, the view clipped to the table. Counts cover every split."""
    if not (args.sie_camera or args.sie_view):
        return 0, None
    recs = dataset.train + dataset.query + dataset.gallery
    n_cams = 1 + max(r[2] for r in recs) if args.sie_camera else 1
    n_views = 1 + max(r[3] for r in recs) if args.sie_view else 1

    def sie_ids_of(b):
        ids = np.zeros(len(b.pids), np.int64)
        if args.sie_camera:
            ids = np.asarray(b.camids, np.int64) * n_views
        if args.sie_view:
            ids = ids + np.minimum(np.asarray(b.seqids, np.int64), n_views - 1)
        return ids

    return n_cams * n_views, sie_ids_of


def main(argv=None):
    args = params_parser(argv)
    refuse_unported(args)
    args.test_dataset = args.test_dataset or args.train_dataset

    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.sampler import PKSampler
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.device import resolve_device
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.retrieval.metrics import Evaluator
    from tpu_reid_torch.runtime.checkpoint import (
        BestKeeper, CheckpointManager, fresh_start, two_stage_cb, two_stage_resume,
    )
    from tpu_reid_torch.runtime.guard import TrainGuard
    from tpu_reid_torch.runtime.observe import MetricLogger, synced_phase
    from tpu_reid_torch.train import trainer as TR

    dev = resolve_device(args.device)
    if args.fast_softmax:
        set_fast_softmax(True)
    log = MetricLogger(args.log_dir)
    dataset = get_dataset(args.root, args.train_dataset)
    n_cls = dataset.num_train_pids
    n_sie, sie_ids_of = sie_table(args, dataset)
    mcfg, params, (h, w) = build_model(args, n_cls, dataset.car_types_train, device=dev,
                                       n_sie_ids=n_sie)
    log.log("model", mode=args.training_mode, n_cls=n_cls, h=h, w=w, sie_ids=n_sie)

    # bf16 activations over fp32 master weights: the layers cast the weights
    # to the activation dtype on the fly
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    pp = DevicePreprocess((h, w), "vit", dtype=dtype)

    cache = None
    if args.cache_device:
        # the train split on the device once: every epoch's batches become a
        # gather there, with no host decode or image copy in the epoch loop
        from tpu_reid_torch.data.device_cache import DeviceImageCache

        t0 = time.perf_counter()
        cache = DeviceImageCache(dataset.train, (h, w), device=dev)
        log.log("cache_device", n=cache.n, mb=round(cache.nbytes() / 2**20, 1),
                upload_s=round(time.perf_counter() - t0, 1), sharded=False)

    def stage1_order(epoch):
        # the loader's order: shuffled with seed + epoch (a Generator's
        # permutation is its shuffle of arange), the tail dropped; epoch 0
        # the sequential pass, tail padded
        order = (np.random.default_rng(args.seed + epoch).permutation(cache.n) if epoch > 0
                 else np.arange(cache.n))
        return cache.epoch_index_batches(order, args.bs, drop_tail=epoch > 0)

    def stage2_order(epoch):
        labels = [r[1] for r in dataset.train]
        sampler = PKSampler(labels, args.bs, 4, seed=args.seed + epoch)
        return cache.epoch_index_batches(sampler.epoch(), args.bs)

    def stage2_gen(epoch):
        return torch.Generator(device=dev).manual_seed(args.seed * 1_000_003 + 10_000 + epoch)

    def stage1_batches(epoch):
        # stage 1 consumes the deterministic eval transform, shuffled order
        # (epoch 0: the sequential pass of the coop/adapter precompute)
        if cache is not None:
            for sel, pids, _camids, valid in stage1_order(epoch):
                yield pp.eval_batch(cache.gather(sel)), torch.as_tensor(pids).to(dev), valid
            return
        loader = BatchLoader(dataset.train, args.bs, (h, w),
                             order="shuffle" if epoch > 0 else None,
                             seed=args.seed + epoch, drop_tail=epoch > 0)
        for b in loader:
            out = (pp.eval_batch(torch.as_tensor(b.images).to(dev)),
                   torch.as_tensor(b.pids).to(dev), b.valid)
            # SIE: the side-information ids ride as a trailing element
            yield out + ((torch.as_tensor(sie_ids_of(b)).to(dev),) if n_sie else ())

    def stage2_batches(epoch):
        labels = [r[1] for r in dataset.train]
        sampler = PKSampler(labels, args.bs, 4, seed=args.seed + epoch)
        gen = stage2_gen(epoch)
        for b in BatchLoader(dataset.train, args.bs, (h, w), order=sampler.epoch()):
            images = torch.as_tensor(b.images).to(dev)
            imgs = pp.train_batch(images, pp.train_draws(gen, images.shape[0]),
                                  pad_hw=(10, 10))
            out = (imgs, torch.as_tensor(b.pids).to(dev), b.valid)
            yield out + ((torch.as_tensor(sie_ids_of(b)).to(dev),) if n_sie else ())

    tcfg = TR.TrainConfig(epochs_stage1=args.epochs_stage1, epochs_stage2=args.epochs_stage2)
    ckpt_dir = os.path.join(args.save_path, args.training_mode, args.train_dataset)
    mgr = CheckpointManager(ckpt_dir, save_interval=20)

    # --resume: the newest checkpoint's parameters, and mid-stage its
    # optimizer state and (promptsrc) GPA sum: the run goes on where it
    # stopped
    (kw1, kw2), done_stage = fresh_start(), 0
    if args.resume:
        params, done_stage, kw1, kw2 = two_stage_resume(
            mgr, params, lambda p: TR.stage1_leaf_order(p, mcfg),
            lambda p: TR.stage2_leaf_order(p, mcfg),
            gpa1_used=args.training_mode == "promptsrc",
            gpa2_used=args.training_mode == "promptsrc",
            log=lambda s: log.log("resume", msg=s))
        log.log("resume", stage=done_stage, epoch=mgr.latest_epoch())

    def make_guard():
        # divergence rollback, always on: snapshots every 50 steps, rolls
        # back and skips the batch on a non-finite loss
        return TrainGuard(snapshot_every=50, max_restores=3,
                          log=lambda s: log.log("guard", msg=s))

    # best among the evaluated parameters: every --eval_every epochs and the
    # final test (without --eval_every, the final parameters)
    best = BestKeeper(os.path.join(ckpt_dir, "best"), log.log) if args.keep_best else None

    def maybe_keep_best(epoch: int, p, m: float):
        if best is not None:
            best.offer(epoch, p, m)

    eval_state: dict = {}

    def evaluate(eval_params):
        if not eval_state:
            eval_state["ds"] = get_dataset(args.root, args.test_dataset)
            # input normalization folded into the patch-embed weights (exact)
            # SIE applies at inference too (ids past the training range are
            # clipped to the last row of the table inside the model)
            eval_state["xtr"] = make_extractor(
                lambda p, im, *cv: M.eval_embed(p, mcfg, im, *cv), pp, flip_tta=True,
                dtype=EXTRACT_DTYPE, with_cv_ids=bool(n_sie),
                fold=lambda p: M.fold_input_norm(p, mcfg, "vit"), device=dev)
        test_ds, extractor = eval_state["ds"], eval_state["xtr"]
        g_feats, g_pids, g_cams, _ = extract_embeddings(
            extractor, eval_params, BatchLoader(test_ds.gallery, args.bs, (h, w)),
            cv_ids_of=sie_ids_of, device=dev)
        q_feats, q_pids, q_cams, _ = extract_embeddings(
            extractor, eval_params, BatchLoader(test_ds.query, args.bs, (h, w)),
            cv_ids_of=sie_ids_of, device=dev)
        ev = Evaluator(num_query=len(q_pids), max_rank=10, feat_norm=True,
                       reranking=args.rerank, with_minp=True)
        ev.update(q_feats, q_pids, q_cams)
        ev.update(g_feats, g_pids, g_cams)
        return ev.compute()

    save_stage2 = two_stage_cb(mgr, 1, lambda e: args.epochs_stage1 + e)

    def stage2_cb(epoch, p, state):
        save_stage2(epoch, p, state)
        done = epoch + 1  # run_stage2 epochs are 0-based
        if args.eval_every and done % args.eval_every == 0 and done < args.epochs_stage2:
            with synced_phase(log, "eval", dev):
                c, m, i_ = evaluate(p)
            log.log("eval", stage2_epoch=done, mAP=float(m), rank1=float(c[0]),
                    mINP=float(i_))
            maybe_keep_best(done, p, float(m))

    try:  # a write in flight is finished even when training raises
        train_log = lambda s: log.log("train", msg=s)  # noqa: E731
        if done_stage < 1:
            with synced_phase(log, "stage1", dev):
                if cache is not None and args.training_mode not in ("coop", "adapter"):
                    # the live modes: run_stage1's epochs are 1-based, so the
                    # shuffled, tail-dropped orders of stage1_batches
                    params = TR.run_stage1_live_cached(
                        params, mcfg, tcfg, cache, stage1_order, pp, epochs=args.epochs_stage1,
                        guard=make_guard(), log=train_log,
                        checkpoint_cb=two_stage_cb(mgr, 0, lambda e: e), **kw1)
                else:
                    params = TR.run_stage1(params, mcfg, tcfg, stage1_batches,
                                           epochs=args.epochs_stage1, seed=args.seed,
                                           batch_size=args.bs, guard=make_guard(),
                                           log=train_log,
                                           checkpoint_cb=two_stage_cb(mgr, 0, lambda e: e),
                                           **kw1)
                mgr.save(args.epochs_stage1,
                         {"params": params, "stage": 1, "epoch_in_stage": -1})
        if done_stage < 2:
            with synced_phase(log, "stage2", dev):
                if cache is not None:
                    params = TR.run_stage2_cached(
                        params, mcfg, tcfg, cache, stage2_order, pp, stage2_gen,
                        epochs=args.epochs_stage2, guard=make_guard(), log=train_log,
                        checkpoint_cb=stage2_cb, **kw2)
                else:
                    params = TR.run_stage2(params, mcfg, tcfg, stage2_batches,
                                           epochs=args.epochs_stage2, guard=make_guard(),
                                           log=train_log, checkpoint_cb=stage2_cb, **kw2)
                mgr.save(args.epochs_stage1 + args.epochs_stage2,
                         {"params": params, "stage": 2, "epoch_in_stage": -1})
    finally:
        mgr.close()
    with synced_phase(log, "test", dev):
        cmc, mAP, mINP = evaluate(params)
    maybe_keep_best(args.epochs_stage2, params, float(mAP))
    if best is not None:
        best.close()

    def rank(k):  # the gallery may be smaller than max_rank
        return float(cmc[min(k - 1, len(cmc) - 1)])

    log.log("result", mAP=float(mAP), rank1=rank(1), rank5=rank(5), rank10=rank(10),
            mINP=float(mINP), host=0)
    print(f"Rank@1: {rank(1):.4f}, Rank@5: {rank(5):.4f}, "
          f"Rank@10: {rank(10):.4f}, mAP: {mAP:.4f}, mINP: {mINP:.4f}")
    log.close()
    return cmc, mAP


if __name__ == "__main__":
    main()
