"""Multitask prompt-learning CLI of the PyTorch/CUDA port: two datasets, one
shared CLIP trunk, then flip-TTA extraction and CMC/mAP/mINP on the test
dataset. The three reference multitask entry points:

  --variant soft      one model over the merged label space of both train
                      sets (data/datasets.merge_datasets), on the
                      single-task trainers; --training_mode picks the mode
  --variant hard      shared trunk, per-dataset prompt learners, heads and
                      XBM memories (train/multitask.py)
  --variant hard_ivlp + IVLP prompt tokens, a second text tower, and a
                      second geometry for dataset 2 (--height_multitask,
                      --ratio_multitask)

The flags of tpu_reid/cli/multitask.py, plus --device (default cuda;
`--device cpu` runs the plain PyTorch versions on the host):

    python -m tpu_reid_torch.cli.multitask --root /data --variant hard_ivlp \\
        --model_path ViT-B-16.pt --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --train_dataset market1501 --train_dataset_multitask veri \\
        --height 256 --ratio 0.5 --height_multitask 256 --ratio_multitask 1.0

Checkpoints (runtime/checkpoint.py) go under
<save_path>/<variant>/<training_mode>/<dataset>_<dataset_multitask>, every
20 epochs and at the end of each stage, with the optimizer state, the GPA
sum and the XBM banks beside them; --resume continues from the newest one,
--keep_best keeps the best evaluated parameters under .../best.
--cache_device keeps each training split on the device, one
data/device_cache.DeviceImageCache per (dataset, size): stage 2's PK batches
gather their images there (same orders, same draws: the flag changes no
result); stage 1's batches stay on the loader, as in the JAX package.

--devices N / --multihost HOST:PORT --num_hosts H --host_id h: the ranks of
a "data" mesh (parallel/launch.py; NCCL on cards, gloo with --device cpu),
as in the prompt-learning CLI: every rank reads the global batch's labels
and encodes its rows of the images, the caches are sharded over the ranks,
and rank 0 alone logs, writes the checkpoints and prints the result. --bs
must divide by the global number of ranks; --cache_device with --multihost
is refused, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--height_multitask", default=None, type=int)
    p.add_argument("--ratio_multitask", default=None, type=float)
    p.add_argument("--stride", default=12, type=int)
    p.add_argument("--epochs_stage1", default=120, type=int)
    p.add_argument("--epochs_stage2", default=60, type=int)
    p.add_argument("--variant", default="hard", type=str, choices=["soft", "hard", "hard_ivlp"])
    p.add_argument("--training_mode", default="coop", type=str,
                   choices=["coop", "ivlp", "promptsrc", "adapter"],
                   help="soft variant only; the hard variants fix their mode (coop / ivlp)")
    p.add_argument("--vpt_ctx", default=2, type=int)
    p.add_argument("--devices", default=1, type=int)
    p.add_argument("--dtype", default="fp32", type=str, choices=["fp32", "bf16"],
                   help="activation dtype for training; the parameters stay fp32 master "
                        "weights (bf16 engages the bf16 kernels)")
    p.add_argument("--train_dataset", default="market1501", type=str)
    p.add_argument("--train_dataset_multitask", default="dukemtmc", type=str)
    p.add_argument("--test_dataset", default=None, type=str)
    p.add_argument("--save_path", default="./checkpoints", type=str)
    p.add_argument("--eval_every", default=0, type=int,
                   help="evaluate retrieval every N stage-2 epochs (0: only at the end)")
    p.add_argument("--keep_best", action="store_true",
                   help="keep the best-mAP parameters among the evaluated ones under "
                        "<save_path>/.../best")
    p.add_argument("--multihost", default=None, type=str, metavar="HOST:PORT")
    p.add_argument("--num_hosts", default=1, type=int)
    p.add_argument("--host_id", default=0, type=int)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint (same epoch counts)")
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--fast_softmax", action="store_true",
                   help="throughput profile for the attention softmax "
                        "(ops.attention.set_fast_softmax)")
    p.add_argument("--cache_device", action="store_true")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def check_flags(args) -> None:
    """Raise for a --bs that does not divide by the global ranks and for
    --cache_device with --multihost (the JAX CLI's assertions)."""
    from tpu_reid_torch.cli.zero_shot import check_world

    check_world(args)
    if args.cache_device and args.multihost:
        raise ValueError("--cache_device is a single-process feature (no --multihost)")


def geometries(args):
    """((h1, w1), (h2, w2)): dataset 2's defaults to dataset 1's."""
    h2 = args.height_multitask or args.height
    return ((args.height, int(args.height * args.ratio)),
            (h2, int(h2 * (args.ratio_multitask or args.ratio))))


def build_model(args, n1: int, n2: int, device=None):
    """Load and convert CLIP and assemble the variant's model: (config,
    params on `device`). The config is a ReidModelConfig over n1 + n2
    classes for the soft variant, a MultitaskModelConfig otherwise."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.device import clone
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.models.tokenizer import ClipTokenizer
    from tpu_reid_torch.train import multitask as MT
    from tpu_reid_torch.weights.convert import convert_clip, init_vpt, load_state_dict

    (h1, w1), (h2, w2) = geometries(args)
    soft = args.variant == "soft"
    mode = args.training_mode if soft else ("ivlp" if args.variant == "hard_ivlp" else "coop")
    design = PromptDesign()
    if mode in ("ivlp", "promptsrc"):
        design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=args.vpt_ctx,
                              language_depth=12, language_ctx=args.vpt_ctx)
    cfg1, clip_params = convert_clip(load_state_dict(args.model_path), image_hw=(h1, w1),
                                     stride=args.stride, design=design, device=device)
    if design.has_vision_prompts:
        clip_params = init_vpt(torch.Generator().manual_seed(1), cfg1, clip_params)
    tokenizer = ClipTokenizer(args.bpe_path)
    ctx_len = cfg1.text.context_length
    table = clip_params["text"]["token_embedding"]

    def template(dataset):
        tokens = np.asarray(tokenizer.tokenize(P.base_template(dataset),
                                               context_length=ctx_len))
        return table[torch.as_tensor(tokens, dtype=torch.long, device=table.device)], tokens

    mk = (P.PromptLearnerConfig.coop if mode in ("coop", "adapter")
          else P.PromptLearnerConfig.ivlp)
    gen = torch.Generator().manual_seed(args.seed)
    if soft:
        mcfg = M.ReidModelConfig(mode=mode, clip=cfg1, prompt=mk(n1 + n2))
        zs = None
        if mode == "promptsrc":  # the teacher is a copy of the pretrained tower
            zs = clone({k: v for k, v in clip_params["visual"].items()
                        if not k.startswith("vpt_")})
        return mcfg, M.init_reid_model(gen, mcfg, clip_params, *template(args.train_dataset),
                                       zs_visual_params=zs)
    hg, wg = cfg1.vision.grid_for((h2, w2), cfg1.vision.patch_size, args.stride)
    cfg2 = dataclasses.replace(cfg1, vision=dataclasses.replace(cfg1.vision, h_grid=hg,
                                                                 w_grid=wg))
    mcfg = MT.MultitaskModelConfig(variant=args.variant, clip=cfg1, clip2=cfg2,
                                   prompt1=mk(n1), prompt2=mk(n2))
    return mcfg, MT.init_multitask_model(gen, mcfg, clip_params,
                                         *template(args.train_dataset),
                                         *template(args.train_dataset_multitask))


def main(argv=None):
    """Parse the flags and run the CLI on every rank; returns rank 0's
    (cmc, mAP)."""
    from tpu_reid_torch.device import full_fp32_convs
    from tpu_reid_torch.parallel import launch

    full_fp32_convs()
    args = params_parser(argv)
    check_flags(args)
    args.test_dataset = args.test_dataset or args.train_dataset
    return launch.run(run, (args,), devices=args.devices, device=args.device,
                      multihost=args.multihost, num_hosts=args.num_hosts,
                      host_id=args.host_id)


def run(mesh, args):
    """The CLI on one rank (`mesh` None on a single device)."""

    from tpu_reid_torch.data.datasets import get_dataset, merge_datasets
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.sampler import PKSampler
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.device import resolve_device
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.parallel.mesh import shard_batch
    from tpu_reid_torch.parallel.multihost import extract_embeddings_multihost
    from tpu_reid_torch.retrieval.metrics import Evaluator
    from tpu_reid_torch.runtime.checkpoint import (
        BestKeeper, CheckpointManager, fresh_start, two_stage_cb, two_stage_resume,
    )
    from tpu_reid_torch.runtime.guard import TrainGuard
    from tpu_reid_torch.runtime.observe import MetricLogger, synced_phase
    from tpu_reid_torch.train import multitask as MT
    from tpu_reid_torch.train import trainer as TR

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # rank 0 alone logs and prints
    # under a mesh a batch carries this rank's rows of the images
    rows = (lambda x: x) if mesh is None else (lambda x: shard_batch(mesh, x))
    if args.fast_softmax:
        set_fast_softmax(True)
    log = MetricLogger(args.log_dir if lead else None, console=lead)
    (h1, w1), (h2, w2) = geometries(args)
    ds1 = get_dataset(args.root, args.train_dataset)
    ds2 = get_dataset(args.root, args.train_dataset_multitask)
    n1, n2 = ds1.num_train_pids, ds2.num_train_pids
    mcfg, params = build_model(args, n1, n2, device=dev)
    log.log("model", variant=args.variant, n1=n1, n2=n2, hw1=f"{h1}x{w1}", hw2=f"{h2}x{w2}")
    tcfg = TR.TrainConfig(epochs_stage1=args.epochs_stage1, epochs_stage2=args.epochs_stage2)
    # bf16 activations over fp32 master weights
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    pp1 = DevicePreprocess((h1, w1), "vit", dtype=dtype)
    pp2 = DevicePreprocess((h2, w2), "vit", dtype=dtype)

    def eval_batches(records, pp, epoch):
        # stage 1 consumes the deterministic eval transform, shuffled order
        # (epoch 0: the sequential pass of the coop/adapter precompute)
        loader = BatchLoader(records, args.bs, pp.size_hw, order="shuffle" if epoch > 0 else None,
                             seed=args.seed + 7919 * epoch)
        for b in loader:
            yield (pp.eval_batch(torch.as_tensor(rows(b.images)).to(dev)),
                   torch.as_tensor(b.pids).to(dev), b.valid)

    caches = {}
    if args.cache_device:
        # both training splits on the device once; stage 2's batches become
        # a gather there (data/device_cache.py)
        from tpu_reid_torch.data.device_cache import DeviceImageCache

        for ds_, pp_ in ((ds1, pp1), (ds2, pp2)):
            t0 = time.perf_counter()
            c = caches[(ds_.name, pp_.size_hw)] = DeviceImageCache(ds_.train, pp_.size_hw,
                                                                   device=dev, mesh=mesh)
            log.log("cache_device", dataset=ds_.name, n=c.n, mb=round(c.nbytes() / 2**20, 1),
                    upload_s=round(time.perf_counter() - t0, 1), sharded=mesh is not None)

    def train_batches(dataset, pp, epoch, offset=0):
        # PK batches with the train augmentation, its draws from a stream of
        # their own per (dataset, epoch)
        labels = [r[1] for r in dataset.train]
        sampler = PKSampler(labels, args.bs, 4, seed=args.seed + epoch)
        tag = sum(map(ord, dataset.name)) & 0xFFFF
        gen = torch.Generator(device=dev).manual_seed(
            args.seed * 1_000_003 + ((tag << 14) | (epoch & 0x3FFF)))
        cache = caches.get((dataset.name, pp.size_hw))
        # the global batch's draws on every rank, each taking its rows (a
        # sharded cache's gather gives this rank's rows)
        if cache is not None:
            for sel, pids, _camids, valid in cache.epoch_index_batches(sampler.epoch(), args.bs):
                imgs = pp.train_batch(cache.gather(sel), rows(pp.train_draws(gen, args.bs)),
                                      pad_hw=(10, 10))
                yield imgs, torch.as_tensor(pids).to(dev) + offset, valid
            return
        for b in BatchLoader(dataset.train, args.bs, pp.size_hw, order=sampler.epoch(),
                             seed=args.seed + epoch):
            imgs = pp.train_batch(torch.as_tensor(rows(b.images)).to(dev),
                                  rows(pp.train_draws(gen, b.images.shape[0])),
                                  pad_hw=(10, 10))
            yield imgs, torch.as_tensor(b.pids).to(dev) + offset, b.valid

    ckpt_dir = os.path.join(args.save_path, args.variant, args.training_mode,
                            f"{args.train_dataset}_{args.train_dataset_multitask}")
    mgr = CheckpointManager(ckpt_dir, save_interval=20, mesh=mesh)

    def make_guard():
        return TrainGuard(snapshot_every=50, max_restores=3,
                          log=lambda s: log.log("guard", msg=s))

    best = (BestKeeper(os.path.join(ckpt_dir, "best"), log.log, mesh=mesh) if args.keep_best
            else None)

    def maybe_keep_best(epoch: int, p, m: float):
        if best is not None:
            best.offer(epoch, p, m)

    # the variant branch sets eval_state["embed"] before its stage 2
    eval_state: dict = {}

    def evaluate(eval_params):
        if "xtr" not in eval_state:
            eval_state["ds"] = get_dataset(args.root, args.test_dataset)
            eval_state["pp"] = pp1 if args.test_dataset == args.train_dataset else pp2

            def fold(p):  # input normalization folded into the patch embed (exact)
                return dict(p, clip=dict(p["clip"], visual=fold_visual_input_norm(
                    p["clip"]["visual"], "vit")))

            eval_state["xtr"] = make_extractor(eval_state["embed"], eval_state["pp"],
                                               flip_tta=True, dtype=EXTRACT_DTYPE, fold=fold,
                                               device=dev, mesh=mesh)
        test_ds, extractor = eval_state["ds"], eval_state["xtr"]
        hw = eval_state["pp"].size_hw

        def sweep(records):
            if mesh is not None:  # each rank decodes only its rows
                return extract_embeddings_multihost(extractor, eval_params, records, args.bs,
                                                    hw, mesh)
            return extract_embeddings(extractor, eval_params, BatchLoader(records, args.bs, hw),
                                      device=dev)

        g_feats, g_pids, g_cams, _ = sweep(test_ds.gallery)
        q_feats, q_pids, q_cams, _ = sweep(test_ds.query)
        ev = Evaluator(num_query=len(q_pids), max_rank=20, feat_norm=True,
                       reranking=args.rerank, mesh=mesh, with_minp=True)
        ev.update(q_feats, q_pids, q_cams)
        ev.update(g_feats, g_pids, g_cams)
        return ev.compute()

    save_stage2 = two_stage_cb(mgr, 1, lambda e: args.epochs_stage1 + e)

    def stage2_cb(epoch, p, state):
        save_stage2(epoch, p, state)
        done = epoch + 1  # stage-2 epochs are 0-based
        if args.eval_every and done % args.eval_every == 0 and done < args.epochs_stage2:
            with synced_phase(log, "eval", dev):
                c, m, i_ = evaluate(p)
            log.log("eval", stage2_epoch=done, mAP=float(m), rank1=float(c[0]),
                    mINP=float(i_))
            maybe_keep_best(done, p, float(m))

    def setup_resume(s1_paths, s2_paths, gpa1_used, gpa2_used, xbms_used=False):
        if not args.resume:
            return (params, 0, *fresh_start(xbms_used))
        out = two_stage_resume(mgr, params, s1_paths, s2_paths, gpa1_used, gpa2_used,
                               xbms_used=xbms_used, log=lambda s: log.log("resume", msg=s))
        log.log("resume", stage=out[1], epoch=mgr.latest_epoch())
        return out

    def end_of_stage(stage, p):
        epoch = args.epochs_stage1 + (args.epochs_stage2 if stage == 2 else 0)
        mgr.save(epoch, {"params": p, "stage": stage, "epoch_in_stage": -1})

    train_log = lambda s: log.log("train", msg=s)  # noqa: E731
    try:  # a write in flight is finished even when training raises
        if args.variant == "soft":
            # one model over n1 + n2 merged classes: dataset 2's rows follow
            # dataset 1's with their labels offset by n1
            merged = merge_datasets(ds1, ds2)
            n_ds1 = len(ds1.train)
            recs1, recs2 = merged.train[:n_ds1], merged.train[n_ds1:]

            def s1(epoch):
                gens = (eval_batches(recs1, pp1, epoch), eval_batches(recs2, pp1, epoch))
                if epoch == 0:  # the cache precompute: dataset 1's rows, then 2's
                    for g in gens:
                        yield from g
                    return
                # one batch of each dataset in turn, draining both
                for _task, b in MT.alternate_longest(*gens):
                    yield b

            def cached_order(epoch, labels):
                # the coop/adapter cached path: shuffle within each dataset's
                # span of the cache, then interleave their batches
                rng = np.random.default_rng((args.seed << 16) + epoch)
                i1 = rng.permutation(n_ds1)
                i2 = n_ds1 + rng.permutation(len(labels) - n_ds1)
                b1 = [i1[i:i + args.bs] for i in range(0, len(i1), args.bs)]
                b2 = [i2[i:i + args.bs] for i in range(0, len(i2), args.bs)]
                return [b for _t, b in MT.alternate_longest(b1, b2)]

            def s2(epoch):
                # both PK loaders walked together, the longer one drains
                for _task, b in MT.chain_tasks_longest(train_batches(ds1, pp1, epoch),
                                                       train_batches(ds2, pp1, epoch, n1)):
                    yield b

            promptsrc = mcfg.mode == "promptsrc"
            params, done_stage, kw1, kw2 = setup_resume(
                lambda p: TR.stage1_leaf_order(p, mcfg), lambda p: TR.stage2_leaf_order(p, mcfg),
                promptsrc, promptsrc)
            if done_stage < 1:
                with synced_phase(log, "stage1", dev):
                    params = TR.run_stage1(params, mcfg, tcfg, s1, epochs=args.epochs_stage1,
                                           seed=args.seed, batch_size=args.bs,
                                           cached_order=cached_order, guard=make_guard(),
                                           checkpoint_cb=two_stage_cb(mgr, 0, lambda e: e),
                                           log=train_log, mesh=mesh, **kw1)
                    end_of_stage(1, params)
            eval_state["embed"] = lambda p, im: M.eval_embed(p, mcfg, im)
            if done_stage < 2:
                with synced_phase(log, "stage2", dev):
                    params = TR.run_stage2(params, mcfg, tcfg, s2, epochs=args.epochs_stage2,
                                           guard=make_guard(), checkpoint_cb=stage2_cb,
                                           log=train_log, mesh=mesh, **kw2)
                    end_of_stage(2, params)
        else:
            def s1(epoch):
                # plain hard drains both loaders; hard_ivlp stops at the shorter
                alt = MT.alternate if args.variant == "hard_ivlp" else MT.alternate_longest
                return alt(eval_batches(ds1.train, pp1, epoch),
                           eval_batches(ds2.train, pp2, epoch))

            def s2(epoch):
                # plain hard: zip_longest; hard_ivlp: zip
                pair = MT.chain_tasks if args.variant == "hard_ivlp" else MT.chain_tasks_longest
                return pair(train_batches(ds1, pp1, epoch), train_batches(ds2, pp2, epoch))

            params, done_stage, kw1, kw2 = setup_resume(
                lambda p: MT.mt_stage1_leaf_order(p, mcfg),
                lambda p: MT.mt_stage2_leaf_order(p, mcfg),
                gpa1_used=args.variant == "hard_ivlp", gpa2_used=True, xbms_used=True)
            if done_stage < 1:
                with synced_phase(log, "stage1", dev):
                    params = MT.run_mt_stage1(params, mcfg, tcfg, s1, epochs=args.epochs_stage1,
                                              guard=make_guard(),
                                              checkpoint_cb=two_stage_cb(mgr, 0, lambda e: e),
                                              log=train_log, mesh=mesh, **kw1)
                    end_of_stage(1, params)
            task = 0 if args.test_dataset == args.train_dataset else 1
            eval_state["embed"] = lambda p, im: MT.eval_embed_mt(p, mcfg, task, im)
            if done_stage < 2:
                with synced_phase(log, "stage2", dev):
                    params = MT.run_mt_stage2(params, mcfg, tcfg, s2, epochs=args.epochs_stage2,
                                              xbm_capacity=2 * args.bs, guard=make_guard(),
                                              checkpoint_cb=stage2_cb, log=train_log,
                                              mesh=mesh, **kw2)
                    end_of_stage(2, params)
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
            mINP=float(mINP), host=args.host_id)
    if lead:
        print(f"Rank@1: {rank(1):.4f}, Rank@5: {rank(5):.4f}, "
              f"Rank@10: {rank(10):.4f}, mAP: {mAP:.4f}, mINP: {mINP:.4f}")
    log.close()
    return cmc, mAP


if __name__ == "__main__":
    main()
