"""Zero-shot ReID evaluation CLI of the PyTorch/CUDA port.

The flag surface and the result line of tpu_reid/cli/zero_shot.py (--root
--bs --model_path --augmented_template --height --ratio --mm --clip_weights
--training_mode --test_dataset --rerank, plus the explicit asset paths
--bpe_path and --attributes), and one flag of its own: --device (default
cuda; `--device cpu` runs the plain PyTorch versions on the host).

    python -m tpu_reid_torch.cli.zero_shot --root /data --model_path ViT-B-16.pt \\
        --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --attributes market_attribute.mat --augmented_template --mm --rerank

Not ported yet, and refused with the slice named: --devices/--tp > 1 and
--multihost (slice 7) and ResNet checkpoints (slice 5). --training_mode ivlp
with a checkpoint that carries no IVLP prompt tokens is refused too (the
JAX CLI fails on it): such tokens come from the prompt-learning CLI.
"""

from __future__ import annotations

import argparse

import torch

# extraction runs in bf16, as the JAX CLI's does
EXTRACT_DTYPE = torch.bfloat16


def params_parser(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default="./", type=str)
    p.add_argument("--bs", default=64, type=int)
    p.add_argument("--model_path", required=True, type=str,
                   help="OpenAI CLIP checkpoint (.pt jit archive or .pth)")
    p.add_argument("--bpe_path", required=True, type=str,
                   help="bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--attributes", default=None, type=str,
                   help="market_attribute.mat (omit for simple templates)")
    p.add_argument("--augmented_template", action="store_true")
    p.add_argument("--height", default=224, type=int)
    p.add_argument("--ratio", default=0.5, type=float)
    p.add_argument("--stride", default=12, type=int)
    p.add_argument("--mm", action="store_true")
    p.add_argument("--clip_weights", type=str, default=None,
                   help="CLIP-ReID checkpoint to overlay (image_encoder.*)")
    p.add_argument("--training_mode", type=str, default="coop",
                   choices=["coop", "ivlp", "promptsrc"])
    p.add_argument("--test_dataset", type=str, default="market1501",
                   choices=["market1501", "dukemtmc", "msmt17", "msmt17_v1",
                            "veri", "vehicleid", "personx"])
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--devices", default=1, type=int,
                   help="data-parallel devices (only 1 in the port so far)")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel width (only 1 in the port so far)")
    p.add_argument("--multihost", default=None, type=str, metavar="HOST:PORT",
                   help="multi-host extraction (not in the port yet)")
    p.add_argument("--num_hosts", default=1, type=int)
    p.add_argument("--host_id", default=0, type=int)
    p.add_argument("--no_flip_tta", action="store_true")
    p.add_argument("--fast_softmax", action="store_true",
                   help="throughput profile for the attention softmax "
                        "(ops.attention.set_fast_softmax)")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = params_parser(argv)
    if args.devices > 1 or args.tp > 1 or args.multihost:
        raise NotImplementedError(
            "--devices/--tp > 1 and --multihost are not ported yet (slice 7 of the port)"
        )

    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.data import attributes as A
    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.device import resolve_device
    from tpu_reid_torch.models.tokenizer import ClipTokenizer
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.ops.attention import set_fast_softmax
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.runtime.observe import MetricLogger
    from tpu_reid_torch.weights.convert import (
        convert_clip, load_state_dict, overlay_clip_reid,
    )

    dev = resolve_device(args.device)
    if args.fast_softmax:
        set_fast_softmax(True)
    log = MetricLogger(args.log_dir)
    h, w = args.height, int(args.height * args.ratio)

    with log.phase("load_weights"):
        sd = load_state_dict(args.model_path)
        if args.clip_weights:
            sd = overlay_clip_reid(sd, load_state_dict(args.clip_weights))
        design = PromptDesign()
        if args.training_mode == "ivlp":
            design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=2,
                                  language_depth=12, language_ctx=2)
        cfg, params = convert_clip(sd, image_hw=(h, w), stride=args.stride, design=design,
                                   device=dev)
        if design.has_vision_prompts and "vpt_shallow" not in params["visual"]:
            raise NotImplementedError(
                "--training_mode ivlp with a checkpoint that carries no IVLP prompt tokens: "
                "the zero-shot CLI evaluates trained tokens only; train them with "
                "tpu_reid_torch.cli.prompt_learning"
            )

    with log.phase("build_classifier"):
        tokenizer = ClipTokenizer(args.bpe_path)
        if args.attributes:
            if args.augmented_template:
                ids, templates = A.get_prompts_augmented(args.attributes)
            else:
                ids, templates = A.get_prompts(args.attributes)
        else:
            probe = get_dataset(args.root, args.test_dataset)
            n = len({r[1] for r in probe.query + probe.gallery})
            ids, templates = A.get_prompts_simple([str(i) for i in range(n)], n)
        zs_weights = Z.zeroshot_classifier(
            params, cfg, tokenizer, ids, templates,
            augmented=args.augmented_template or not args.attributes, device=dev,
        )

    with log.phase("extract"):
        dataset = get_dataset(args.root, args.test_dataset)
        pp = DevicePreprocess((h, w), "vit", dtype=EXTRACT_DTYPE)
        # normalization folded into the patch-embed weights (exact)
        fold = lambda p: dict(p, visual=fold_visual_input_norm(p["visual"], "vit"))  # noqa: E731
        extractor = make_extractor(Z.make_zeroshot_embed(params, cfg), pp,
                                   flip_tta=not args.no_flip_tta, dtype=EXTRACT_DTYPE,
                                   fold=fold, device=dev)
        g_feats, g_pids, g_cams, _ = extract_embeddings(
            extractor, params, BatchLoader(dataset.gallery, args.bs, (h, w)), device=dev)
        q_feats, q_pids, q_cams, _ = extract_embeddings(
            extractor, params, BatchLoader(dataset.query, args.bs, (h, w)), device=dev)
        log.log("extracted", gallery=len(g_pids), query=len(q_pids))

    # the weights are dead after extraction; re-ranking wants the memory
    del extractor, params, sd

    with log.phase("evaluate"):
        cmc, mAP, mINP = Z.evaluate_zero_shot(
            q_feats, g_feats, q_pids, g_pids, q_cams, g_cams,
            zs_weights=zs_weights, proj_dim=cfg.embed_dim, multimodal=args.mm,
            max_rank=50, reranking=args.rerank, with_minp=True, device=dev, log=log,
        )

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
