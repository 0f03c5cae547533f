"""Zero-shot ReID evaluation CLI of the PyTorch/CUDA port.

The flag surface and the result line of tpu_reid/cli/zero_shot.py (--root
--bs --model_path --augmented_template --height --ratio --mm --clip_weights
--training_mode --test_dataset --rerank, plus the explicit asset paths
--bpe_path and --attributes), and one flag of its own: --device (default
cuda; `--device cpu` runs the plain PyTorch versions on the host).

    python -m tpu_reid_torch.cli.zero_shot --root /data --model_path ViT-B-16.pt \\
        --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --attributes market_attribute.mat --augmented_template --mm --rerank

A ModifiedResNet (RN50-style) checkpoint is recognised by its shapes and
runs with ImageNet input statistics, its embedding cat(mean of the layer-4
map, the attention-pooled token); the input normalisation is folded into the
patch embed for a ViT only, as in the JAX CLI.

Several devices (parallel/launch.py: one process per device, a "data" mesh):
--devices N runs N ranks on this host (NCCL on cards, one rank per card;
gloo with --device cpu); each decodes and embeds only its rows of every
global batch, the features are gathered once, and with --rerank the
streamed route shards its passes over the ranks. --multihost HOST:PORT
--num_hosts H --host_id h joins the ranks of H hosts (each running this
command with its --devices) at HOST:PORT. --bs must divide by the global
number of ranks. Rank 0 prints the result.

Tensor parallelism (parallel/tp.py): --tp T runs --devices x T ranks on a
("data", "model") mesh; each model group of T ranks splits the ViT tower's
heads and MLP hidden units (the block kernels on the rank's slice, two fp32
all-reduces per block) and takes the same rows of every batch, while
extraction and the evaluation run over the data axis. As in the JAX CLI,
the TP route folds no input normalisation, the text classifier stays
replicated, --multihost refuses --tp > 1 ("--multihost shards the batch axis
only") and a ResNet tower refuses it ("--tp shards the ViT tower only").

Refused: --training_mode ivlp with a ViT checkpoint that carries no IVLP
prompt tokens (the JAX CLI fails on it): such tokens come from the
prompt-learning CLI.
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
                   help="ranks on this host, one per device: extraction and the streamed "
                        "re-ranking shard over them")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel width of the ViT tower over the 'model' mesh axis "
                        "(ranks = devices * tp)")
    p.add_argument("--multihost", default=None, type=str, metavar="HOST:PORT",
                   help="multi-host extraction: the rendezvous address of the ranks of "
                        "every host (run this command on each with --num_hosts/--host_id)")
    p.add_argument("--num_hosts", default=1, type=int,
                   help="with --multihost: the number of hosts")
    p.add_argument("--host_id", default=0, type=int,
                   help="with --multihost: this host's index")
    p.add_argument("--no_flip_tta", action="store_true")
    p.add_argument("--fast_softmax", action="store_true",
                   help="throughput profile for the attention softmax "
                        "(ops.attention.set_fast_softmax)")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def check_world(args) -> None:
    """--bs must divide by the global number of ranks of the data axis (the
    JAX CLIs' messages)."""
    if args.multihost:
        world = args.devices * args.num_hosts
        if args.bs % world:
            raise ValueError(f"--bs {args.bs} must divide by the {world} global devices")
    elif args.bs % args.devices:
        raise ValueError(f"--bs {args.bs} must divide by --devices {args.devices}")


def main(argv=None):
    """Parse the flags and run the CLI on every rank; returns rank 0's
    (cmc, mAP)."""
    from tpu_reid_torch.device import full_fp32_convs
    from tpu_reid_torch.parallel import launch

    full_fp32_convs()
    args = params_parser(argv)
    check_world(args)
    return launch.run(run, (args,), devices=args.devices, device=args.device,
                      multihost=args.multihost, num_hosts=args.num_hosts,
                      host_id=args.host_id, tp=args.tp)


def run(mesh, args):
    """The CLI on one rank (`mesh` None on a single device)."""
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
    from tpu_reid_torch.parallel.multihost import extract_embeddings_multihost
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.runtime.observe import MetricLogger
    from tpu_reid_torch.weights.convert import (
        convert_clip, load_state_dict, overlay_clip_reid,
    )

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # rank 0 alone logs and prints
    if args.fast_softmax:
        set_fast_softmax(True)
    log = MetricLogger(args.log_dir if lead else None, console=lead)
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
        model_type = "vit" if cfg.vision is not None else "rn"
        if args.tp > 1 and model_type != "vit":
            raise ValueError("--tp shards the ViT tower only")
        if (model_type == "vit" and design.has_vision_prompts
                and "vpt_shallow" not in params["visual"]):
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
        pp = DevicePreprocess((h, w), model_type, dtype=EXTRACT_DTYPE)
        xtr_params = params
        if args.tp > 1:
            # batch over "data", the tower's heads and hidden units over
            # "model": this rank keeps its slice of the blocks (no fold)
            from tpu_reid_torch.parallel import tp as TP

            xtr_params = TP.shard_tp_visual(
                TP.tp_visual_layout(params["visual"], cfg.vision.heads), mesh.model_rank,
                mesh.model_size)
            extractor = TP.make_tp_extractor(mesh, cfg.vision, pp, flip_tta=not args.no_flip_tta,
                                             dtype=EXTRACT_DTYPE)
        else:
            fold = None
            if model_type == "vit":
                # normalization folded into the patch-embed weights (exact)
                fold = lambda p: dict(p, visual=fold_visual_input_norm(p["visual"], "vit"))  # noqa: E731
            extractor = make_extractor(Z.make_zeroshot_embed(params, cfg), pp,
                                       flip_tta=not args.no_flip_tta, dtype=EXTRACT_DTYPE,
                                       fold=fold, device=dev, mesh=mesh)

        def sweep(records):
            if mesh is not None:  # each rank decodes only its rows
                return extract_embeddings_multihost(extractor, xtr_params, records, args.bs,
                                                    (h, w), mesh)
            return extract_embeddings(extractor, xtr_params,
                                      BatchLoader(records, args.bs, (h, w)), device=dev)

        g_feats, g_pids, g_cams, _ = sweep(dataset.gallery)
        q_feats, q_pids, q_cams, _ = sweep(dataset.query)
        log.log("extracted", gallery=len(g_pids), query=len(q_pids))

    # the weights are dead after extraction; re-ranking wants the memory
    del extractor, params, xtr_params, sd

    with log.phase("evaluate"):
        cmc, mAP, mINP = Z.evaluate_zero_shot(
            q_feats, g_feats, q_pids, g_pids, q_cams, g_cams,
            zs_weights=zs_weights, proj_dim=cfg.embed_dim, multimodal=args.mm,
            max_rank=50, reranking=args.rerank, mesh=mesh, with_minp=True, device=dev,
            log=log,
        )

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
