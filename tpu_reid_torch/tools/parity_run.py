"""One-command parity harness (the port of tpu_reid/tools/parity_run.py).

Runs the zero-shot Market-1501 retrieval protocol through BOTH
  A. the port's tail (retrieval.Evaluator: distmat and CMC/mAP on the
     device), and
  B. an independent numpy re-implementation of the reference's evaluation
     math (reference: evaluate.py:7-13 euclidean distance, evaluate.py:29-88
     market-protocol CMC/mAP), bundled below and shared with no package,
on the SAME features, extracted once through the port's zero-shot path (on
the card: the block kernels and the CLS tail). It prints both result sets
and their absolute differences, fails if they differ by more than
--tolerance, and with --baseline records them under the file's "published"
field.

    python -m tpu_reid_torch.tools.parity_run --root /data/market1501 \\
        --model_path ViT-B-16.pt --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --attributes market_attribute.mat --augmented_template \\
        --baseline results.json

--synthetic runs the same code end to end on a generated Market-layout
workload with a small random CLIP checkpoint. It runs on the card unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from tpu_reid_torch.device import full_fp32_convs

# extraction runs in bf16, as the JAX harness's does
EXTRACT_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Tail B: the reference's evaluation math, re-implemented in numpy.
# ---------------------------------------------------------------------------


def ref_euclidean_distmat(qf: np.ndarray, gf: np.ndarray) -> np.ndarray:
    """Squared-euclidean query x gallery distances, the addmm identity the
    reference uses (evaluate.py:7-13): ||q||^2 + ||g||^2 - 2 q.g^T."""
    qf = np.asarray(qf, np.float32)
    gf = np.asarray(gf, np.float32)
    q2 = np.square(qf).sum(axis=1)[:, None]
    g2 = np.square(gf).sum(axis=1)[None, :]
    return q2 + g2 - 2.0 * (qf @ gf.T)


def ref_cmc_map(distmat: np.ndarray, q_pids: np.ndarray, g_pids: np.ndarray,
                q_camids: np.ndarray, g_camids: np.ndarray, max_rank: int = 50):
    """Market-1501 protocol CMC + mAP (reference: evaluate.py:29-88).

    Per query: sort the gallery by distance, drop same-pid/same-camera
    rows, CMC = first-hit indicator cumulated, AP = mean precision at the
    positive positions. Queries with no cross-camera positive are skipped.
    A query whose filter leaves fewer than max_rank rows has its curve
    padded with its last value (the reference's galleries dwarf max_rank;
    small synthetic ones do not). Returns (cmc[max_rank], mAP) as float64."""
    n_q, n_g = distmat.shape
    max_rank = min(max_rank, n_g)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)

    cmc_sum = np.zeros(max_rank, np.float64)
    aps = []
    for qi in range(n_q):
        order = np.argsort(distmat[qi])
        keep = ~((g_pids[order] == q_pids[qi]) & (g_camids[order] == q_camids[qi]))
        hits = (g_pids[order][keep] == q_pids[qi]).astype(np.float64)
        n_rel = hits.sum()
        if n_rel == 0:  # the query's identity is absent from the cross-camera gallery
            continue
        found = np.minimum(np.cumsum(hits), 1.0)
        if found.size < max_rank:
            found = np.pad(found, (0, max_rank - found.size), constant_values=found[-1])
        cmc_sum += found[:max_rank]
        precision = np.cumsum(hits) / np.arange(1, hits.size + 1)
        aps.append(float((precision * hits).sum() / n_rel))
    if not aps:
        raise ValueError("no query identity appears in the gallery")
    return cmc_sum / len(aps), float(np.mean(aps))


# ---------------------------------------------------------------------------
# synthetic assets
# ---------------------------------------------------------------------------


def _tiny_clip_sd(rng: np.random.RandomState) -> dict:
    """Small random CLIP state dict in the OpenAI key layout (shape contract
    reference: coop.py:441-466), the JAX harness's, draw for draw."""
    sd = {}
    vw, vl, tw, tl, emb, patch, grid, ctx, vocab = 64, 2, 128, 2, 32, 8, 4, 77, 520

    def blocks(prefix, width, layers):
        s = width ** -0.5
        for i in range(layers):
            pre = f"{prefix}.{i}"
            sd[f"{pre}.attn.in_proj_weight"] = rng.randn(3 * width, width) * s
            sd[f"{pre}.attn.in_proj_bias"] = np.zeros(3 * width)
            sd[f"{pre}.attn.out_proj.weight"] = rng.randn(width, width) * s * 0.5
            sd[f"{pre}.attn.out_proj.bias"] = np.zeros(width)
            sd[f"{pre}.ln_1.weight"] = np.ones(width)
            sd[f"{pre}.ln_1.bias"] = np.zeros(width)
            sd[f"{pre}.ln_2.weight"] = np.ones(width)
            sd[f"{pre}.ln_2.bias"] = np.zeros(width)
            sd[f"{pre}.mlp.c_fc.weight"] = rng.randn(4 * width, width) * s
            sd[f"{pre}.mlp.c_fc.bias"] = np.zeros(4 * width)
            sd[f"{pre}.mlp.c_proj.weight"] = rng.randn(width, 4 * width) * s
            sd[f"{pre}.mlp.c_proj.bias"] = np.zeros(width)

    s = vw ** -0.5
    sd["visual.conv1.weight"] = rng.randn(vw, 3, patch, patch) * s
    sd["visual.class_embedding"] = rng.randn(vw) * s
    sd["visual.positional_embedding"] = rng.randn(grid * grid + 1, vw) * s
    sd["visual.ln_pre.weight"] = np.ones(vw)
    sd["visual.ln_pre.bias"] = np.zeros(vw)
    blocks("visual.transformer.resblocks", vw, vl)
    sd["visual.ln_post.weight"] = np.ones(vw)
    sd["visual.ln_post.bias"] = np.zeros(vw)
    sd["visual.proj"] = rng.randn(vw, emb) * s
    sd["token_embedding.weight"] = rng.randn(vocab, tw) * 0.02
    sd["positional_embedding"] = rng.randn(ctx, tw) * 0.01
    blocks("transformer.resblocks", tw, tl)
    sd["ln_final.weight"] = np.ones(tw)
    sd["ln_final.bias"] = np.zeros(tw)
    sd["text_projection"] = rng.randn(tw, emb) * tw ** -0.5
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def make_synthetic_assets(out_dir: str, seed: int = 0) -> dict:
    """Market-layout images, a tiny checkpoint and BPE merges under
    out_dir: the JAX harness's files from the same seed."""
    from tpu_reid_torch.models.tokenizer import write_test_merges
    from tpu_reid_torch.tools.synth_market import write_images

    rng = np.random.RandomState(seed)
    write_images(os.path.join(out_dir, "Market1501"), rng, n_train_ids=4, n_test_ids=6,
                 n_query=12, n_gallery=48, hw=(64, 32))
    ckpt = os.path.join(out_dir, "tiny_clip.pth")
    sd = _tiny_clip_sd(np.random.RandomState(seed + 1))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    merges = os.path.join(out_dir, "merges.txt.gz")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("o", "f</w>")])
    return {"root": out_dir, "model_path": ckpt, "bpe_path": merges}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def run_parity(args) -> dict:
    """Extract once through the port's zero-shot path, score with both
    tails, compare; returns the result record."""
    from tpu_reid_torch.data import attributes as A
    from tpu_reid_torch.data.datasets import get_dataset
    from tpu_reid_torch.data.loader import BatchLoader
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.device import resolve_device
    from tpu_reid_torch.models.tokenizer import ClipTokenizer
    from tpu_reid_torch.models.vit import fold_visual_input_norm
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.pipelines import zero_shot as Z
    from tpu_reid_torch.weights.convert import convert_clip, load_state_dict

    dev = resolve_device(args.device)
    h, w = args.height, int(args.height * args.ratio)
    cfg, params = convert_clip(load_state_dict(args.model_path), image_hw=(h, w),
                               stride=args.stride, device=dev)
    model_type = "vit" if cfg.vision is not None else "rn"

    dataset = get_dataset(args.root, args.test_dataset)
    zs_weights = None
    if args.mm:
        tokenizer = ClipTokenizer(args.bpe_path)
        if args.attributes:
            if args.augmented_template:
                ids, templates = A.get_prompts_augmented(args.attributes)
            else:
                ids, templates = A.get_prompts(args.attributes)
        else:
            n = len({r[1] for r in dataset.query + dataset.gallery})
            ids, templates = A.get_prompts_simple([str(i) for i in range(n)], n)
        zs_weights = Z.zeroshot_classifier(
            params, cfg, tokenizer, ids, templates,
            augmented=args.augmented_template or not args.attributes, device=dev)

    pp = DevicePreprocess((h, w), model_type, dtype=EXTRACT_DTYPE)
    fold = None
    if model_type == "vit":
        fold = lambda p: dict(p, visual=fold_visual_input_norm(p["visual"], model_type))  # noqa: E731
    extractor = make_extractor(Z.make_zeroshot_embed(params, cfg), pp,
                               flip_tta=not args.no_flip_tta, dtype=EXTRACT_DTYPE, fold=fold,
                               device=dev)
    g_feats, g_pids, g_cams, _ = extract_embeddings(
        extractor, params, BatchLoader(dataset.gallery, args.bs, (h, w)), device=dev)
    q_feats, q_pids, q_cams, _ = extract_embeddings(
        extractor, params, BatchLoader(dataset.query, args.bs, (h, w)), device=dev)

    # tail A: the port's Evaluator on the device
    cmc_a, map_a, minp_a = Z.evaluate_zero_shot(
        q_feats, g_feats, q_pids, g_pids, q_cams, g_cams, zs_weights=zs_weights,
        proj_dim=cfg.embed_dim, multimodal=args.mm, max_rank=args.max_rank, reranking=False,
        with_minp=True, device=dev)
    cmc_a = np.asarray(cmc_a, np.float64)

    # tail B: the reference's math in numpy on the same features
    qf, gf = q_feats, g_feats
    if args.mm:
        qf = Z.mm_embeddings(qf, cfg.embed_dim, zs_weights)
        gf = Z.mm_embeddings(gf, cfg.embed_dim, zs_weights)
    qf = qf.float().cpu().numpy()
    gf = gf.float().cpu().numpy()
    # feat_norm=True in the reference protocol (evaluate.py:112-115)
    qf = qf / np.maximum(np.linalg.norm(qf, axis=1, keepdims=True), 1e-12)
    gf = gf / np.maximum(np.linalg.norm(gf, axis=1, keepdims=True), 1e-12)
    cmc_b, map_b = ref_cmc_map(ref_euclidean_distmat(qf, gf), q_pids, g_pids, q_cams, g_cams,
                               max_rank=args.max_rank)

    def rank(cmc, k):
        return float(cmc[min(k - 1, len(cmc) - 1)])

    fw = {"mAP": float(map_a), "rank1": rank(cmc_a, 1), "rank5": rank(cmc_a, 5),
          "rank10": rank(cmc_a, 10), "mINP": float(minp_a)}
    refm = {"mAP": float(map_b), "rank1": rank(cmc_b, 1), "rank5": rank(cmc_b, 5),
            "rank10": rank(cmc_b, 10)}
    diffs = {k: abs(fw[k] - refm[k]) for k in refm}
    result = {
        "dataset": args.test_dataset,
        "checkpoint": os.path.basename(args.model_path),
        "n_query": int(len(q_pids)),
        "n_gallery": int(len(g_pids)),
        "protocol": "zero-shot euclidean ranking, flip-TTA" + (", mm" if args.mm else ""),
        "synthetic": bool(args.synthetic),
        "device": str(dev),
        "framework": fw,
        "reference_math": refm,
        "abs_diff": diffs,
        "max_abs_diff": max(diffs.values()),
    }
    print(json.dumps(result, indent=2))
    if result["max_abs_diff"] > args.tolerance:
        raise RuntimeError(f"parity FAILED: framework vs reference math differ by "
                           f"{result['max_abs_diff']:.6f} > {args.tolerance} ({diffs})")
    if args.baseline:
        try:
            with open(args.baseline) as f:
                baseline = json.load(f)
        except FileNotFoundError:
            baseline = {}
        key = args.test_dataset + ("_synthetic" if args.synthetic else "")
        baseline.setdefault("published", {})[key] = result
        with open(args.baseline, "w") as f:
            json.dump(baseline, f, indent=2)
        print(f"wrote published[{key!r}] -> {args.baseline}")
    return result


def params_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", type=str, default=None,
                   help="dataset root (contains Market1501/ etc.)")
    p.add_argument("--model_path", type=str, default=None,
                   help="OpenAI CLIP checkpoint (.pt jit archive or .pth)")
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--attributes", type=str, default=None)
    p.add_argument("--augmented_template", action="store_true")
    p.add_argument("--mm", action="store_true")
    p.add_argument("--test_dataset", default="market1501")
    p.add_argument("--bs", default=64, type=int)
    p.add_argument("--height", default=224, type=int)
    p.add_argument("--ratio", default=0.5, type=float)
    p.add_argument("--stride", default=12, type=int)
    p.add_argument("--max_rank", default=50, type=int)
    p.add_argument("--no_flip_tta", action="store_true")
    p.add_argument("--tolerance", default=2e-3, type=float,
                   help="max |framework - reference math| over mAP and ranks (same "
                        "features; covers fp32-vs-device distmat accumulation differences)")
    p.add_argument("--baseline", type=str, default=None,
                   help="JSON file to record the result in, under 'published'")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a Market-layout workload and a tiny checkpoint and run the "
                        "same code path on them")
    p.add_argument("--synthetic_dir", type=str, default=None,
                   help="with --synthetic: directory for the generated assets (default: a "
                        "fresh temporary directory)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None):
    full_fp32_convs()
    args = params_parser().parse_args(argv)
    if args.synthetic:
        out = args.synthetic_dir or tempfile.mkdtemp(prefix="parity_synth_")
        assets = make_synthetic_assets(out)
        args.root = assets["root"]
        args.model_path = assets["model_path"]
        args.bpe_path = args.bpe_path or assets["bpe_path"]
        args.height = 64
        args.stride = 8
    missing = [k for k in ("root", "model_path") if not getattr(args, k)]
    if missing:
        raise SystemExit(f"missing required arguments: {missing} (or --synthetic)")
    return run_parity(args)


if __name__ == "__main__":
    main()
