"""Entry points of the port (after __graft_entry__.py).

entry() -- the flagship's evaluation-embedding forward and its example
arguments: the IVLP CLIP ViT-B/16 ReID model at 256x128 with overlapping
stride-12 patches and prompt depth 12 (213 vision tokens, 751 classes),
random weights from seed 0, run in bf16 on the card (the block kernels and
the CLS tail). `flagship()` builds that model; chip_smoke.py's phases and
bench-style callers take it from here. tiny=True builds the JAX package's
tiny flagship geometry for the CPU tests.

dryrun_multichip(n) -- one data-parallel training step of each stage over n
gloo ranks on the host's CPU at tiny shapes (parallel/launch.py), then a
sharded extraction sweep and the streamed k-reciprocal re-ranking with
CMC/mAP over the same mesh, each held against the single-device result.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from tpu_reid_torch.device import DeviceLike, full_fp32_convs, resolve_device

# the JAX package's tiny flagship: its tower and text sizes, 16 classes
TINY = dict(image_hw=(32, 16), n_cls=16, vision_width=64, vision_layers=2, patch=8, grid=4,
            text_width=64, text_layers=2, vocab=100, context=12, embed_dim=32, heads=2)


def random_template(cfg, clip: dict, dev):
    """(embedded, token ids) of a prompt template of random tokens between
    the start and end tokens (numpy seed 0)."""
    vocab = cfg.text.vocab_size
    tokens = np.zeros((1, cfg.text.context_length), np.int32)
    tokens[0, 0] = vocab - 2
    tokens[0, 1:10] = np.random.RandomState(0).randint(1, vocab - 2, 9)
    tokens[0, 10] = vocab - 1
    table = clip["text"]["token_embedding"]
    return table[torch.as_tensor(tokens, dtype=torch.long, device=dev)], tokens


def flagship(device: DeviceLike = None, n_cls: int = 751, image_hw=(256, 128),
             seq_len: int = 213, tiny: bool = False):
    """(ReidModelConfig, params) of bench.py's model in the port: IVLP
    ViT-B/16 at 256x128, stride 12, vision and language prompt depth 12 with
    2 context tokens (213 vision tokens), `n_cls` classes; random weights
    from seed 0 (fp32) on `device` (CUDA unless "cpu"). With image_hw
    (256, 256) the same model at the vehicle geometry: a 21x21 patch grid,
    444 vision tokens (seq_len says which geometry the caller expects;
    another raises). tiny=True: the JAX package's tiny flagship
    (__graft_entry__._flagship(tiny=True): 2 blocks of width 64 with 2
    heads in both towers, 32x16 images at stride 8, 16 classes), the other
    arguments ignored."""
    from tpu_reid_torch.configs import PromptDesign
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.weights.convert import convert_clip, init_vpt, random_clip_state_dict

    dev = resolve_device(device)
    design = PromptDesign(trainer="IVLP", vision_depth=12, vision_ctx=2, language_depth=12,
                          language_ctx=2)
    if tiny:
        t = TINY
        sd = random_clip_state_dict(0, vision_width=t["vision_width"],
                                    vision_layers=t["vision_layers"], patch=t["patch"],
                                    grid=t["grid"], text_width=t["text_width"],
                                    text_layers=t["text_layers"], vocab=t["vocab"],
                                    context=t["context"], embed_dim=t["embed_dim"])
        cfg, clip = convert_clip(sd, image_hw=t["image_hw"], stride=t["patch"], design=design,
                                 device=dev)
        # the shapes do not carry the head count: JAX's tiny towers have 2
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, n_heads=t["heads"]),
                                  text=dataclasses.replace(cfg.text, heads=t["heads"]))
        n_cls, seq_len = t["n_cls"], cfg.vision.seq_len
    else:
        cfg, clip = convert_clip(random_clip_state_dict(0), image_hw=image_hw, stride=12,
                                 design=design, device=dev)
    clip = init_vpt(torch.Generator().manual_seed(0), cfg, clip)
    mcfg = M.ReidModelConfig(mode="ivlp", clip=cfg, prompt=P.PromptLearnerConfig.ivlp(n_cls))
    params = M.init_reid_model(torch.Generator().manual_seed(0), mcfg, clip,
                               *random_template(cfg, clip, dev))
    if cfg.vision.seq_len != seq_len:
        raise ValueError(f"unexpected IVLP geometry {cfg.vision}: {cfg.vision.seq_len} tokens, "
                         f"expected {seq_len}")
    return mcfg, params


def entry(tiny: bool = False, dtype: torch.dtype = torch.bfloat16,
          device: DeviceLike = None):
    """(fn, example_args): fn(params, images) is the flagship's eval_embed
    on images cast to `dtype` (bf16, as __graft_entry__.entry), without
    autograd; example_args are the flagship's parameters and 8 zero images
    (N, H, W, 3) fp32 on `device` (CUDA unless "cpu")."""
    from tpu_reid_torch.models import reid_clip as M

    full_fp32_convs()
    dev = resolve_device(device)
    mcfg, params = flagship(dev, tiny=tiny)
    h, w = TINY["image_hw"] if tiny else (256, 128)

    @torch.no_grad()
    def fn(params, images):
        return M.eval_embed(params, mcfg, images.to(dtype))

    return fn, (params, torch.zeros(8, h, w, 3, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


def _dryrun_rank(mesh, n_devices: int) -> dict:
    """One rank of dryrun_multichip: the same tiny model on every rank
    (seeded), steps and sweeps over `mesh` against the single-device
    ones."""
    from tpu_reid_torch.data.transforms import DevicePreprocess
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.parallel.extract import extract_embeddings, make_extractor
    from tpu_reid_torch.parallel.mesh import shard_batch
    from tpu_reid_torch.retrieval.metrics import Evaluator
    from tpu_reid_torch.train import optim as O
    from tpu_reid_torch.train import trainer as TR

    dev = mesh.device
    mcfg, params = flagship(dev, tiny=True)
    h, w = TINY["image_hw"]
    tcfg = TR.TrainConfig()
    rng = np.random.RandomState(0)
    # 2 rows a rank, as the JAX dryrun
    bs = 2 * n_devices
    images = torch.from_numpy(rng.randn(bs, h, w, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, mcfg.n_cls, bs))
    valid = torch.ones(bs, dtype=torch.bool)

    with torch.no_grad():
        text = M.all_class_text_features(params, mcfg)
    tr, fr = O.partition(params, lambda p: M.stage2_trainable(p, mcfg))
    tr, fr = TR._trainable_copy(tr), TR._bn_state(fr, mcfg)[0]
    opt = O.make_stage_optimizer(tr, tcfg.lr_stage2, tcfg.weight_decay, bias_lr_mult=2.0)
    loss2 = float(TR.make_stage2_step(mcfg, tcfg, opt, mesh=mesh)(
        tr, fr, shard_batch(mesh, images), labels, text, valid))

    tr, fr = O.partition(params, lambda p: M.stage1_trainable(p, mcfg))
    tr = TR._trainable_copy(tr)
    opt = O.make_stage_optimizer(tr, tcfg.lr_stage1, tcfg.weight_decay)
    batch = {"images": shard_batch(mesh, images), "labels": labels, "valid": valid}
    loss1 = float(TR.make_stage1_step(mcfg, opt, cached=False, mesh=mesh)(tr, fr, batch))
    if not (np.isfinite(loss1) and np.isfinite(loss2)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite losses {loss1}, {loss2}")

    # sharded extraction, then the streamed re-ranking and CMC/mAP over the mesh
    pp = DevicePreprocess((h, w), "vit", dtype=torch.float32)

    def embed(p, x):
        return M.eval_embed(p, mcfg, x)

    n_q, n_g = 2 * n_devices, 6 * n_devices
    images_u8 = rng.randint(0, 255, (n_q + n_g, h, w, 3)).astype(np.uint8)
    n = n_q + n_g
    batch_all = [SimpleNamespace(images=images_u8, pids=np.arange(n), camids=np.zeros(n, np.int64),
                                 seqids=np.zeros(n, np.int64), valid=np.ones(n, bool))]
    feats = {}
    for m in (None, mesh):
        ext = make_extractor(embed, pp, dtype=torch.float32, device=dev, mesh=m)
        feats[m is not None] = extract_embeddings(ext, params, batch_all, device=dev,
                                                  mesh=m)[0]
    extract_diff = float((feats[True] - feats[False]).abs().max())
    if not extract_diff < 1e-4:
        raise RuntimeError(f"dryrun_multichip({n_devices}): sharded extraction diverged: "
                           f"{extract_diff}")

    pids = np.concatenate([np.arange(n_q) % 4, rng.randint(0, 4, n_g)]).astype(np.int64)
    camids = np.concatenate([np.zeros(n_q, np.int64), np.ones(n_g, np.int64)])
    metrics = {}
    for m in (None, mesh):
        ev = Evaluator(num_query=n_q, max_rank=5, reranking=True, rerank_params=(8, 3, 0.3),
                       rerank_mode="streamed", mesh=m)
        ev.update(feats[m is not None], pids, camids)
        metrics[m is not None] = ev.compute()
    (cmc_s, map_s), (cmc_m, map_m) = metrics[False], metrics[True]
    rerank_diff = max(float(np.max(np.abs(np.asarray(cmc_m) - np.asarray(cmc_s)))),
                      abs(float(map_m) - float(map_s)))
    if not rerank_diff < 1e-4:
        raise RuntimeError(f"dryrun_multichip({n_devices}): sharded re-ranking and evaluation "
                           f"diverged: {rerank_diff}")
    return {"ranks": mesh.size, "stage2_loss": loss2, "stage1_loss": loss1,
            "extract_max_abs_diff": extract_diff, "rerank_max_abs_diff": rerank_diff,
            "mAP": float(map_m), "rank1": float(np.asarray(cmc_m)[0])}


def dryrun_multichip(n_devices: int) -> dict:
    """One data-parallel training step of each stage over `n_devices` gloo
    ranks on this host's CPU at tiny shapes, then a sharded extraction sweep
    and the streamed re-ranking with CMC/mAP over the same mesh, each held
    against the single-device result (after __graft_entry__.dryrun_multichip,
    which runs on n virtual CPU devices). Raises if any check fails; prints
    and returns rank 0's record."""
    from tpu_reid_torch.parallel import launch

    if n_devices < 2:
        raise ValueError(f"dryrun_multichip needs at least 2 ranks, got {n_devices}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks split this process's threads
    try:
        out = launch.run(_dryrun_rank, (n_devices,), devices=n_devices, device="cpu",
                         timeout_s=300, join_timeout_s=900)
    finally:
        torch.set_num_threads(threads)
    print(f"dryrun_multichip({n_devices}): stage2 loss {out['stage2_loss']:.4f}, stage1 loss "
          f"{out['stage1_loss']:.4f}; extract parity max|d|={out['extract_max_abs_diff']:.2e}; "
          f"streamed-rerank eval parity max|d|={out['rerank_max_abs_diff']:.2e} (mAP "
          f"{out['mAP']:.4f}, R1 {out['rank1']:.4f}) -- OK")
    return out
