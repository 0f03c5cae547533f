"""Zero-shot ReID pipeline: frozen CLIP + text-prompt classifier.

  * zeroshot_classifier — per-identity text weights: encode each template,
    L2-normalize, mean over templates, L2-normalize again,
  * flip-TTA inference (parallel/extract.py) over make_zeroshot_embed: ViT
    features are cat(x12 CLS, xproj CLS), ResNet features cat(mean of the
    layer-4 map, the attention-pooled token),
  * --mm multimodal mode — the retrieval embedding becomes
    cat(image_features, softmax(1/0.07 * norm(proj) @ zs_weights.T)),
  * evaluation through the Evaluator (CMC + mAP, optionally mINP, max_rank
    50, optionally k-reciprocal re-ranking).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpu_reid_torch.configs import CLIPConfig
from tpu_reid_torch.device import DeviceLike, resolve_device, to_device
from tpu_reid_torch.models import resnet as R
from tpu_reid_torch.models import text as T
from tpu_reid_torch.models import vit as V
from tpu_reid_torch.models.tokenizer import ClipTokenizer
from tpu_reid_torch.retrieval.distance import l2_normalize
from tpu_reid_torch.retrieval.metrics import Evaluator

Tensor = torch.Tensor


@torch.no_grad()
def zeroshot_classifier(
    clip_params: dict,
    cfg: CLIPConfig,
    tokenizer: ClipTokenizer,
    classnames: Sequence[str],
    templates: Dict[str, object],
    augmented: bool,
    batch: int = 64,
    device: DeviceLike = None,
) -> Tensor:
    """(n_cls, E) normalized per-identity text classifier weights on
    `device` (CUDA unless device="cpu"). templates maps each class name to
    one sentence, or (augmented) to a list of sentences of equal length."""
    dev = resolve_device(device)
    text_params = to_device(clip_params["text"], dev)
    ctx_len = cfg.text.context_length

    if augmented:
        per_class = [templates[c] for c in classnames]
        n_t = len(per_class[0])
        if any(len(p) != n_t for p in per_class):
            raise ValueError("augmented templates need the same count per class")
        texts = [t for ts in per_class for t in ts]
    else:
        texts = [templates[c] for c in classnames]
    tokens = tokenizer.tokenize(texts, context_length=ctx_len, truncate=True)
    pad = (-len(texts)) % batch
    tokens = np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), np.int32)])
    feats = torch.cat([
        T.encode_text_tokens(text_params, cfg.text,
                             torch.from_numpy(tokens[i: i + batch]).to(dev))
        for i in range(0, tokens.shape[0], batch)
    ])[: len(texts)]
    feats = l2_normalize(feats, axis=-1)
    if not augmented:
        return feats
    # T templates per class -> norm -> mean -> norm
    feats = feats.reshape(len(classnames), n_t, -1).mean(dim=1)
    return l2_normalize(feats, axis=-1)


def make_zeroshot_embed(clip_params: dict, cfg: CLIPConfig):
    """(params, images) -> cat(non_proj feature, proj feature): for the ViT
    the CLS rows of (x12, xproj); for the ResNet the spatial mean of the
    layer-4 map and the attention-pooled token (3072-wide for RN50)."""
    if cfg.vision is not None:

        def embed(params, images):
            _, x12, xproj = V.apply_vit(params["visual"], cfg.vision, images, cls_only=True)
            return torch.cat([x12[:, 0], xproj[:, 0]], dim=-1)

    else:

        def embed(params, images):
            _, x4, xproj = R.apply_resnet(params["visual"], cfg.resnet, images)
            return torch.cat([x4.mean(dim=(2, 3)), xproj[:, 0]], dim=-1)

    return embed


def mm_embeddings(features: Tensor, proj_dim: int, zs_weights: Tensor) -> Tensor:
    """--mm mode: replace the projected half with softmaxed zero-shot
    logits."""
    non_proj = features[:, :-proj_dim]
    proj = l2_normalize(features[:, -proj_dim:], axis=-1)
    logits = torch.softmax((1.0 / 0.07) * proj @ zs_weights.T.to(proj.dtype), dim=-1)
    return torch.cat([non_proj, logits], dim=-1)


@torch.no_grad()
def evaluate_zero_shot(
    query_feats: Tensor,
    gallery_feats: Tensor,
    q_pids,
    g_pids,
    q_camids,
    g_camids,
    zs_weights: Optional[Tensor] = None,
    proj_dim: int = 512,
    multimodal: bool = False,
    max_rank: int = 50,
    reranking: bool = False,
    mesh=None,
    with_minp: bool = False,
    device: DeviceLike = None,
    log=None,
):
    """Final ranking on `device` (CUDA unless device="cpu"): optional mm
    transform, then CMC/mAP, with k-reciprocal re-ranking when `reranking`
    (the Evaluator's "auto" route). Returns (cmc, mAP), or (cmc, mAP, mINP)
    when with_minp. `mesh` (a parallel/mesh.Mesh) and `log` are handed to
    the Evaluator."""
    dev = resolve_device(device)
    query_feats = torch.as_tensor(query_feats).to(dev)
    gallery_feats = torch.as_tensor(gallery_feats).to(dev)
    if multimodal:
        if zs_weights is None:
            raise ValueError("multimodal evaluation needs the zero-shot weights")
        zs_weights = torch.as_tensor(zs_weights).to(dev)
        query_feats = mm_embeddings(query_feats, proj_dim, zs_weights)
        gallery_feats = mm_embeddings(gallery_feats, proj_dim, zs_weights)
    ev = Evaluator(num_query=int(query_feats.shape[0]), max_rank=max_rank,
                   feat_norm=True, reranking=reranking, mesh=mesh, with_minp=with_minp,
                   log=log)
    ev.update(query_feats, q_pids, q_camids)
    ev.update(gallery_feats, g_pids, g_camids)
    return ev.compute()
