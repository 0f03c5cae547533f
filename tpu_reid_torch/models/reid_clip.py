"""ReID CLIP assembly over one parameter dict (the port of
tpu_reid/models/reid_clip.py).

One model = CLIP towers + prompt learner + BNNeck heads (+ adapter / frozen
zero-shot teacher), as separate pure functions:

  * encode_image_features  — CLS triple (x11, x12, xproj)[:, 0]
  * encode_text_features   — prompt learner -> text encoder -> EOT feature
  * forward_train          — heads + features for the stage-2 loss
  * eval_embed             — cat(non_proj, proj) 1280-d retrieval embedding

Modes:
  coop      — learned per-class text ctx only (prompt_learner trains)
  ivlp      — + deep vision/language prompt tokens inside both towers
  promptsrc — ivlp + frozen zero-shot image tower for L1 distillation
  adapter   — coop + residual Adapter blended into the non-proj feature at
              ratio 0.2

Not ported yet, and refused with their ROADMAP item: mode "maple"
(models/maple_prompts.py), the JPM branch (use_jpm) and SIE camera
embeddings (sie_ids > 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.configs import CLIPConfig, PromptDesign
from tpu_reid_torch.device import to_device
from tpu_reid_torch.models import heads as H
from tpu_reid_torch.models import prompts as P
from tpu_reid_torch.models import text as T
from tpu_reid_torch.models import vit as V

Tensor = torch.Tensor

MODES = ("coop", "ivlp", "promptsrc", "adapter")


@dataclasses.dataclass(frozen=True)
class ReidModelConfig:
    mode: str  # coop | ivlp | promptsrc | adapter
    clip: CLIPConfig
    prompt: P.PromptLearnerConfig
    adapter_ratio: float = 0.2
    use_jpm: bool = False
    sie_ids: int = 0
    sie_coe: float = 1.0

    def __post_init__(self):
        if self.mode == "maple":
            raise NotImplementedError(
                "mode 'maple' is not ported yet (ROADMAP.md queue 1 item 5: "
                "models/maple_prompts.py)")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}: {self.mode!r}")
        if self.use_jpm or self.sie_ids > 0:
            raise NotImplementedError(
                "the JPM branch and SIE camera embeddings are not ported yet "
                "(ROADMAP.md queue 1 item 5: the JPM of vit.py:269-305, SIE)")

    @property
    def n_cls(self) -> int:
        return self.prompt.n_cls


def init_reid_model(
    gen: torch.Generator,
    cfg: ReidModelConfig,
    clip_params: dict,
    template_embedding,
    template_tokens: np.ndarray,
    zs_visual_params: Optional[dict] = None,
) -> dict:
    """Assemble the full parameter dict around converted CLIP weights; the
    new leaves (prompt learner, heads, adapter) come from `gen` and land on
    the CLIP weights' device. zs_visual_params: the frozen zero-shot teacher
    tower for promptsrc."""
    dev = clip_params["visual"]["conv"]["w"].device
    width = cfg.clip.vision.width
    new = {
        "prompt_learner": P.init_prompt_learner(gen, cfg.prompt, template_embedding,
                                                template_tokens),
        "head": H.init_classifier(gen, cfg.n_cls, dim_nonproj=width,
                                  dim_proj=cfg.clip.embed_dim),
    }
    if cfg.mode == "adapter":
        new["adapter"] = H.init_adapter(gen, dim=width)
    params = {"clip": clip_params, **to_device(new, dev)}
    if cfg.mode == "promptsrc":
        if zs_visual_params is None:
            raise ValueError("promptsrc needs a zero-shot teacher tower (zs_visual_params)")
        params["zs_visual"] = zs_visual_params
    return params


def _cls_triple(params: dict, cfg: ReidModelConfig, images: Tensor):
    x11, x12, xproj = V.apply_vit(params["clip"]["visual"], cfg.clip.vision, images,
                                  cls_only=True)
    return x11[:, 0], x12[:, 0], xproj[:, 0]


def encode_image_features(params: dict, cfg: ReidModelConfig, images: Tensor,
                          cv_ids=None) -> dict:
    """CLS features at the three levels; adapter mode blends the non-proj
    level. cv_ids (SIE) is not ported and must be None."""
    if cv_ids is not None:
        raise NotImplementedError(
            "camera ids feed SIE, not ported yet (ROADMAP.md queue 1 item 5)")
    last, non_proj, proj = _cls_triple(params, cfg, images)
    if cfg.mode == "adapter":
        non_proj = H.apply_adapter(params["adapter"], non_proj, cfg.adapter_ratio)
    return {"last": last, "non_proj": non_proj, "proj": proj}


def encode_text_features(params: dict, cfg: ReidModelConfig, label: Tensor) -> Tensor:
    """Prompt-learner text path. With an augmented prompt config
    (n_templates > 1) the features are the mean over the per-template
    encodings."""
    prompts, eot = P.apply_prompt_learner(params["prompt_learner"], cfg.prompt, label)
    if cfg.prompt.n_templates > 1:
        return T.encode_text_embeddings_augmented(params["clip"]["text"], cfg.clip.text,
                                                  prompts, eot)
    return T.encode_text_embeddings(params["clip"]["text"], cfg.clip.text, prompts, eot)


def all_class_text_features(params: dict, cfg: ReidModelConfig, batch: int = 256) -> Tensor:
    """Text features for every class — the stage-2 precompute — over class
    chunks of `batch` (the last chunk padded with class 0, as in JAX)."""
    n = cfg.n_cls
    dev = params["prompt_learner"]["cls_ctx"].device
    pad = (-n) % batch
    labels = torch.cat([torch.arange(n, device=dev),
                        torch.zeros(pad, dtype=torch.long, device=dev)])
    chunks = [encode_text_features(params, cfg, labels[i:i + batch])
              for i in range(0, n + pad, batch)]
    return torch.cat(chunks, dim=0)[:n]


def encode_train_features(params: dict, cfg: ReidModelConfig, images: Tensor,
                          cv_ids=None) -> dict:
    """Image-side training encode: the feature triple (+ the frozen ZS
    teacher's non-proj feature for promptsrc, computed without grad)."""
    feats = encode_image_features(params, cfg, images, cv_ids)
    if cfg.mode == "promptsrc":
        # the teacher is a vanilla tower: design stripped so no prompt
        # tokens are spliced into its sequence
        zs_cfg = dataclasses.replace(cfg.clip.vision, design=PromptDesign())
        with torch.no_grad():
            _, zs_non_proj, _ = V.apply_vit(params["zs_visual"], zs_cfg, images, cls_only=True)
        feats["zs_non_proj"] = zs_non_proj[:, 0]
    return feats


def forward_train(params: dict, cfg: ReidModelConfig, images: Tensor, train: bool = True,
                  valid: Optional[Tensor] = None, encode_fn=None, cv_ids=None) -> dict:
    """Training-time forward for the stage-2 loss: ID logits at both BNNeck
    levels, the feature triple, the new BN statistics and (promptsrc) the
    frozen teacher's non-proj feature. valid: (B,) row mask — padded rows
    stay out of the BNNeck batch statistics."""
    feats = (encode_fn or encode_train_features)(params, cfg, images, cv_ids)
    head = H.apply_classifier(params["head"], feats["non_proj"], feats["proj"], train=train,
                              valid=valid)
    out = {
        "cls_scores": (head["logits"], head["logits_proj"]),
        "features": (feats["last"], feats["non_proj"], feats["proj"]),
        "proj": feats["proj"],
        "bn_stats": head["new_stats"],
    }
    if "zs_non_proj" in feats:
        out["zs_non_proj"] = feats["zs_non_proj"]
    return out


def eval_embed(params: dict, cfg: ReidModelConfig, images: Tensor, cv_ids=None) -> Tensor:
    """Retrieval embedding: cat(non_proj CLS, proj CLS) — 1280-d for
    ViT-B/16."""
    feats = encode_image_features(params, cfg, images, cv_ids)
    return torch.cat([feats["non_proj"], feats["proj"]], dim=-1)


def fold_input_norm(params: dict, cfg: ReidModelConfig, model_type: str = "vit") -> dict:
    """Fold the per-channel input normalization into the patch-embed conv
    (exact; extraction then feeds raw uint8-scale images). Returns a new
    dict; the promptsrc teacher is folded too."""
    out = dict(params)
    out["clip"] = dict(params["clip"])
    out["clip"]["visual"] = V.fold_visual_input_norm(params["clip"]["visual"], model_type)
    if "zs_visual" in params:
        out["zs_visual"] = V.fold_visual_input_norm(params["zs_visual"], model_type)
    return out


# ---------------------------------------------------------------------------
# parameter partitions (what trains in each stage)
# ---------------------------------------------------------------------------


def stage1_trainable(path: Tuple[str, ...], cfg: ReidModelConfig) -> bool:
    """Stage 1 trains the prompt learner ctx (+ VPT tokens for ivlp and
    promptsrc)."""
    if path[0] == "prompt_learner":
        return path[-1] == "cls_ctx"  # frozen prefix/suffix/eot stay put
    if cfg.mode in ("ivlp", "promptsrc"):
        return any(p.startswith("vpt_") for p in path)
    return False


def stage2_trainable(path: Tuple[str, ...], cfg: ReidModelConfig) -> bool:
    """Stage 2 freezes prompts, VPT, the text tower and the teacher, and
    trains the image tower and the heads (the BNNeck biases stay at zero;
    the running statistics are state)."""
    if path[0] in ("prompt_learner", "zs_visual"):
        return False
    if path[0] == "clip" and path[1] == "text":
        return False
    if path[-1] == "logit_scale":
        return False
    if any(p.startswith("vpt_") for p in path):
        return False
    if path[0] == "head" and path[1] in ("bn", "bn_proj") and path[-1] == "bias":
        return False
    if path[-1] in ("mean", "var"):
        return False
    return True
