"""CLIP causal text transformer over a plain parameter dict.

  * `encode_text_tokens`: tokens -> embeddings -> transformer -> EOT pooling,
  * `encode_text_embeddings`: pre-built prompt embeddings (from a prompt
    learner) -> transformer -> EOT pooling, with optional per-layer deep
    language prompts (splice rule: keep SOS, replace tokens 1..n_ctx).

EOT pooling uses the argmax of the token ids — the EOT token has the highest
id in CLIP's vocab.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tpu_reid_torch.configs import TextConfig
from tpu_reid_torch.models import layers as L

Tensor = torch.Tensor


def _deep_prompt_flags(cfg: TextConfig) -> List[bool]:
    return [0 < i < cfg.design.language_depth for i in range(cfg.layers)]


def _transform(params: dict, cfg: TextConfig, x: Tensor,
               deep_prompts: Optional[Tensor]) -> Tensor:
    mask = L.causal_mask(x.shape[1], device=x.device)
    dp = deep_prompts if deep_prompts is not None else params.get("vpt_deep")
    flags = _deep_prompt_flags(cfg) if dp is not None else None
    x = L.transformer_stack(
        params["blocks"], x, cfg.heads, mask=mask,
        deep_prompts=dp, prompt_flags=flags, text_side=True,
    )
    return L.layer_norm(params["ln_final"], x)


def pool_eot(x: Tensor, eot_idx: Tensor, text_projection: Tensor) -> Tensor:
    """Take each sequence's EOT feature and project: (B, S, D) -> (B, E)."""
    feats = x[torch.arange(x.shape[0], device=x.device), eot_idx.long()]
    return feats @ text_projection.to(x.dtype)


def encode_text_embeddings(
    params: dict,
    cfg: TextConfig,
    prompt_embeddings: Tensor,
    eot_idx: Tensor,
    deep_prompts: Optional[Tensor] = None,
) -> Tensor:
    """Prompt-learner path: embeddings already include learned context.

    prompt_embeddings: (B, context_length, width) WITHOUT positional
    embedding (it is added here). eot_idx: (B,) argmax of the tokenized
    prompts."""
    x = prompt_embeddings + params["positional_embedding"].to(prompt_embeddings.dtype)
    x = _transform(params, cfg, x, deep_prompts)
    return pool_eot(x, eot_idx, params["text_projection"])


def encode_text_embeddings_augmented(
    params: dict,
    cfg: TextConfig,
    prompt_embeddings: Tensor,
    eot_idx: Tensor,
    deep_prompts: Optional[Tensor] = None,
) -> Tensor:
    """Augmented-template path: (B, T, L, D) prompt embeddings (one row per
    article-variant template) -> per-template encode -> mean over the
    template axis. eot_idx: (B, T)."""
    b, t, n, d = prompt_embeddings.shape
    feats = encode_text_embeddings(params, cfg, prompt_embeddings.reshape(b * t, n, d),
                                   eot_idx.reshape(b * t), deep_prompts)
    return feats.reshape(b, t, -1).mean(dim=1)


def encode_text_tokens(
    params: dict,
    cfg: TextConfig,
    tokens: Tensor,
    deep_prompts: Optional[Tensor] = None,
) -> Tensor:
    """Plain CLIP text encoding from token ids (B, context_length)."""
    tokens = tokens.long()
    x = params["token_embedding"][tokens]
    eot_idx = tokens.argmax(dim=-1)
    x = x + params["positional_embedding"].to(x.dtype)
    x = _transform(params, cfg, x, deep_prompts)
    return pool_eot(x, eot_idx, params["text_projection"])
