"""Prompt learners: per-identity learnable context spliced into CLIP text
prompts — the CoOp / IVLP / PromptSRC / VeRi / caption families (a copy of
tpu_reid/models/prompts.py over torch tensors).

All variants share one structure:

    prompt = [ frozen prefix | learnable per-class ctx | frozen suffix ]

and differ only in (a) how many leading template tokens are frozen, (b) how
many ctx vectors are learned per class, and (c) whether the frozen template
is shared, one-of-T (augmented), or per-class (VeRi car types, captions):

  * CoOp        — template "A photo of X X X X X person.", prefix = SOT + 3
                  words, n_cls_ctx = 5
  * IVLP / SRC  — same template, prefix = SOT + 4 tokens, n_cls_ctx = 4
  * Augmented   — 4 article-variant templates ("a/an/the/one"), shared ctx
                  expanded across the template axis, output (B, 4, L, D)
  * VeRi        — per-class car-type description templates, prefix/suffix
                  indexed by label
  * captions    — per-class caption templates read from "label: description"
                  lines; the EOT index is shifted by n_cls_ctx so pooling
                  hits the actual EOT

The EOT index for pooling comes from argmax over the tokenized template.
The learnable ctx is initialised N(0, 0.02) from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

PERSON_TEMPLATE = "A photo of X X X X X person."
VEHICLE_TEMPLATE = "A photo of X X X X X vehicle."
AUGMENTED_TEMPLATES = (
    "A photo of a X X X X person.",
    "A photo of an X X X X person.",
    "A photo of the X X X X person.",
    "A photo of one X X X X person.",
)

PERSON_DATASETS = ("market1501", "dukemtmc", "msmt17", "personx")

# Verbose car-type descriptions for VeRi prompts (reference: coop.py:116-127).
CAR_TYPE_EXPLANATION = {
    "sedan": "sedan, a type of passenger car that typically features a lower"
             " profile, sleeker lines, a fixed roof, four doors, and a"
             " separate trunk compartment for cargo.",
    "suv": "SUV, a type of passenger car that typically features a taller"
           " body with a boxy shape, a high ground clearance, and a spacious"
           " interior capable of accommodating multiple passengers and cargo.",
    "van": "van, a spacious vehicle that features a boxy design, large cargo"
           " capacity, and multiple seating configurations.",
    "hatchback": "hatchback, a compact car that features a rear door opening"
                 " upwards to access a cargo area.",
    "mpv": "MPV (Multi-Purpose Vehicle), a versatile automobile that features"
           " multiple seating configurations, ample interior space, and"
           " sliding doors.",
    "pickup": "pickup, a rugged vehicle that features an open cargo area at"
              " the rear, often equipped with towing capabilities and"
              " four-wheel drive.",
    "bus": "bus, a large vehicle that features multiple rows of seating, wide"
           " windows, and a distinctive boxy shape.",
    "truck": "truck, a robust vehicle that features a separate cabin and"
             " cargo area, often with a towing hitch, powerful engine, and"
             " sturdy chassis.",
    "estate": "estate, a versatile vehicle that features a spacious cargo"
              " area extending from the rear of the cabin, often with a"
              " sloping roofline and folding rear seats.",
    "": "background.",
}


def base_template(dataset_name: str) -> str:
    return (
        PERSON_TEMPLATE if dataset_name in PERSON_DATASETS else VEHICLE_TEMPLATE
    )


def veri_templates(car_types: Sequence[str], n_cls_ctx: int = 3) -> list[str]:
    """Per-class car-type prompt sentences: 'A photo of X <X...> <desc>'.

    The learnable slots are the leading X placeholders; the type description
    provides the frozen suffix (reference: coop.py:113-145)."""
    xs = " ".join(["X"] * (n_cls_ctx - 1))
    out = []
    for car_type in car_types:
        parts = car_type.split(" ")
        desc = CAR_TYPE_EXPLANATION.get(parts[-1], "vehicle.")
        if len(parts) == 2:  # "<color> <type>" -> "... X X red sedan, ..."
            # the color is spliced between the X placeholders and the type
            # word (reference: coop.py:136-137, maple.py:195-196)
            desc = f"{parts[0]} {desc}"
        out.append(f"A photo of X {xs} {desc}".replace("_", " "))
    return out


def read_caption_prompts(path: str, n_cls: int) -> list[str]:
    """'label: description' lines from an offline captioner
    (reference: maple.py:97-105)."""
    prompts = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            _, desc = line.split(":", 1)
            prompts.append(desc.strip())
    assert len(prompts) == n_cls, f"{len(prompts)} prompts for {n_cls} classes"
    return prompts


@dataclasses.dataclass(frozen=True)
class PromptLearnerConfig:
    """Static splice geometry. n_prefix counts tokens BEFORE the learnable
    ctx including SOT; per_class marks per-class frozen templates."""

    n_cls: int
    n_prefix: int
    n_cls_ctx: int
    per_class: bool = False
    n_templates: int = 1  # >1 => augmented (template axis in the output)
    shift_eot: bool = False  # per-class captions: ctx inserted before suffix

    @staticmethod
    def coop(n_cls: int) -> "PromptLearnerConfig":
        return PromptLearnerConfig(n_cls, n_prefix=4, n_cls_ctx=5)

    @staticmethod
    def ivlp(n_cls: int) -> "PromptLearnerConfig":
        return PromptLearnerConfig(n_cls, n_prefix=5, n_cls_ctx=4)

    @staticmethod
    def augmented(n_cls: int) -> "PromptLearnerConfig":
        return PromptLearnerConfig(n_cls, n_prefix=5, n_cls_ctx=4, n_templates=4)

    @staticmethod
    def veri(n_cls: int) -> "PromptLearnerConfig":
        return PromptLearnerConfig(n_cls, n_prefix=4, n_cls_ctx=3, per_class=True)

    @staticmethod
    def veri_ivlp(n_cls: int) -> "PromptLearnerConfig":
        """VeRi under IVLP: prefix is still SOT + 'a photo of' (4 tokens),
        ctx exactly replaces the four X placeholders (reference:
        maple.py:211-231 uses n_ctx=3 -> prefix [:4], n_cls_ctx=4)."""
        return PromptLearnerConfig(n_cls, n_prefix=4, n_cls_ctx=4, per_class=True)

    @staticmethod
    def captions(n_cls: int) -> "PromptLearnerConfig":
        return PromptLearnerConfig(
            n_cls, n_prefix=5, n_cls_ctx=4, per_class=True, shift_eot=True
        )


def init_prompt_learner(
    gen: torch.Generator,
    cfg: PromptLearnerConfig,
    template_embedding,  # (T, L, D) embedded tokenized templates
    template_tokens: np.ndarray,  # (T, L) int token ids
) -> dict:
    """Split the embedded template(s) into frozen prefix/suffix buffers and
    allocate the learnable per-class ctx (N(0, 0.02) from `gen`)."""
    emb = torch.as_tensor(template_embedding)
    if emb.dim() != 3:
        raise ValueError(f"template embedding must be (T, L, D), got {tuple(emb.shape)}")
    template_tokens = np.asarray(template_tokens)
    d = emb.shape[-1]
    p, c = cfg.n_prefix, cfg.n_cls_ctx
    if cfg.shift_eot:
        # caption templates have no X placeholders: ctx is inserted, the
        # suffix keeps everything after the prefix minus the tail overflow
        suffix = emb[:, p:-c]
        eot = np.minimum(template_tokens.argmax(-1) + c, template_tokens.shape[1] - 1)
    else:
        suffix = emb[:, p + c:]
        eot = template_tokens.argmax(-1)
    return {
        "cls_ctx": torch.randn(cfg.n_cls, c, d, generator=gen, dtype=torch.float32) * 0.02,
        "prefix": emb[:, :p].clone(),
        "suffix": suffix.clone(),
        "eot_idx": torch.as_tensor(eot.astype(np.int32)),
    }


def apply_prompt_learner(params: dict, cfg: PromptLearnerConfig, label: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """label (B,) -> (prompt embeddings, eot indices).

    Output embeddings: (B, L, D), or (B, T, L, D) when n_templates > 1.
    Positional embedding is NOT included (the text encoder adds it)."""
    label = label.long()
    ctx = params["cls_ctx"][label]  # (B, c, D)
    b = label.shape[0]
    if cfg.per_class:
        prefix = params["prefix"][label]
        suffix = params["suffix"][label]
        eot = params["eot_idx"][label]
    else:
        prefix = params["prefix"][:1].expand((b,) + tuple(params["prefix"].shape[1:]))
        suffix = params["suffix"][:1].expand((b,) + tuple(params["suffix"].shape[1:]))
        eot = params["eot_idx"][:1].expand(b)
    ctx = ctx.to(prefix.dtype)

    if cfg.n_templates > 1:
        t = cfg.n_templates
        prefix = params["prefix"][None].expand((b,) + tuple(params["prefix"].shape))
        suffix = params["suffix"][None].expand((b,) + tuple(params["suffix"].shape))
        ctx_t = ctx[:, None].expand((b, t) + tuple(ctx.shape[1:]))
        prompts = torch.cat([prefix, ctx_t, suffix], dim=2)
        eot = params["eot_idx"][None].expand(b, t)
        return prompts, eot

    return torch.cat([prefix, ctx, suffix], dim=1), eot


def all_class_prompts(params: dict, cfg: PromptLearnerConfig) -> Tuple[Tensor, Tensor]:
    """Prompts for every class — the stage-2 text-feature precompute."""
    return apply_prompt_learner(
        params, cfg, torch.arange(cfg.n_cls, device=params["cls_ctx"].device))
