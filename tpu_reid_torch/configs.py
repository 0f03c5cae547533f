"""Typed configuration for the port (a copy of the ViT and text parts of
tpu_reid/configs.py; the ResNet tower comes with a later slice).

Every component takes an explicit frozen dataclass, so configs are hashable
and self-documenting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PromptDesign:
    """Deep vision-language prompting design (IVLP / MaPLe / PromptSRC).

      * trainer "IVLP": independent learned prompt tokens per layer on both
        towers, for layers 1..depth-1 (layer 0 prompts are the shallow ones
        appended/embedded at the input).
      * trainer "MaPLe": text-side deep prompts projected to the vision side.
      * vision_depth/language_depth == 0 disables deep prompting (CoOp path).
    """

    trainer: str = "CoOp"  # CoOp | IVLP | MaPLe | VPT
    vision_depth: int = 0
    vision_ctx: int = 0
    language_depth: int = 0
    language_ctx: int = 0
    maple_length: int = 0

    @property
    def has_vision_prompts(self) -> bool:
        return self.vision_depth > 0 and self.vision_ctx > 0

    @property
    def has_language_prompts(self) -> bool:
        return self.language_depth > 0 and self.language_ctx > 0


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP vision tower (ViT) config.

    h_grid/w_grid are the *post-conv* patch-grid dims; with an overlapping
    patch embed (stride < patch) they are (H - patch)//stride + 1 etc. —
    e.g. 256x128 @ patch16/stride12 -> 21x10.
    """

    layers: int = 12
    width: int = 768
    patch_size: int = 16
    stride: int = 16
    h_grid: int = 14
    w_grid: int = 14
    output_dim: int = 512
    design: PromptDesign = PromptDesign()
    n_heads: Optional[int] = None  # default: width // 64 (CLIP convention)

    @property
    def heads(self) -> int:
        if self.n_heads is not None:
            return self.n_heads
        return max(1, self.width // 64)

    @property
    def seq_len(self) -> int:
        n = self.h_grid * self.w_grid + 1
        if self.design.has_vision_prompts:
            n += self.design.vision_ctx
        return n

    @staticmethod
    def grid_for(image_hw: Tuple[int, int], patch: int, stride: int) -> Tuple[int, int]:
        h, w = image_hw
        return (h - patch) // stride + 1, (w - patch) // stride + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP text tower config (causal transformer, 77-token context)."""

    layers: int = 12
    width: int = 512
    heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    output_dim: int = 512
    design: PromptDesign = PromptDesign()


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: VisionConfig
    text: TextConfig = TextConfig()
    embed_dim: int = 512


def vit_b16_reid(
    image_hw: Tuple[int, int] = (256, 128),
    stride: int = 12,
    design: PromptDesign = PromptDesign(),
) -> CLIPConfig:
    """CLIP ViT-B/16 at the ReID resolution 256x128 with stride-12
    overlapping patches: a 21x10 grid plus CLS, 211 tokens."""
    hg, wg = VisionConfig.grid_for(image_hw, 16, stride)
    return CLIPConfig(
        vision=VisionConfig(
            layers=12, width=768, patch_size=16, stride=stride,
            h_grid=hg, w_grid=wg, output_dim=512, design=design,
        ),
        text=TextConfig(design=design),
        embed_dim=512,
    )
