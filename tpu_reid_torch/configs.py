"""Typed configuration for the port (a copy of the ViT, ResNet and text
parts of tpu_reid/configs.py).

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

    The block and what differs from OpenAI CLIP's (the defaults are CLIP's):
      * block: "clip" (pre-LN, QuickGELU MLP of 4 x width, ln_pre after the
        positional embedding) or "eva02" (EVA-CLIP's EVA02 block: 2D rotary
        embedding on q and k of the grid tokens, a key projection without
        bias, LayerNorms on the attention output and over the MLP's hidden
        width inside the residual branches, a SwiGLU MLP; no ln_pre) or
        "eva_e" (EVA-CLIP's post-norm block of EVA02-CLIP-E/14: no LayerNorm
        before a product, a LayerNorm on each branch's output before its
        residual add, a key projection without bias, an exact-GELU MLP, no
        RoPE; heads of width // n_heads, 112 there; no ln_pre),
      * mlp_hidden: the MLP's hidden width (None: 4 x width; EVA02-L
        int(1024 x 2.6667) = 2730, EVA02-E int(1792 x 8.571428571428571) =
        15360),
      * rope_grid: the pretraining grid (rope_grid x rope_grid) EVA02's
        rotary embedding is interpolated from,
      * ln_eps: every LayerNorm's epsilon (EVA02, EVA02-E: 1e-6; the CLIP
        block takes 1e-5 only).
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
    block: str = "clip"
    mlp_hidden: Optional[int] = None
    rope_grid: int = 16
    ln_eps: float = 1e-5

    def __post_init__(self):
        if self.block not in ("clip", "eva02", "eva_e"):
            raise ValueError(f"vision block must be clip, eva02 or eva_e: {self.block!r}")
        if self.block == "clip" and self.ln_eps != 1e-5:
            raise ValueError("the CLIP block takes LayerNorm epsilon 1e-5")

    @property
    def hidden(self) -> int:
        return self.mlp_hidden if self.mlp_hidden is not None else 4 * self.width

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
class ResNetConfig:
    """ModifiedResNet (RN50-style) vision tower config: a 3-conv stem,
    bottleneck layers, an attention-pool head over an h_grid x w_grid
    feature map. The ReID variant runs layer 4 at stride 1, so the final map
    is input/16 (standard CLIP RN is stride 2, input/32)."""

    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    h_grid: int = 7
    w_grid: int = 7
    layer4_stride: int = 1

    @property
    def total_stride(self) -> int:
        return 16 * self.layer4_stride

    @property
    def heads(self) -> int:
        return self.width * 32 // 64

    @staticmethod
    def grid_for(image_hw: Tuple[int, int], layer4_stride: int = 1) -> Tuple[int, int]:
        s = 16 * layer4_stride
        return image_hw[0] // s, image_hw[1] // s


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Exactly one of the two vision towers is set: `vision` (ViT) or
    `resnet` (ModifiedResNet)."""

    vision: Optional[VisionConfig] = None
    resnet: Optional[ResNetConfig] = None
    text: TextConfig = TextConfig()
    embed_dim: int = 512

    def __post_init__(self):
        if (self.vision is None) == (self.resnet is None):
            raise ValueError("exactly one of vision (ViT) / resnet towers must be set")


def eva02_l14_reid(
    image_hw: Tuple[int, int] = (256, 256),
    design: PromptDesign = PromptDesign(),
) -> CLIPConfig:
    """EVA-CLIP's EVA02-CLIP-L/14 (BAAI, arXiv:2303.15389; model config
    EVA02-CLIP-L-14.json) at a ReID resolution: the vision tower 1024 x 24,
    16 heads of 64, SwiGLU hidden int(1024 x 2.6667) = 2730 with sub-LNs, 2D
    RoPE interpolated from the 16 x 16 pretraining grid, LayerNorm epsilon
    1e-6, no ln_pre, patches of 14 at stride 14 (18 x 18 at 256 x 256); the
    text tower 768 x 12 with 12 heads; embeddings of 768."""
    hg, wg = VisionConfig.grid_for(image_hw, 14, 14)
    return CLIPConfig(
        vision=VisionConfig(
            layers=24, width=1024, patch_size=14, stride=14, h_grid=hg, w_grid=wg,
            output_dim=768, design=design, n_heads=16, block="eva02",
            mlp_hidden=int(1024 * 2.6667), rope_grid=16, ln_eps=1e-6,
        ),
        text=TextConfig(layers=12, width=768, heads=12, output_dim=768, design=design),
        embed_dim=768,
    )


def eva02_e14_reid(
    image_hw: Tuple[int, int] = (256, 128),
    design: PromptDesign = PromptDesign(),
) -> CLIPConfig:
    """EVA-CLIP's EVA02-CLIP-E/14 (BAAI, arXiv:2303.15389; model config
    EVA02-CLIP-bigE-14.json, the "postnorm" tower) at a ReID resolution: the
    vision tower 1792 x 64, 16 heads of 112 (head_width 112), post-norm
    residual branches, an exact-GELU MLP of int(1792 x 8.571428571428571) =
    15360, LayerNorm epsilon 1e-6, no RoPE and no ln_pre, patches of 14 at
    stride 14 (18 x 9 at 256 x 128), a head 1792 -> 1024 with a bias; the
    text tower 1024 x 24 with 16 heads; embeddings of 1024."""
    hg, wg = VisionConfig.grid_for(image_hw, 14, 14)
    return CLIPConfig(
        vision=VisionConfig(
            layers=64, width=1792, patch_size=14, stride=14, h_grid=hg, w_grid=wg,
            output_dim=1024, design=design, n_heads=16, block="eva_e",
            mlp_hidden=int(1792 * 8.571428571428571), ln_eps=1e-6,
        ),
        text=TextConfig(layers=24, width=1024, heads=16, output_dim=1024, design=design),
        embed_dim=1024,
    )


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
