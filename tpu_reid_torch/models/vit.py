"""CLIP ReID vision transformer over a plain parameter dict.

  * overlapping patch embedding: conv stride < patch size (stride 12 for
    16 px patches),
  * rectangular positional embedding of h_grid*w_grid+1 tokens,
  * triple-feature output (x11, x12, xproj): the layer-11 sequence, the
    final LayerNormed sequence, and its projection,
  * shallow visual prompt tokens appended after the pos-embed, and per-layer
    deep prompt replacement for IVLP/MaPLe.

Layout is batch-first (B, S, D); images are NHWC and the conv weight HWIO,
as in the JAX package. The jigsaw-patch branch comes with a later slice.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from tpu_reid_torch.configs import VisionConfig
from tpu_reid_torch.data.transforms import norm_stats
from tpu_reid_torch.models import layers as L
from tpu_reid_torch.ops.fused_tail import ln_proj_tail

Tensor = torch.Tensor


def _deep_prompt_flags(cfg: VisionConfig) -> List[bool]:
    """Layer i (>0) splices deep prompts iff i < vision_depth."""
    return [0 < i < cfg.design.vision_depth for i in range(cfg.layers)]


def patch_embed(params: dict, cfg: VisionConfig, images: Tensor) -> Tensor:
    """(B, H, W, 3) -> (B, h_grid*w_grid, width) overlapping patch tokens
    (a strided conv; NHWC/HWIO in, row-major grid order out)."""
    w = params["conv"]["w"].to(images.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    x = F.conv2d(images.permute(0, 3, 1, 2), w, stride=cfg.stride)
    x = x.permute(0, 2, 3, 1)  # (B, oh, ow, width)
    if "b" in params["conv"]:
        x = x + params["conv"]["b"].to(x.dtype)
    return x.reshape(x.shape[0], cfg.h_grid * cfg.w_grid, cfg.width)


def fold_visual_input_norm(visual: dict, model_type: str = "vit") -> dict:
    """Fold the eval input normalization into the patch-embed conv weights.

    normalize(u) = u/(255*std_c) - mean_c/std_c is affine and the patch
    embed is linear, so conv(normalize(u)) == conv_scaled(u) + bias with
    w' = w/(255*std_c), bias_o = -sum_khwc w[..,c,o]*mean_c/std_c — exact.
    Extraction then feeds RAW uint8-scale images (DevicePreprocess raw
    mode). Bicubic resize and flips are linear/permutation ops that commute
    with the affine, so resized and TTA inputs stay exact."""
    mean, std = norm_stats(model_type)
    conv = visual["conv"]
    if "b" in conv:
        raise ValueError("input norm already folded")
    w32 = conv["w"].float()
    dev = w32.device
    s = 1.0 / (255.0 * torch.tensor(std, dtype=torch.float32, device=dev))
    t = -torch.tensor(mean, dtype=torch.float32, device=dev) / torch.tensor(
        std, dtype=torch.float32, device=dev)
    out = dict(visual)
    out["conv"] = {
        "w": (w32 * s[None, None, :, None]).to(conv["w"].dtype),
        "b": torch.einsum("hwco,c->o", w32, t),
    }
    return out


def apply_vit(
    params: dict,
    cfg: VisionConfig,
    images: Tensor,
    deep_prompts: Optional[Tensor] = None,
    shallow_prompt: Optional[Tensor] = None,
    cv_emb: Optional[Tensor] = None,
    cls_only: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """Forward pass. Returns (x11, x12, xproj) full sequences; callers take
    [:, 0] for the CLS features.

    deep_prompts/shallow_prompt override params["vpt_deep"/"vpt_shallow"].
    cls_only=True runs the final block, ln_post and the projection on the
    CLS position only (x12/xproj come back as (B, 1, ...)) — exact for every
    caller that consumes [:, 0]; ln_post + proj then run as the CLS-tail
    kernel."""
    x = patch_embed(params, cfg, images)
    b = x.shape[0]
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, cfg.width)
    if cv_emb is not None:
        cls = cls + cv_emb.to(x.dtype)[:, None, :]
    x = torch.cat([cls, x], dim=1)
    x = x + params["positional_embedding"].to(x.dtype)

    if cfg.design.has_vision_prompts:
        vpt = (
            shallow_prompt if shallow_prompt is not None
            else params["vpt_shallow"]
        ).to(x.dtype)
        x = torch.cat([x, vpt.expand((b,) + tuple(vpt.shape))], dim=1)

    x = L.layer_norm(params["ln_pre"], x)

    dp = deep_prompts if deep_prompts is not None else params.get("vpt_deep")
    flags = _deep_prompt_flags(cfg) if dp is not None else None
    n_layers = cfg.layers

    # blocks 0..L-2 as a stack, the final block separately for the x11/x12
    # split
    head = L.slice_layer(params["blocks"], slice(0, n_layers - 1))
    tail = L.slice_layer(params["blocks"], n_layers - 1)
    x11 = L.transformer_stack(
        head,
        x,
        cfg.heads,
        deep_prompts=None if dp is None else dp[: n_layers - 1],
        prompt_flags=None if flags is None else flags[: n_layers - 1],
        text_side=False,
    )
    x_last = x11
    if dp is not None and flags[n_layers - 1]:
        x_last = L.splice_prompt_tokens(x_last, dp[n_layers - 1], text_side=False)
    if cls_only:
        x12 = L.residual_block_cls(tail, x_last, cfg.heads)
        y, pr = ln_proj_tail(x12[:, 0], params["ln_post"], params["proj"])
        return x11, y[:, None], pr[:, None]
    x12 = L.residual_block(tail, x_last, cfg.heads)
    x12 = L.layer_norm(params["ln_post"], x12)
    xproj = x12 @ params["proj"].to(x12.dtype)
    return x11, x12, xproj
