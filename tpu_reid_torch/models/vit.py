"""CLIP ReID vision transformer over a plain parameter dict.

  * overlapping patch embedding: conv stride < patch size (stride 12 for
    16 px patches),
  * rectangular positional embedding of h_grid*w_grid+1 tokens,
  * triple-feature output (x11, x12, xproj): the layer-11 sequence, the
    final LayerNormed sequence, and its projection,
  * shallow visual prompt tokens appended after the pos-embed, and per-layer
    deep prompt replacement for IVLP/MaPLe,
  * the jigsaw patch module (JPM, TransReID): a copy of the last block and
    of ln_post run on the final sequence with its patches shifted and
    group-shuffled,
  * EVA02 towers (cfg.block "eva02", EVA-CLIP): the patch embedding with a
    bias, no ln_pre, EVA02 blocks (2D RoPE on the grid tokens, SwiGLU,
    sub-LNs; models/layers.eva_block) and a head with a bias; EVA02-CLIP-E
    (cfg.block "eva_e"): the same stem and head around post-norm blocks
    (models/layers.eva_e_block: heads of 112, an exact-GELU MLP, the
    deep-prompt splice on each block's store).

Layout is batch-first (B, S, D); images are NHWC and the conv weight HWIO,
as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F

from tpu_reid_torch.configs import VisionConfig
from tpu_reid_torch.data.transforms import norm_stats
from tpu_reid_torch.device import clone
from tpu_reid_torch.models import layers as L
from tpu_reid_torch.ops.fused_tail import ln_proj_tail
from tpu_reid_torch.runtime.observe import span

Tensor = torch.Tensor

# where a folded patch embedding centres its raw 0..255 input
RAW_CENTER = 128.0


def _deep_prompt_flags(cfg: VisionConfig) -> List[bool]:
    """Layer i (>0) splices deep prompts iff i < vision_depth."""
    return [0 < i < cfg.design.vision_depth for i in range(cfg.layers)]


def patch_embed(params: dict, cfg: VisionConfig, images: Tensor) -> Tensor:
    """(B, H, W, 3) -> (B, h_grid*w_grid, width) overlapping patch tokens
    (a strided conv; NHWC/HWIO in, row-major grid order out). The conv's
    own bias ("bias": EVA02's) is added where present. With the input
    normalisation folded in (a "b": `fold_visual_input_norm`) the images are
    raw 0..255 values: the conv reads them centred at RAW_CENTER (exact for
    uint8 values in bf16) and the bias takes the centre's share in float32,
    so neither the conv's output nor the bias carries the images' mean, which
    the folded bias would otherwise cancel after both were rounded."""
    conv = params["conv"]
    w = conv["w"].to(images.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if "b" in conv:
        images = images - RAW_CENTER
    x = F.conv2d(images.permute(0, 3, 1, 2), w, stride=cfg.stride)
    x = x.permute(0, 2, 3, 1)  # (B, oh, ow, width)
    if "b" in conv:
        x = x + (conv["b"] + RAW_CENTER * conv["w"].float().sum(dim=(0, 1, 2))).to(x.dtype)
    elif "bias" in conv:
        x = x + conv["bias"].to(x.dtype)
    return x.reshape(x.shape[0], cfg.h_grid * cfg.w_grid, cfg.width)


@functools.lru_cache(maxsize=16)
def _rope_table(h_grid: int, w_grid: int, n_after: int, rope_grid: int,
                device: torch.device) -> Tensor:
    rows = torch.arange(h_grid, dtype=torch.float64) * (rope_grid / h_grid)
    cols = torch.arange(w_grid, dtype=torch.float64) * (rope_grid / w_grid)
    omega = 10000.0 ** (-torch.arange(0, 32, 2, dtype=torch.float64) / 32)  # (16,)
    ang_r = (rows[:, None] * omega).repeat_interleave(2, dim=-1)  # (hg, 32)
    ang_c = (cols[:, None] * omega).repeat_interleave(2, dim=-1)  # (wg, 32)
    ang = torch.cat([ang_r[:, None, :].expand(h_grid, w_grid, 32),
                     ang_c[None, :, :].expand(h_grid, w_grid, 32)], dim=-1).reshape(-1, 64)
    table = torch.zeros(1 + h_grid * w_grid + n_after, 2, 64, dtype=torch.float64)
    table[:, 0] = 1.0  # identity rows: CLS and the prompt tokens
    table[1:1 + h_grid * w_grid, 0] = ang.cos()
    table[1:1 + h_grid * w_grid, 1] = ang.sin()
    return table.float().to(device)


def rope_table(cfg: VisionConfig, device) -> Tensor:
    """EVA02's 2D rotary embedding as a (S, 2, 64) cos / sin table (each
    pair's angle twice), built once per geometry and device. The grid token
    at (r, c) turns dims 0-31 by t_r = r * rope_grid / h_grid and dims 32-63
    by t_c = c * rope_grid / w_grid (EVA's intp_freq), pair p of a half by
    t * 10000^(-2p / 32); CLS and the prompt tokens after the grid are
    identity rows (EVA leaves CLS unrotated)."""
    n_after = cfg.seq_len - 1 - cfg.h_grid * cfg.w_grid
    return _rope_table(cfg.h_grid, cfg.w_grid, n_after, cfg.rope_grid, torch.device(device))


def _blocks(cfg: VisionConfig, device):
    """The tower's block and its CLS-only form, bound to the config."""
    if cfg.block == "clip":
        return L.residual_block, L.residual_block_cls
    if cfg.block == "eva_e":
        return (functools.partial(L.eva_e_block, eps=cfg.ln_eps),
                functools.partial(L.eva_e_block_cls, eps=cfg.ln_eps))
    kw = dict(rope=rope_table(cfg, device), eps=cfg.ln_eps, f_real=cfg.hidden)
    return functools.partial(L.eva_block, **kw), functools.partial(L.eva_block_cls, **kw)


def fold_visual_input_norm(visual: dict, model_type: str = "vit") -> dict:
    """Fold the eval input normalization into the patch-embed conv weights.

    normalize(u) = u/(255*std_c) - mean_c/std_c is affine and the patch
    embed is linear, so conv(normalize(u)) == conv_scaled(u) + bias with
    w' = w/(255*std_c), bias_o = -sum_khwc w[..,c,o]*mean_c/std_c — exact.
    Extraction then feeds RAW uint8-scale images (DevicePreprocess raw
    mode). Bicubic resize and flips are linear/permutation ops that commute
    with the affine, so resized and TTA inputs stay exact. A conv with a bias
    of its own (EVA02's "bias") carries it into the folded "b". The folded
    weight stays float32 (the conv rounds it once, to the images' dtype),
    and `patch_embed` reads the bias against the exact weight."""
    mean, std = norm_stats(model_type)
    conv = visual["conv"]
    if "b" in conv:
        raise ValueError("input norm already folded")
    w32 = conv["w"].float()
    dev = w32.device
    s = 1.0 / (255.0 * torch.tensor(std, dtype=torch.float32, device=dev))
    t = -torch.tensor(mean, dtype=torch.float32, device=dev) / torch.tensor(
        std, dtype=torch.float32, device=dev)
    b = torch.einsum("hwco,c->o", w32, t)
    if "bias" in conv:
        b = b + conv["bias"].float()
    out = dict(visual)
    out["conv"] = {"w": w32 * s[None, None, :, None], "b": b}
    return out


def apply_vit(
    params: dict,
    cfg: VisionConfig,
    images: Tensor,
    deep_prompts: Optional[Tensor] = None,
    shallow_prompt: Optional[Tensor] = None,
    cv_emb: Optional[Tensor] = None,
    cls_only: bool = False,
    jpm_params: Optional[dict] = None,
) -> tuple[Tensor, ...]:
    """Forward pass. Returns (x11, x12, xproj) full sequences; callers take
    [:, 0] for the CLS features.

    deep_prompts/shallow_prompt override params["vpt_deep"/"vpt_shallow"]
    (MaPLe passes its projected prompts here). cv_emb (B, width) is added to
    the CLS token (SIE).
    cls_only=True runs the final block, ln_post and the projection on the
    CLS position only (x12/xproj come back as (B, 1, ...)) — exact for every
    caller that consumes [:, 0]; ln_post + proj then run as the CLS-tail
    kernel.

    jpm_params adds the jigsaw-patch branch on the final pre-LN sequence and
    returns (x11, x12, xproj, jpm_seq). The final block then runs on the
    whole sequence (JPM takes all of it) through the block kernels, and with
    cls_only ln_post and the projection narrow to the CLS row as plain
    LayerNorm and product (no tail kernel, as in the JAX package)."""
    with span("reid.vit.stem"):
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

        if cfg.block == "clip":
            x = L.layer_norm(params["ln_pre"], x)

    block, block_cls = _blocks(cfg, x.device)
    eps, head_bias = cfg.ln_eps, params.get("proj_bias")
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
        block_fn=block,
        splice_after=cfg.block == "eva_e",
    )
    x_last = x11
    if dp is not None and flags[n_layers - 1]:
        x_last = L.splice_prompt_tokens(x_last, dp[n_layers - 1], text_side=False)
    if jpm_params is not None:
        if cfg.block != "clip":
            raise ValueError("JPM runs on CLIP blocks only")
        x12_pre = L.residual_block(tail, x_last, cfg.heads)
        jpm_seq = apply_jpm(jpm_params, cfg, x12_pre)
        if cls_only:
            x12_pre = x12_pre[:, :1]
        x12 = L.layer_norm(params["ln_post"], x12_pre)
        return x11, x12, x12 @ params["proj"].to(x12.dtype), jpm_seq
    if cls_only:
        x12 = block_cls(tail, x_last, cfg.heads)
        y, pr = ln_proj_tail(x12[:, 0], params["ln_post"], params["proj"], head_bias, eps)
        return x11, y[:, None], pr[:, None]
    x12 = block(tail, x_last, cfg.heads)
    x12 = L.layer_norm(params["ln_post"], x12, eps)
    xproj = x12 @ params["proj"].to(x12.dtype)
    if head_bias is not None:
        xproj = xproj + head_bias.to(x12.dtype)
    return x11, x12, xproj


# ---------------------------------------------------------------------------
# JPM — jigsaw patch module (TransReID)
# ---------------------------------------------------------------------------


def shuffle_unit(features: Tensor, shift: int, group: int) -> Tensor:
    """Token shift and grouped shuffle over the patch axis of (B, S, D):
    a circular shift by `shift` over all patch tokens, then (group > 1) the
    sequence, padded with its own last rows to a multiple of `group`,
    group-transposed."""
    b, s, d = features.shape
    x = torch.roll(features, -shift, dims=1)
    if group > 1:
        pad = (-s) % group
        if pad:
            x = torch.cat([x, x[:, -pad:]], dim=1)
        x = x.reshape(b, group, -1, d).transpose(1, 2).reshape(b, -1, d)
    return x


def init_jpm(params_vit: dict, cfg: VisionConfig) -> dict:
    """JPM owns a copy of the last block and of the final LayerNorm."""
    last = L.slice_layer(params_vit["blocks"], cfg.layers - 1)
    return {"block": clone(last), "ln": clone(params_vit["ln_post"])}


def apply_jpm(jpm_params: dict, cfg: VisionConfig, x12_pre_ln: Tensor,
              shift: int = 5, group: int = 1) -> Tensor:
    """The shuffled-patch branch on the final token sequence: CLS kept in
    front, patches through `shuffle_unit`, then JPM's block (the block
    kernels, on a contiguous tensor: the concatenation makes one) and its
    LayerNorm. Returns the whole (B, S, D) sequence."""
    patches = shuffle_unit(x12_pre_ln[:, 1:], shift, group)
    x = torch.cat([x12_pre_ln[:, :1], patches], dim=1)
    x = L.residual_block(jpm_params["block"], x, cfg.heads)
    return L.layer_norm(jpm_params["ln"], x)
