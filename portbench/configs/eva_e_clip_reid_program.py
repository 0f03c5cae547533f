"""How the program under test takes an EVA02-CLIP-E ReID configuration: its
model config, and its parameter tree filled from the benchmark's raw
weights (copies: the program never holds the tensors the reference reads).

The raw weights are in EVA-CLIP's layout (eva_e_clip_reid.param_spec); the
program's tree comes from `weights.convert.eva_e_params`. The embed kind
feeds the program's ViT preprocessing (`data.transforms.norm_stats("vit")`),
while EVA-CLIP normalises with the configuration's pixel statistics: both are
affine maps of the same pixels, so the binding folds the one into the other
in the patch embedding's weight and bias (exact), in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

# the program's EVA02-E support: a program without it fails here, when the
# harness loads this binding, before any weights are drawn
from tpu_reid_torch.weights.convert import eva_e_params


def model_config(cfg: dict):
    """The program's ReidModelConfig of the configuration file `cfg`."""
    from tpu_reid_torch.configs import CLIPConfig, PromptDesign, TextConfig, VisionConfig
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M

    if not cfg["postnorm"] or cfg["rope"] or cfg["subln"]:
        raise ValueError(f"{cfg['name']}: the program's EVA02-E block is post-norm, without "
                         "RoPE or sub-LNs")
    if cfg["vision_width"] != cfg["vision_heads"] * cfg["head_width"]:
        raise ValueError(f"{cfg['name']}: the width is not heads x head_width")
    design = PromptDesign(trainer="IVLP", vision_depth=cfg["prompt_depth"],
                          vision_ctx=cfg["vision_ctx"], language_depth=cfg["prompt_depth"],
                          language_ctx=cfg["language_ctx"])
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    vision = VisionConfig(layers=cfg["vision_layers"], width=cfg["vision_width"], patch_size=p,
                          stride=s, h_grid=(h - p) // s + 1, w_grid=(w - p) // s + 1,
                          output_dim=cfg["embed_dim"], design=design,
                          n_heads=cfg["vision_heads"], block="eva_e",
                          mlp_hidden=cfg["mlp_hidden"], ln_eps=cfg["ln_eps"])
    text = TextConfig(layers=cfg["text_layers"], width=cfg["text_width"],
                      heads=cfg["text_heads"], vocab_size=cfg["vocab_size"],
                      context_length=cfg["context_length"], output_dim=cfg["embed_dim"],
                      design=design)
    clip = CLIPConfig(vision=vision, text=text, embed_dim=cfg["embed_dim"])
    prompt = P.PromptLearnerConfig(cfg["n_cls"], n_prefix=cfg["n_prefix"],
                                   n_cls_ctx=cfg["n_cls_ctx"])
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip, prompt=prompt)
    if vision.seq_len != cfg["seq_len"]:
        raise ValueError(f"{cfg['name']}: the program counts {vision.seq_len} tokens, the "
                         f"configuration {cfg['seq_len']}")
    return mcfg


def _renormalised_conv(conv: dict, cfg: dict) -> dict:
    """The patch embedding for the program's ViT input scale x_vit = (u / 255
    - m_vit) / s_vit where the model reads x = (u / 255 - m) / s = (s_vit
    x_vit + m_vit - m) / s: w' = w s_vit / s, b' = b + sum w (m_vit - m) / s,
    both kept in float32 (the program's fold takes them from there, and its
    conv rounds the weight once)."""
    from tpu_reid_torch.data.transforms import norm_stats

    m_vit, s_vit = (torch.tensor(v, dtype=torch.float32, device=conv["w"].device)
                    for v in norm_stats("vit"))
    m, s = (torch.tensor(cfg[k], dtype=torch.float32, device=conv["w"].device)
            for k in ("pixel_mean", "pixel_std"))
    w32 = conv["w"].float()
    return {"w": w32 * (s_vit / s)[None, None, :, None],
            "b": conv["b"].float() + torch.einsum("hwco,c->o", w32, (m_vit - m) / s)}


def params(raw: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """The program's nested parameter dict of the image tower: EVA-CLIP's
    layout from the raw names, then the program's."""
    tree: dict = {}
    for name, t in raw.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    visual = dict(tree["clip"]["visual"], conv=_renormalised_conv(tree["clip"]["visual"]["conv"],
                                                                  cfg))
    return {"clip": {"visual": eva_e_params(visual)}}
