"""How the program under test takes an IVLP CLIP ReID configuration: its
model config, and its parameter tree filled from the benchmark's raw
weights (a copy: the program never holds the tensors the reference reads)."""

from __future__ import annotations

from typing import Dict

import torch


def model_config(cfg: dict):
    """The program's ReidModelConfig of the configuration file `cfg`."""
    from tpu_reid_torch.configs import CLIPConfig, PromptDesign, TextConfig, VisionConfig
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M

    design = PromptDesign(trainer="IVLP", vision_depth=cfg["prompt_depth"],
                          vision_ctx=cfg["vision_ctx"], language_depth=cfg["prompt_depth"],
                          language_ctx=cfg["language_ctx"])
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    vision = VisionConfig(layers=cfg["vision_layers"], width=cfg["vision_width"], patch_size=p,
                          stride=s, h_grid=(h - p) // s + 1, w_grid=(w - p) // s + 1,
                          output_dim=cfg["embed_dim"], design=design,
                          n_heads=cfg["vision_heads"])
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


def params(raw: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """The program's nested parameter dict: a copy of every raw tensor at its
    path, and the prompt template's EOT position where the prompt learner
    is present."""
    tree: dict = {}
    for name, t in raw.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.clone()
    if "prompt_learner" in tree:
        dev = raw["prompt_learner/cls_ctx"].device
        tree["prompt_learner"]["eot_idx"] = torch.tensor([cfg["eot_index"]], dtype=torch.int32,
                                                         device=dev)
    return tree
