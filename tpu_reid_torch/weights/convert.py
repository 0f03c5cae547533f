"""OpenAI-format CLIP state dict -> the port's parameter dicts.

The parameter dicts have the JAX package's structure and layouts (linear
weights (in, out), conv weights HWIO, blocks stacked on a leading layer
axis), holding torch tensors on the requested device — CUDA unless
device="cpu". The architecture is inferred from state-dict shapes; the square
pretrained positional grid is bicubic-resized to the rectangular ReID grid at
load time (models/clip_model.resize_pos_embed).

`from_jax_params` takes the JAX package's parameter pytree (as numpy arrays)
to the same dicts, so both packages can run one set of weights;
`from_jax_reid_params` does so for a whole ReID model (towers with their VPT
tokens, prompt learner, heads with BN running statistics, adapter, the
promptsrc teacher), checked against the model config. `init_vpt` gives IVLP
prompt tokens to a checkpoint that has none.
`random_clip_state_dict` makes a random OpenAI-format ViT state dict from a
seed, for smoke runs and tests at full width without a checkpoint.
`overlay_clip_reid` lays a CLIP-ReID checkpoint over a CLIP state dict (the
CLI's --clip_weights).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.configs import CLIPConfig, PromptDesign, TextConfig, VisionConfig
from tpu_reid_torch.device import DeviceLike, resolve_device, to_device
from tpu_reid_torch.models.clip_model import resize_pos_embed

Array = np.ndarray
StateDict = Dict[str, Array]


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_state_dict(path: str) -> StateDict:
    """Load a torch-format checkpoint (JIT archive, plain .pth, or a
    {"state_dict"/"model": ...} wrapper) into {name: float32 ndarray}."""
    try:
        model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        elif isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """Keep keys under `prefix`, with the prefix removed (an exact string
    strip, not the reference's `lstrip` char-set)."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def drop_prefix(sd: StateDict, prefix: str = "module.") -> StateDict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def overlay_clip_reid(base_sd: StateDict, reid_sd: StateDict) -> StateDict:
    """Overlay a CLIP-ReID training checkpoint onto an OpenAI CLIP state
    dict: `image_encoder.*` keys remap onto `visual.*`, `text_encoder.*`
    onto the top-level text keys. Convert the result with convert_clip."""
    out = dict(base_sd)
    for k, v in reid_sd.items():
        if k.startswith("image_encoder."):
            out["visual." + k[len("image_encoder."):]] = v
        elif k.startswith("text_encoder."):
            out[k[len("text_encoder."):]] = v
    return out


# ---------------------------------------------------------------------------
# shape-based architecture inference
# ---------------------------------------------------------------------------


def infer_config(
    sd: StateDict,
    image_hw: Tuple[int, int] = (224, 224),
    stride: Optional[int] = None,
    design: PromptDesign = PromptDesign(),
) -> CLIPConfig:
    if "visual.proj" not in sd:
        raise NotImplementedError(
            "ModifiedResNet CLIP towers are not ported yet (slice 5 of the port)"
        )
    text = TextConfig(
        layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        width=sd["ln_final.weight"].shape[0],
        heads=max(1, sd["ln_final.weight"].shape[0] // 64),
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
        output_dim=sd["text_projection"].shape[1],
        design=design,
    )
    width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    s = stride or patch
    hg, wg = VisionConfig.grid_for(image_hw, patch, s)
    vision = VisionConfig(
        layers=len({k.split(".")[3] for k in sd
                    if k.startswith("visual.transformer.resblocks.")}),
        width=width,
        patch_size=patch,
        stride=s,
        h_grid=hg,
        w_grid=wg,
        output_dim=sd["visual.proj"].shape[1],
        design=design,
    )
    return CLIPConfig(vision=vision, text=text, embed_dim=sd["text_projection"].shape[1])


# ---------------------------------------------------------------------------
# tower converters (numpy -> numpy dicts; device.to_device moves them)
# ---------------------------------------------------------------------------


def _linear(sd: StateDict, name: str) -> dict:
    p = {"w": sd[f"{name}.weight"].T.copy()}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"].copy()
    return p


def _ln(sd: StateDict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"].copy(), "bias": sd[f"{name}.bias"].copy()}


def _block(sd: StateDict, pre: str) -> dict:
    return {
        "attn": {
            "in_proj": {
                "w": sd[f"{pre}.attn.in_proj_weight"].T.copy(),
                "b": sd[f"{pre}.attn.in_proj_bias"].copy(),
            },
            "out_proj": _linear(sd, f"{pre}.attn.out_proj"),
        },
        "ln_1": _ln(sd, f"{pre}.ln_1"),
        "mlp": {
            "c_fc": _linear(sd, f"{pre}.mlp.c_fc"),
            "c_proj": _linear(sd, f"{pre}.mlp.c_proj"),
        },
        "ln_2": _ln(sd, f"{pre}.ln_2"),
    }


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _stack_blocks(sd: StateDict, prefix: str, n_layers: int) -> dict:
    return _stack([_block(sd, f"{prefix}.{i}") for i in range(n_layers)])


def _convert_vit_np(sd: StateDict, cfg: VisionConfig) -> dict:
    pos = sd["visual.positional_embedding"]
    n_tok = cfg.h_grid * cfg.w_grid + 1
    if pos.shape[0] != n_tok:
        pos = resize_pos_embed(pos, cfg.h_grid, cfg.w_grid)
    params = {
        "conv": {"w": sd["visual.conv1.weight"].transpose(2, 3, 1, 0).copy()},
        "class_embedding": sd["visual.class_embedding"].copy(),
        "positional_embedding": pos,
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": _stack_blocks(sd, "visual.transformer.resblocks", cfg.layers),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": sd["visual.proj"].copy(),
    }
    # learned VPT tokens, when the checkpoint has them (IVLP pretrained)
    if "visual.VPT" in sd:
        params["vpt_shallow"] = sd["visual.VPT"].copy()
    deep = sorted(
        (k for k in sd if re.match(r"visual\.transformer\.resblocks\.\d+\.VPT_shallow", k)),
        key=lambda k: int(k.split(".")[3]),
    )
    if deep and cfg.design.has_vision_prompts:
        layers = np.zeros((cfg.layers, cfg.design.vision_ctx, cfg.width), np.float32)
        for k in deep:
            layers[int(k.split(".")[3])] = sd[k]
        params["vpt_deep"] = layers
    return params


def _convert_text_np(sd: StateDict, cfg: TextConfig) -> dict:
    params = {
        "token_embedding": sd["token_embedding.weight"].copy(),
        "positional_embedding": sd["positional_embedding"].copy(),
        "blocks": _stack_blocks(sd, "transformer.resblocks", cfg.layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"].copy(),
    }
    deep = sorted(
        (k for k in sd if re.match(r"transformer\.resblocks\.\d+\.VPT_shallow", k)),
        key=lambda k: int(k.split(".")[2]),
    )
    if deep and cfg.design.has_language_prompts:
        layers = np.zeros((cfg.layers, cfg.design.language_ctx, cfg.width), np.float32)
        for k in deep:
            layers[int(k.split(".")[2])] = sd[k]
        params["vpt_deep"] = layers
    return params


def convert_vit(sd: StateDict, cfg: VisionConfig, device: DeviceLike = None) -> dict:
    """`visual.*`-keyed CLIP ViT tower -> models.vit params. Conv weights go
    OIHW -> HWIO; the positional grid is resized to (h_grid, w_grid)."""
    return to_device(_convert_vit_np(sd, cfg), resolve_device(device))


def convert_text(sd: StateDict, cfg: TextConfig, device: DeviceLike = None) -> dict:
    return to_device(_convert_text_np(sd, cfg), resolve_device(device))


def convert_clip(
    sd: StateDict,
    image_hw: Tuple[int, int] = (224, 224),
    stride: Optional[int] = None,
    design: PromptDesign = PromptDesign(),
    device: DeviceLike = None,
) -> Tuple[CLIPConfig, dict]:
    """Full OpenAI-format CLIP state dict -> (config, params) on `device`."""
    dev = resolve_device(device)
    cfg = infer_config(sd, image_hw=image_hw, stride=stride, design=design)
    params = {
        "visual": _convert_vit_np(sd, cfg.vision),
        "text": _convert_text_np(sd, cfg.text),
        "logit_scale": np.asarray(sd.get("logit_scale", math.log(1 / 0.07)),
                                  np.float32).reshape(()),
    }
    return cfg, to_device(params, dev)


def from_jax_params(params_np: dict, cfg: CLIPConfig, device: DeviceLike = None) -> dict:
    """The JAX package's parameter pytree (nested dicts of numpy arrays, the
    same structure and layouts) -> the port's parameters on `device`. The
    config is checked against the shapes it must match."""
    _check_patch_embed(params_np.get("visual", params_np), cfg)
    return to_device(params_np, resolve_device(device))


def _check_patch_embed(visual: dict, cfg: CLIPConfig) -> None:
    if "conv" in visual:
        w = np.shape(visual["conv"]["w"])
        want = (cfg.vision.patch_size, cfg.vision.patch_size, 3, cfg.vision.width)
        if tuple(w) != want:
            raise ValueError(f"patch-embed weight {w} does not match the config {want}")


def _check_shapes(tree, want: dict, where: str) -> None:
    for key, shape in want.items():
        got = tuple(np.shape(tree.get(key))) if key in tree else None
        if got != tuple(shape):
            raise ValueError(f"{where}[{key!r}] has shape {got}, the config needs {shape}")


def from_jax_reid_params(params_np: dict, cfg, device: DeviceLike = None) -> dict:
    """The JAX package's ReID parameter pytree (models/reid_clip.py layout,
    leaves as numpy arrays) -> the port's on `device`, checked against the
    ReidModelConfig `cfg`: the CLIP towers with their `vpt_*` tokens, the
    prompt learner (its int32 `eot_idx` included), the BNNeck heads with
    their running mean and variance, the adapter (adapter mode) and the
    zero-shot teacher (promptsrc)."""
    v, t = cfg.clip.vision, cfg.clip.text
    clip = params_np["clip"]
    _check_patch_embed(clip["visual"], cfg.clip)
    d = v.design
    if d.has_vision_prompts:
        _check_shapes(clip["visual"], {"vpt_shallow": (d.vision_ctx, v.width)}, "visual")
        if "vpt_deep" in clip["visual"]:
            _check_shapes(clip["visual"], {"vpt_deep": (v.layers, d.vision_ctx, v.width)},
                          "visual")
    if t.design.has_language_prompts and "vpt_deep" in clip["text"]:
        _check_shapes(clip["text"], {"vpt_deep": (t.layers, t.design.language_ctx, t.width)},
                      "text")
    pc = cfg.prompt
    pl = params_np["prompt_learner"]
    _check_shapes(pl, {"cls_ctx": (pc.n_cls, pc.n_cls_ctx, t.width)}, "prompt_learner")
    if np.asarray(pl["eot_idx"]).dtype.kind not in "iu":
        raise ValueError("prompt_learner['eot_idx'] must hold integers")
    head = params_np["head"]
    for name, dim in (("bn", v.width), ("bn_proj", cfg.clip.embed_dim)):
        _check_shapes(head[name], {k: (dim,) for k in ("scale", "bias", "mean", "var")},
                      f"head.{name}")
    _check_shapes(head["cls"], {"w": (v.width, pc.n_cls)}, "head.cls")
    _check_shapes(head["cls_proj"], {"w": (cfg.clip.embed_dim, pc.n_cls)}, "head.cls_proj")
    if cfg.mode == "adapter" and "adapter" not in params_np:
        raise ValueError("adapter mode needs an 'adapter' subtree")
    if cfg.mode == "promptsrc" and "zs_visual" not in params_np:
        raise ValueError("promptsrc needs a 'zs_visual' teacher subtree")
    return to_device(params_np, resolve_device(device))


def from_jax_multitask_params(params_np: dict, cfg, device: DeviceLike = None) -> dict:
    """The JAX package's multitask parameter pytree (train/multitask.py
    layout: `clip`, `prompt1/2`, `head1/2`, and `text2` / `pos_embed2` where
    the variant and the second geometry have them; leaves as numpy arrays)
    -> the port's on `device`, checked against the MultitaskModelConfig
    `cfg` as from_jax_reid_params checks a ReID tree."""
    v, t = cfg.clip.vision, cfg.clip.text
    clip = params_np["clip"]
    _check_patch_embed(clip["visual"], cfg.clip)
    _check_shapes(clip["visual"], {"positional_embedding": (1 + v.h_grid * v.w_grid, v.width)},
                  "visual")
    for i, pc in ((1, cfg.prompt1), (2, cfg.prompt2)):
        pl = params_np[f"prompt{i}"]
        _check_shapes(pl, {"cls_ctx": (pc.n_cls, pc.n_cls_ctx, t.width)}, f"prompt{i}")
        if np.asarray(pl["eot_idx"]).dtype.kind not in "iu":
            raise ValueError(f"prompt{i}['eot_idx'] must hold integers")
        head = params_np[f"head{i}"]
        for name, dim in (("bn", v.width), ("bn_proj", cfg.clip.embed_dim)):
            _check_shapes(head[name], {k: (dim,) for k in ("scale", "bias", "mean", "var")},
                          f"head{i}.{name}")
        _check_shapes(head["cls"], {"w": (v.width, pc.n_cls)}, f"head{i}.cls")
        _check_shapes(head["cls_proj"], {"w": (cfg.clip.embed_dim, pc.n_cls)},
                      f"head{i}.cls_proj")
    if cfg.dual_text != ("text2" in params_np):
        raise ValueError(f"variant {cfg.variant!r} {'needs' if cfg.dual_text else 'has no'} "
                         f"a 'text2' tower")
    v2 = cfg.clip2.vision
    if (v2.h_grid, v2.w_grid) != (v.h_grid, v.w_grid):
        _check_shapes(params_np, {"pos_embed2": (1 + v2.h_grid * v2.w_grid, v.width)}, "params")
    elif "pos_embed2" in params_np:
        raise ValueError("both tasks share one grid: the tree must have no 'pos_embed2'")
    return to_device(params_np, resolve_device(device))


def init_vpt(gen: torch.Generator, cfg: CLIPConfig, clip_params: dict) -> dict:
    """IVLP prompt tokens, N(0, 0.02) from `gen`, for the keys a checkpoint
    lacks (those it has are kept): the vision tower's `vpt_shallow`
    (ctx, width) and `vpt_deep` (layers, ctx, width), and the text tower's
    `vpt_deep` — the keys the JAX package's init_vit / init_text make for
    the design. Returns a new dict; new tokens land on the towers' device."""
    out = dict(clip_params, visual=dict(clip_params["visual"]),
               text=dict(clip_params["text"]))
    v, t = cfg.vision, cfg.text

    def fill(tower: dict, key: str, shape) -> None:
        tok = torch.randn(*shape, generator=gen, dtype=torch.float32) * 0.02
        tower.setdefault(key, tok.to(tower["blocks"]["ln_1"]["scale"].device))

    d = v.design
    if d.has_vision_prompts:
        fill(out["visual"], "vpt_shallow", (d.vision_ctx, v.width))
        if d.vision_depth > 1 and d.trainer in ("IVLP", "VPT"):
            fill(out["visual"], "vpt_deep", (v.layers, d.vision_ctx, v.width))
    d = t.design
    if d.has_language_prompts and d.language_depth > 1 and d.trainer in ("IVLP", "VPT"):
        fill(out["text"], "vpt_deep", (t.layers, d.language_ctx, t.width))
    return out


# ---------------------------------------------------------------------------
# random weights
# ---------------------------------------------------------------------------


def random_clip_state_dict(
    seed: int,
    *,
    vision_width: int = 768,
    vision_layers: int = 12,
    patch: int = 16,
    grid: int = 14,
    text_width: int = 512,
    text_layers: int = 12,
    vocab: int = 49408,
    context: int = 77,
    embed_dim: int = 512,
) -> StateDict:
    """Random OpenAI-format CLIP ViT state dict (float32 numpy) from a seed;
    the defaults are ViT-B/16's published shapes. Weight scales keep the
    activations of a deep random tower in a sane range."""
    rng = np.random.default_rng(seed)
    sd = {}

    def randn(*shape, std=1.0, mean=0.0):
        return (rng.standard_normal(shape, dtype=np.float32) * std + mean).astype(np.float32)

    def blocks(prefix, width, layers):
        std = width ** -0.5
        for i in range(layers):
            pre = f"{prefix}.{i}"
            sd[f"{pre}.attn.in_proj_weight"] = randn(3 * width, width, std=std)
            sd[f"{pre}.attn.in_proj_bias"] = randn(3 * width, std=0.01)
            sd[f"{pre}.attn.out_proj.weight"] = randn(width, width, std=std / 2)
            sd[f"{pre}.attn.out_proj.bias"] = randn(width, std=0.01)
            sd[f"{pre}.ln_1.weight"] = randn(width, std=0.01, mean=1.0)
            sd[f"{pre}.ln_1.bias"] = randn(width, std=0.01)
            sd[f"{pre}.ln_2.weight"] = randn(width, std=0.01, mean=1.0)
            sd[f"{pre}.ln_2.bias"] = randn(width, std=0.01)
            sd[f"{pre}.mlp.c_fc.weight"] = randn(4 * width, width, std=std)
            sd[f"{pre}.mlp.c_fc.bias"] = randn(4 * width, std=0.01)
            sd[f"{pre}.mlp.c_proj.weight"] = randn(width, 4 * width, std=std / 4)
            sd[f"{pre}.mlp.c_proj.bias"] = randn(width, std=0.01)

    sd["visual.conv1.weight"] = randn(vision_width, 3, patch, patch,
                                      std=(3 * patch * patch) ** -0.5)
    sd["visual.class_embedding"] = randn(vision_width, std=vision_width ** -0.5)
    sd["visual.positional_embedding"] = randn(grid * grid + 1, vision_width, std=0.01)
    sd["visual.ln_pre.weight"] = randn(vision_width, std=0.01, mean=1.0)
    sd["visual.ln_pre.bias"] = randn(vision_width, std=0.01)
    blocks("visual.transformer.resblocks", vision_width, vision_layers)
    sd["visual.ln_post.weight"] = randn(vision_width, std=0.01, mean=1.0)
    sd["visual.ln_post.bias"] = randn(vision_width, std=0.01)
    sd["visual.proj"] = randn(vision_width, embed_dim, std=vision_width ** -0.5)

    sd["token_embedding.weight"] = randn(vocab, text_width, std=0.02)
    sd["positional_embedding"] = randn(context, text_width, std=0.01)
    blocks("transformer.resblocks", text_width, text_layers)
    sd["ln_final.weight"] = randn(text_width, std=0.01, mean=1.0)
    sd["ln_final.bias"] = randn(text_width, std=0.01)
    sd["text_projection"] = randn(text_width, embed_dim, std=text_width ** -0.5)
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return sd
