"""OpenAI-format CLIP state dict -> the port's parameter dicts.

The parameter dicts have the JAX package's structure and layouts (linear
weights (in, out), the ViT's patch-embed conv HWIO, blocks stacked on a
leading layer axis; a ResNet tower keeps torch's OIHW conv weights and a
list of blocks per layer), holding torch tensors on the requested device — CUDA unless
device="cpu". The architecture is inferred from state-dict shapes; the square
pretrained positional grid is bicubic-resized to the rectangular ReID grid at
load time (models/clip_model.resize_pos_embed).

`from_jax_params` takes the JAX package's parameter pytree (as numpy arrays)
to the same dicts, so both packages can run one set of weights;
`from_jax_reid_params` does so for a whole ReID model (towers with their VPT
tokens, prompt learner, heads with BN running statistics, adapter, the
promptsrc teacher), checked against the model config. `init_vpt` gives IVLP
prompt tokens to a checkpoint that has none.
`random_clip_state_dict` makes a random OpenAI-format ViT or RN50 state dict
from a seed, for smoke runs and tests at full width without a checkpoint.
`overlay_clip_reid` lays a CLIP-ReID checkpoint over a CLIP state dict (the
CLI's --clip_weights).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_reid_torch.configs import (
    CLIPConfig, PromptDesign, ResNetConfig, TextConfig, VisionConfig,
)
from tpu_reid_torch.device import DeviceLike, resolve_device, to_device
from tpu_reid_torch.models.clip_model import resize_pos_embed
from tpu_reid_torch.models.resnet import EXPANSION

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
    text = TextConfig(
        layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        width=sd["ln_final.weight"].shape[0],
        heads=max(1, sd["ln_final.weight"].shape[0] // 64),
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
        output_dim=sd["text_projection"].shape[1],
        design=design,
    )
    embed_dim = sd["text_projection"].shape[1]
    if "visual.proj" not in sd:  # a ModifiedResNet tower
        counts = tuple(
            len({int(k.split(".")[2]) for k in sd
                 if re.match(rf"visual\.layer{b}\.\d+\.conv1\.weight", k)})
            for b in range(1, 5))
        hg, wg = ResNetConfig.grid_for(image_hw, layer4_stride=1)
        resnet = ResNetConfig(layers=counts, width=sd["visual.conv1.weight"].shape[0] * 2,
                              output_dim=sd["visual.attnpool.c_proj.weight"].shape[0],
                              h_grid=hg, w_grid=wg)
        return CLIPConfig(resnet=resnet, text=text, embed_dim=embed_dim)
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
    return CLIPConfig(vision=vision, text=text, embed_dim=embed_dim)


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


def _bn(sd: StateDict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"].copy(), "bias": sd[f"{name}.bias"].copy(),
            "mean": sd[f"{name}.running_mean"].copy(), "var": sd[f"{name}.running_var"].copy()}


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


def _convert_resnet_np(sd: StateDict, cfg: ResNetConfig) -> dict:
    def conv(name):  # OIHW, torch's layout, kept as it is
        return {"w": sd[f"{name}.weight"].copy()}

    params = {
        "conv1": conv("visual.conv1"), "bn1": _bn(sd, "visual.bn1"),
        "conv2": conv("visual.conv2"), "bn2": _bn(sd, "visual.bn2"),
        "conv3": conv("visual.conv3"), "bn3": _bn(sd, "visual.bn3"),
    }
    for li, blocks in enumerate(cfg.layers):
        layer = []
        for j in range(blocks):
            pre = f"visual.layer{li + 1}.{j}"
            blk = {
                "conv1": conv(f"{pre}.conv1"), "bn1": _bn(sd, f"{pre}.bn1"),
                "conv2": conv(f"{pre}.conv2"), "bn2": _bn(sd, f"{pre}.bn2"),
                "conv3": conv(f"{pre}.conv3"), "bn3": _bn(sd, f"{pre}.bn3"),
            }
            # index 0 holds a weight only in the [conv 1x1, bn] layout (in
            # CLIP's [avgpool, conv 1x1, bn] it is the pool), so it decides
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = conv(f"{pre}.downsample.0")
                blk["down_bn"] = _bn(sd, f"{pre}.downsample.1")
            elif f"{pre}.downsample.1.weight" in sd:
                blk["down_conv"] = conv(f"{pre}.downsample.1")
                blk["down_bn"] = _bn(sd, f"{pre}.downsample.2")
            layer.append(blk)
        params[f"layer{li + 1}"] = layer
    pos = sd["visual.attnpool.positional_embedding"]
    if pos.shape[0] != cfg.h_grid * cfg.w_grid + 1:
        pos = resize_pos_embed(pos, cfg.h_grid, cfg.w_grid)
    params["attnpool"] = {
        "positional_embedding": pos,
        **{name: _linear(sd, f"visual.attnpool.{name}")
           for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return params


def convert_resnet(sd: StateDict, cfg: ResNetConfig, device: DeviceLike = None) -> dict:
    """`visual.*`-keyed CLIP ModifiedResNet tower -> models.resnet params
    (conv weights OIHW, both downsample key layouts); the attention pool's
    positional grid is resized from the checkpoint's square grid to
    (h_grid, w_grid)."""
    return to_device(_convert_resnet_np(sd, cfg), resolve_device(device))


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
        "visual": (_convert_vit_np(sd, cfg.vision) if cfg.vision is not None
                   else _convert_resnet_np(sd, cfg.resnet)),
        "text": _convert_text_np(sd, cfg.text),
        "logit_scale": np.asarray(sd.get("logit_scale", math.log(1 / 0.07)),
                                  np.float32).reshape(()),
    }
    return cfg, to_device(params, dev)


def from_jax_params(params_np: dict, cfg: CLIPConfig, device: DeviceLike = None) -> dict:
    """The JAX package's parameter pytree (nested dicts of numpy arrays, the
    same structure and layouts but for a ResNet tower's conv weights, which
    go HWIO -> OIHW) -> the port's parameters on `device`. The config is
    checked against the shapes it must match."""
    if cfg.resnet is not None:
        if "visual" in params_np:
            params_np = dict(params_np, visual=resnet_from_jax(params_np["visual"]))
        else:
            params_np = resnet_from_jax(params_np)
    else:
        _check_patch_embed(params_np.get("visual", params_np), cfg)
    return to_device(params_np, resolve_device(device))


def resnet_from_jax(visual: dict) -> dict:
    """A JAX ResNet tower's parameters -> the port's: the conv weights
    (every 4-d leaf) HWIO -> OIHW, the rest as it is."""
    if isinstance(visual, dict):
        return {k: resnet_from_jax(v) for k, v in visual.items()}
    if isinstance(visual, list):
        return [resnet_from_jax(v) for v in visual]
    a = np.asarray(visual)
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a


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
    their running mean and variance, the adapter (adapter mode), the
    zero-shot teacher (promptsrc), MaPLe's couplings (maple), the JPM branch
    and its head (use_jpm) and the SIE table (sie_ids > 0)."""
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
    if cfg.mode == "maple":
        mp = params_np["maple"]
        depth = np.shape(mp["proj"]["w"])[0]
        n_ctx = np.shape(mp["shared_ctx"])[0]
        _check_shapes(mp, {"shared_ctx": (n_ctx, t.width),
                           "text_deep": (max(depth - 1, 0), n_ctx, t.width)}, "maple")
        _check_shapes(mp["proj"], {"w": (depth, t.width, v.width), "b": (depth, v.width)},
                      "maple.proj")
    if cfg.use_jpm:
        _check_shapes(params_np["jpm"]["ln"], {"scale": (v.width,), "bias": (v.width,)},
                      "jpm.ln")
        _check_shapes(params_np["jpm"]["block"]["ln_1"], {"scale": (v.width,)}, "jpm.block")
        bn = params_np["jpm_head"]["bn"]
        _check_shapes(bn, {k: (v.width,) for k in ("scale", "bias", "mean", "var")},
                      "jpm_head.bn")
        _check_shapes(params_np["jpm_head"]["cls"], {"w": (v.width, pc.n_cls)},
                      "jpm_head.cls")
    if cfg.sie_ids > 0:
        _check_shapes(params_np, {"sie_embed": (cfg.sie_ids, v.width)}, "params")
    for key, used in (("maple", cfg.mode == "maple"), ("jpm", cfg.use_jpm),
                      ("sie_embed", cfg.sie_ids > 0)):
        if key in params_np and not used:
            raise ValueError(f"the tree has a {key!r} subtree the config does not use")
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
    vision: str = "vit",
    vision_width: int = 768,
    vision_layers: int = 12,
    patch: int = 16,
    grid: Optional[int] = None,
    rn_layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
    rn_width: int = 64,
    text_width: int = 512,
    text_layers: int = 12,
    vocab: int = 49408,
    context: int = 77,
    embed_dim: Optional[int] = None,
) -> StateDict:
    """Random OpenAI-format CLIP state dict (float32 numpy) from a seed.
    vision="vit": the defaults are ViT-B/16's published shapes (a 14x14
    pretrained grid, embed_dim 512). vision="rn50": a ModifiedResNet with
    `rn_layers` and `rn_width` (RN50: (3, 4, 6, 3), 64; an attention pool
    2048 wide with 32 heads over a 7x7 grid, output and embed_dim 1024).
    Weight scales keep the activations of a deep random tower in a sane
    range (for the ResNet: He-scaled convs, each bottleneck's last BatchNorm
    at scale 0.25)."""
    if vision not in ("vit", "rn50"):
        raise ValueError(f"vision must be 'vit' or 'rn50': {vision!r}")
    rn = vision == "rn50"
    grid = grid or (7 if rn else 14)
    embed_dim = embed_dim or (1024 if rn else 512)
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

    def conv(name, cin, cout, k):
        sd[f"{name}.weight"] = randn(cout, cin, k, k, std=(2.0 / (cin * k * k)) ** 0.5)

    def bn(name, c, scale=1.0):
        sd[f"{name}.weight"] = randn(c, std=0.01 * scale, mean=scale)
        sd[f"{name}.bias"] = randn(c, std=0.01)
        sd[f"{name}.running_mean"] = randn(c, std=0.01)
        sd[f"{name}.running_var"] = 1.0 + np.abs(randn(c, std=0.01))

    if rn:
        w = rn_width
        conv("visual.conv1", 3, w // 2, 3)
        bn("visual.bn1", w // 2)
        conv("visual.conv2", w // 2, w // 2, 3)
        bn("visual.bn2", w // 2)
        conv("visual.conv3", w // 2, w, 3)
        bn("visual.bn3", w)
        cin = w
        for li, n_blocks in enumerate(rn_layers):
            planes = w * 2 ** li
            for j in range(n_blocks):
                pre = f"visual.layer{li + 1}.{j}"
                conv(f"{pre}.conv1", cin, planes, 1)
                bn(f"{pre}.bn1", planes)
                conv(f"{pre}.conv2", planes, planes, 3)
                bn(f"{pre}.bn2", planes)
                conv(f"{pre}.conv3", planes, planes * EXPANSION, 1)
                bn(f"{pre}.bn3", planes * EXPANSION, scale=0.25)
                if j == 0:  # CLIP's downsample: [avgpool, conv 1x1, bn]
                    conv(f"{pre}.downsample.1", cin, planes * EXPANSION, 1)
                    bn(f"{pre}.downsample.2", planes * EXPANSION)
                cin = planes * EXPANSION
        width = w * 32
        sd["visual.attnpool.positional_embedding"] = randn(grid * grid + 1, width,
                                                           std=width ** -0.5)
        for name, out in (("q_proj", width), ("k_proj", width), ("v_proj", width),
                          ("c_proj", embed_dim)):
            sd[f"visual.attnpool.{name}.weight"] = randn(out, width, std=width ** -0.5)
            sd[f"visual.attnpool.{name}.bias"] = randn(out, std=0.01)
    else:
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


# ---------------------------------------------------------------------------
# EVA02 vision towers (EVA-CLIP)
# ---------------------------------------------------------------------------


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def pack_swiglu(w1: torch.Tensor, w2: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Gate (..., F) and up (..., F) as the swiglu mode's packed (..., 2 F_pad):
    each 128-column group 64 gate columns, then the same 64 up columns; the
    padding past F zero."""
    g = _pad_last(w1, f_pad).unflatten(-1, (-1, 64))
    u = _pad_last(w2, f_pad).unflatten(-1, (-1, 64))
    return torch.stack([g, u], dim=-2).flatten(-3)


def eva02_visual_params(nat: dict) -> dict:
    """An EVA02 vision tower as EVA-CLIP lays it out (blocks stacked on a
    leading layer axis, linear weights (in, out)) -> the port's parameter
    dict (models/layers.py's EVA block layout; models/vit.py's tower).

    nat: conv {w (p, p, 3, D) HWIO, b}; class_embedding; positional_embedding;
    blocks {ln_1, ln_2 {scale, bias}; attn {qkv {w (L, D, 3D)}, q_bias, v_bias
    (L, D), inner_ln {scale, bias} or absent, proj {w, b}}; mlp {w1, w2 {w
    (L, D, F), b}, ffn_ln {scale, bias} (L, F) or absent, w3 {w (L, F, D),
    b}}}; ln_post; head {w (D, E), b}; optionally vpt_shallow, vpt_deep.
    Copies: the result shares no storage with `nat`."""
    from tpu_reid_torch.ops.fused_eva import padded_hidden

    bl = nat["blocks"]
    a, m = bl["attn"], bl["mlp"]
    f = m["w1"]["w"].shape[-1]
    f_pad = padded_hidden(f)
    q_b, v_b = a["q_bias"], a["v_bias"]
    attn = {"in_proj": {"w": a["qkv"]["w"].clone(),
                        "b": torch.cat([q_b, torch.zeros_like(q_b), v_b], dim=-1)},
            "out_proj": {"w": a["proj"]["w"].clone(), "b": a["proj"]["b"].clone()}}
    if "inner_ln" in a:
        attn["ln"] = {k: v.clone() for k, v in a["inner_ln"].items()}
    mlp = {"w12": {"w": pack_swiglu(m["w1"]["w"], m["w2"]["w"], f_pad),
                   "b": pack_swiglu(m["w1"]["b"], m["w2"]["b"], f_pad)},
           "w3": {"w": _pad_last(m["w3"]["w"].transpose(-1, -2), f_pad).transpose(-1, -2)
                  .contiguous(), "b": m["w3"]["b"].clone()}}
    if "ffn_ln" in m:
        mlp["ffn_ln"] = {k: _pad_last(v, f_pad) for k, v in m["ffn_ln"].items()}
    out = {
        "conv": {"w": nat["conv"]["w"].clone(), "bias": nat["conv"]["b"].clone()},
        "class_embedding": nat["class_embedding"].clone(),
        "positional_embedding": nat["positional_embedding"].clone(),
        "blocks": {"ln_1": {k: v.clone() for k, v in bl["ln_1"].items()}, "attn": attn,
                   "ln_2": {k: v.clone() for k, v in bl["ln_2"].items()}, "mlp": mlp},
        "ln_post": {k: v.clone() for k, v in nat["ln_post"].items()},
        "proj": nat["head"]["w"].clone(),
        "proj_bias": nat["head"]["b"].clone(),
    }
    for key in ("vpt_shallow", "vpt_deep"):
        if key in nat:
            out[key] = nat[key].clone()
    return out


# ---------------------------------------------------------------------------
# EVA02-CLIP-E/14's post-norm vision tower (EVA-CLIP, EVA02-CLIP-bigE-14)
# ---------------------------------------------------------------------------


def eva_e_params(nat: dict) -> dict:
    """The post-norm tower with its blocks stacked on a leading layer axis and
    linear weights (in, out) -> the port's parameter dict (models/layers.py's
    `eva_e_block` layout, ops/fused_eva_e.py; models/vit.py's tower).

    nat: conv {w (p, p, 3, D) HWIO, b}; class_embedding (D,);
    positional_embedding (T, D); blocks {norm1, norm2 {scale, bias} (L, D);
    attn {qkv {w (L, D, 3D)}, q_bias, v_bias (L, D), proj {w (L, D, D), b}};
    mlp {fc1 {w (L, D, F), b}, fc2 {w (L, F, D), b}}}; norm {scale, bias};
    head {w (D, E), b}; optionally vpt_shallow, vpt_deep. Copies: the result
    shares no storage with `nat`."""
    bl = nat["blocks"]
    a, m = bl["attn"], bl["mlp"]
    q_b, v_b = a["q_bias"], a["v_bias"]
    copy = lambda node: {k: v.clone() for k, v in node.items()}  # noqa: E731
    out = {
        "conv": {"w": nat["conv"]["w"].clone(), "bias": nat["conv"]["b"].clone()},
        "class_embedding": nat["class_embedding"].clone(),
        "positional_embedding": nat["positional_embedding"].clone(),
        "blocks": {
            "attn": {"in_proj": {"w": a["qkv"]["w"].clone(),
                                 "b": torch.cat([q_b, torch.zeros_like(q_b), v_b], dim=-1)},
                     "out_proj": copy(a["proj"])},
            "ln_1": copy(bl["norm1"]),
            "mlp": {"fc1": copy(m["fc1"]), "fc2": copy(m["fc2"])},
            "ln_2": copy(bl["norm2"]),
        },
        "ln_post": copy(nat["norm"]),
        "proj": nat["head"]["w"].clone(),
        "proj_bias": nat["head"]["b"].clone(),
    }
    for key in ("vpt_shallow", "vpt_deep"):
        if key in nat:
            out[key] = nat[key].clone()
    return out


def eva_e_visual_params(sd: dict, prefix: str = "visual.") -> dict:
    """An EVA-CLIP EVA02-CLIP-E/14 state dict (its own names under `prefix`,
    PyTorch's (out, in) linear weights, the patch embedding OIHW) -> the
    port's parameter dict of the image tower (`eva_e_params`). Names read:
    cls_token, pos_embed, patch_embed.proj.{weight, bias}, blocks.{i}.{norm1,
    norm2}.{weight, bias}, blocks.{i}.attn.{qkv.weight, q_bias, v_bias,
    proj.weight, proj.bias}, blocks.{i}.mlp.{fc1, fc2}.{weight, bias},
    norm.{weight, bias}, head.{weight, bias}; the layers are counted from the
    blocks present. The positional embedding is taken at the checkpoint's
    grid. A missing name raises KeyError naming it."""

    def get(name: str) -> torch.Tensor:
        key = prefix + name
        if key not in sd:
            raise KeyError(f"EVA-CLIP state dict: no {key!r}")
        return torch.as_tensor(sd[key]).float()

    head = prefix + "blocks."
    n_layers = 1 + max((int(k[len(head):].split(".")[0]) for k in sd if k.startswith(head)),
                       default=-1)
    if n_layers < 1:
        raise KeyError(f"EVA-CLIP state dict: no {head + '0'!r} block")

    def stack(name: str, transpose: bool = False) -> torch.Tensor:
        ts = [get(f"blocks.{i}.{name}") for i in range(n_layers)]
        return torch.stack([t.t() if transpose else t for t in ts])

    def ln(name: str) -> dict:
        return {"scale": stack(f"{name}.weight"), "bias": stack(f"{name}.bias")}

    nat = {
        "conv": {"w": get("patch_embed.proj.weight").permute(2, 3, 1, 0),
                 "b": get("patch_embed.proj.bias")},
        "class_embedding": get("cls_token").reshape(-1),
        "positional_embedding": get("pos_embed").reshape(-1, get("cls_token").numel()),
        "blocks": {
            "norm1": ln("norm1"), "norm2": ln("norm2"),
            "attn": {"qkv": {"w": stack("attn.qkv.weight", True)},
                     "q_bias": stack("attn.q_bias"), "v_bias": stack("attn.v_bias"),
                     "proj": {"w": stack("attn.proj.weight", True),
                              "b": stack("attn.proj.bias")}},
            "mlp": {"fc1": {"w": stack("mlp.fc1.weight", True), "b": stack("mlp.fc1.bias")},
                    "fc2": {"w": stack("mlp.fc2.weight", True), "b": stack("mlp.fc2.bias")}},
        },
        "norm": {"scale": get("norm.weight"), "bias": get("norm.bias")},
        "head": {"w": get("head.weight").t(), "b": get("head.bias")},
    }
    return eva_e_params(nat)
