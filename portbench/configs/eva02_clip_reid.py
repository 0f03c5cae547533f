"""Plain PyTorch reference of the EVA02-CLIP-L/14 vision tower as a ReID
model with IVLP's prompt tokens.

It follows the published model (BAAI's EVA-CLIP, arXiv:2303.15389 and
arXiv:2303.11331; model config EVA02-CLIP-L-14.json, the tower in
eva_vit_model.py) and is written from its equations: float32 arithmetic (TF32
off for matmul and cuDNN under `Precision.scope`), no kernel, no batching
trick, nothing of the program under test. Per block, x (B, S, D), every
LayerNorm with epsilon 1e-6:

  h = LN_1(x);  q = h W_q + b_q,  k = h W_k (no bias),  v = h W_v + b_v
  q, k of the grid tokens rotated by 2D RoPE (below); CLS not rotated
  x = x + LN_attn(softmax(q k^T / sqrt(64)) v) W_o + b_o
  g = LN_2(x);  u = SiLU(g W_1 + b_1) * (g W_2 + b_2)
  x = x + LN_ffn(u) W_3 + b_3

RoPE, per head of 64: the grid token at (r, c) turns dims 0-31 by t_r =
r * 16 / h_grid and dims 32-63 by t_c = c * 16 / w_grid (EVA's intp_freq from
pt_hw_seq_len 16); within a half, pair p (dims 2p, 2p + 1) by t * 10000^(-2p
/ 32): y_2p = x_2p cos - x_2p+1 sin, y_2p+1 = x_2p+1 cos + x_2p sin.

The stem: a 14 x 14 convolution at stride 14 with a bias, CLS, the positional
embedding; no ln_pre. The head: y = LN_post(x[:, 0]), proj = y W_h + b_h; the
retrieval embedding cat(y, proj).

Departures from EVA-CLIP, each this system's: the input is a 256 x 256
vehicle crop (an 18 x 18 grid, the positional embedding drawn at that size
rather than resized from 16 x 16); IVLP's prompt tokens, appended after the
grid and replaced in blocks 1 .. depth-1, pass RoPE unrotated, as CLS does
(EVA rotates every token after CLS; its grid has no prompt tokens); for a
grid that is not square each axis is interpolated over its own length (EVA's
grids are square); random weights from the seed.

Parameters are a flat dict {name: tensor} in EVA-CLIP's own layout (the
program binding lays them out for the program): linear weights (in, out),
the patch embedding HWIO, blocks stacked on a leading layer axis, the q and
v biases apart from the packed qkv weight.

`Precision` says how every product is computed, as ivlp_clip_reid's does
(repeated here: a reference imports nothing but torch): "fp32" (TF32 off:
the reference), "tf32" (TF32 on) and "fp8" (the operands of every product
rounded to float8 e4m3 with one scale per tensor: the control of a bf16
program).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

Tensor = torch.Tensor

E4M3_MAX = 448.0


class Precision:
    """How the reference's products are computed; `scope()` sets the
    process's TF32 switches for the duration."""

    NAMES = ("fp32", "tf32", "fp8")

    def __init__(self, name: str):
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}: {name!r}")
        self.name = name

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.name == "fp8":
            return _fp8(a) @ _fp8(b)
        return a @ b

    @contextlib.contextmanager
    def scope(self):
        cuda_mm = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        prec = torch.get_float32_matmul_precision()
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        torch.set_float32_matmul_precision("high" if on else "highest")
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cuda_mm
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.set_float32_matmul_precision(prec)


def _fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def normalize(cfg: dict, images_u8: Tensor) -> Tensor:
    """uint8 (B, H, W, 3) -> the model's input scale, float32."""
    mean = torch.tensor(cfg["pixel_mean"], dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(cfg["pixel_std"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def grid(cfg: dict):
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    return (h - p) // s + 1, (w - p) // s + 1


def seq_len(cfg: dict) -> int:
    hg, wg = grid(cfg)
    return hg * wg + 1 + cfg["vision_ctx"]


def param_spec(cfg: dict, parts: List[str]) -> list:
    """[(name, shape, std, mean)] of the image tower's parameters with its
    prompt tokens ("visual"; the only part this reference has). A leaf is
    mean + std x N(0, 1). The scales are a checkpoint's random stand-in:
    LayerNorm gains near 1, 1/sqrt(fan-in) projections, the residual
    branches' last products halved."""
    if parts != ["visual"]:
        raise ValueError(f"the EVA02 reference has the visual part only, not {parts}")
    d, e, f, n = cfg["vision_width"], cfg["embed_dim"], cfg["mlp_hidden"], cfg["vision_layers"]
    p, n_v = cfg["patch"], cfg["vision_ctx"]
    hg, wg = grid(cfg)
    v, bl = "clip/visual", "clip/visual/blocks"
    std = d ** -0.5
    spec = [
        (f"{v}/conv/w", (p, p, 3, d), (3 * p * p) ** -0.5, 0.0),
        (f"{v}/conv/b", (d,), 0.02, 0.0),
        (f"{v}/class_embedding", (d,), std, 0.0),
        (f"{v}/positional_embedding", (1 + hg * wg, d), 0.02, 0.0),
    ]
    for name, shape, sd, mean in (
        ("ln_1/scale", (d,), 0.02, 1.0), ("ln_1/bias", (d,), 0.02, 0.0),
        ("attn/qkv/w", (d, 3 * d), std, 0.0),
        ("attn/q_bias", (d,), 0.02, 0.0), ("attn/v_bias", (d,), 0.02, 0.0),
        ("attn/inner_ln/scale", (d,), 0.02, 1.0), ("attn/inner_ln/bias", (d,), 0.02, 0.0),
        ("attn/proj/w", (d, d), std / 2, 0.0), ("attn/proj/b", (d,), 0.02, 0.0),
        ("ln_2/scale", (d,), 0.02, 1.0), ("ln_2/bias", (d,), 0.02, 0.0),
        ("mlp/w1/w", (d, f), std, 0.0), ("mlp/w1/b", (f,), 0.02, 0.0),
        ("mlp/w2/w", (d, f), std, 0.0), ("mlp/w2/b", (f,), 0.02, 0.0),
        ("mlp/ffn_ln/scale", (f,), 0.02, 1.0), ("mlp/ffn_ln/bias", (f,), 0.02, 0.0),
        ("mlp/w3/w", (f, d), f ** -0.5 / 2, 0.0), ("mlp/w3/b", (d,), 0.02, 0.0),
    ):
        spec.append((f"{bl}/{name}", (n,) + shape, sd, mean))
    spec += [
        (f"{v}/ln_post/scale", (d,), 0.02, 1.0),
        (f"{v}/ln_post/bias", (d,), 0.02, 0.0),
        (f"{v}/head/w", (d, e), std, 0.0),
        (f"{v}/head/b", (e,), 0.02, 0.0),
        (f"{v}/vpt_shallow", (n_v, d), 0.02, 0.0),
        (f"{v}/vpt_deep", (n, n_v, d), 0.02, 0.0),
    ]
    return spec


def layer_norm(x: Tensor, g: Tensor, b: Tensor, eps: float) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def rope_cos_sin(cfg: dict, device):
    """EVA's VisionRotaryEmbeddingFast at the grid: (cos, sin), each
    (grid tokens, 64), every frequency repeated for its pair."""
    hg, wg = grid(cfg)
    half = 64 // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, 2, dtype=torch.float64)[: half // 2]
                               / half))
    pt = cfg["pt_hw_seq_len"]
    t_r = torch.arange(hg, dtype=torch.float64) / hg * pt
    t_c = torch.arange(wg, dtype=torch.float64) / wg * pt
    f_r = torch.einsum("i,f->if", t_r, freqs).repeat_interleave(2, dim=-1)  # (hg, 32)
    f_c = torch.einsum("i,f->if", t_c, freqs).repeat_interleave(2, dim=-1)  # (wg, 32)
    ang = torch.cat([f_r[:, None, :].expand(hg, wg, half),
                     f_c[None, :, :].expand(hg, wg, half)], dim=-1).reshape(hg * wg, 64)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rotate_half(x: Tensor) -> Tensor:
    """(..., 2p, 2p + 1) -> (..., -x_2p+1, x_2p): EVA's interleaved rotate_half."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def rope(t: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    return t * cos + rotate_half(t) * sin


def block(P: Precision, W: Dict[str, Tensor], i: int, x: Tensor, heads: int, cos: Tensor,
          sin: Tensor, eps: float) -> Tensor:
    """EVA02 block i (equations in the module's notes); the grid tokens are
    rows 1 .. 1 + len(cos)."""
    g = lambda n: W[f"clip/visual/blocks/{n}"][i].float()  # noqa: E731
    b, s, d = x.shape
    dh = d // heads
    n_grid = cos.shape[0]
    h = layer_norm(x, g("ln_1/scale"), g("ln_1/bias"), eps)
    bias = torch.cat([g("attn/q_bias"), torch.zeros_like(g("attn/q_bias")), g("attn/v_bias")])
    q, k, v = (P.mm(h, g("attn/qkv/w")) + bias).split(d, dim=-1)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2) for t in (q, k, v))
    grid_rows = slice(1, 1 + n_grid)
    q = torch.cat([q[:, :, :1], rope(q[:, :, grid_rows], cos, sin), q[:, :, 1 + n_grid:]], 2)
    k = torch.cat([k[:, :, :1], rope(k[:, :, grid_rows], cos, sin), k[:, :, 1 + n_grid:]], 2)
    scores = P.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    a = P.mm(scores.softmax(dim=-1), v).transpose(1, 2).reshape(b, s, d)
    a = layer_norm(a, g("attn/inner_ln/scale"), g("attn/inner_ln/bias"), eps)
    x = x + P.mm(a, g("attn/proj/w")) + g("attn/proj/b")
    h = layer_norm(x, g("ln_2/scale"), g("ln_2/bias"), eps)
    u = torch.nn.functional.silu(P.mm(h, g("mlp/w1/w")) + g("mlp/w1/b")) \
        * (P.mm(h, g("mlp/w2/w")) + g("mlp/w2/b"))
    u = layer_norm(u, g("mlp/ffn_ln/scale"), g("mlp/ffn_ln/bias"), eps)
    return x + P.mm(u, g("mlp/w3/w")) + g("mlp/w3/b")


def vision(P: Precision, W: Dict[str, Tensor], cfg: dict, x: Tensor):
    """Normalized images (B, H, W, 3) -> the CLS features (last, non_proj,
    proj): the input of the last block, LN_post of the tower's output, and
    its projection. Patches (stride = patch) as one
    product plus the conv's bias, CLS and positions, the shallow prompt
    tokens appended; block i replaces the last n_ctx tokens by its own
    prompts for 0 < i < depth."""
    v = "clip/visual"
    f = lambda n: W[f"{v}/{n}"].float()  # noqa: E731
    p, s, d = cfg["patch"], cfg["stride"], cfg["vision_width"]
    n_ctx, heads, eps = cfg["vision_ctx"], cfg["vision_heads"], cfg["ln_eps"]
    b = x.shape[0]
    patches = x.unfold(1, p, s).unfold(2, p, s)  # (B, hg, wg, 3, p, p)
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, p * p * 3)
    x = P.mm(patches, f("conv/w").reshape(p * p * 3, d)) + f("conv/b")
    x = torch.cat([f("class_embedding").expand(b, 1, d), x], dim=1) + f("positional_embedding")
    x = torch.cat([x, f("vpt_shallow").expand(b, n_ctx, d)], dim=1)
    cos, sin = rope_cos_sin(cfg, x.device)
    deep = f("vpt_deep")
    layers = cfg["vision_layers"]
    last = None
    for i in range(layers):
        if 0 < i < cfg["prompt_depth"]:
            x = torch.cat([x[:, :-n_ctx], deep[i].expand(b, n_ctx, d)], dim=1)
        if i == layers - 1:
            last = x[:, 0]
        x = block(P, W, i, x, heads, cos, sin, eps)
    non_proj = layer_norm(x[:, 0], f("ln_post/scale"), f("ln_post/bias"), eps)
    return last, non_proj, P.mm(non_proj, f("head/w")) + f("head/b")


def eval_embeddings(P: Precision, W: Dict[str, Tensor], cfg: dict, images_u8: Tensor,
                    flip_tta: bool = True) -> Tensor:
    """The retrieval embedding cat(non_proj, proj), averaged over the image
    and its horizontal mirror when flip_tta."""
    x = normalize(cfg, images_u8)
    out = torch.cat(vision(P, W, cfg, x)[1:], dim=-1)
    if flip_tta:
        out = 0.5 * (out + torch.cat(vision(P, W, cfg, x.flip(2))[1:], dim=-1))
    return out
