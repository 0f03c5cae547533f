"""Plain PyTorch reference of the EVA02-CLIP-E/14 vision tower as a ReID
model with IVLP's prompt tokens.

It follows the published model (BAAI's EVA-CLIP, arXiv:2303.15389; model
config EVA02-CLIP-bigE-14.json, the tower in eva_vit_model.py, Block.forward's
postnorm branch) and is written from its equations: float32 arithmetic (TF32
off for matmul and cuDNN under `Precision.scope`), no kernel, no batching
trick, nothing of the program under test. Per block, x (B, S, D), D = 1792,
16 heads of dh = 112, hidden F = 15360, every LayerNorm with epsilon 1e-6:

  q = x W_q + b_q,  k = x W_k (no bias),  v = x W_v + b_v   (no LayerNorm first)
  x = x + LN_1(softmax(q k^T / sqrt(dh)) v W_o + b_o)
  x = x + LN_2(GELU(x W_1 + b_1) W_2 + b_2),   GELU(z) = z Phi(z) (erf form)

The stem: a 14 x 14 convolution at stride 14 with a bias, CLS, the positional
embedding; no ln_pre. The head: y = LN_post(x[:, 0]), proj = y W_h + b_h; the
retrieval embedding cat(y, proj).

Departures from EVA-CLIP, each this system's: the input is a 256 x 128
person crop (an 18 x 9 grid, the positional embedding drawn at that size
rather than resized from 16 x 16); IVLP's prompt tokens, appended after the
grid and replaced in blocks 1 .. depth-1; random weights from the seed.
EVA-CLIP's xattn and fusedLN choose kernels, not arithmetic.

The attention and the MLP are computed over row chunks of the batch's
tokens (`CHUNK_TOKENS`), so that the scores and the 15360-wide hidden
activation of a 64-image check fit beside the weights: a chunk is exact
(rows are independent there), not an approximation.

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
CHUNK_TOKENS = 4096  # rows of (B * S) per chunk of the MLP and of the attention's queries


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
    1/sqrt(fan-in) projections, LN_post's gain near 1 and the post-norms'
    gains near 0.1: the residual stream enters q and k without a LayerNorm,
    so its scale sets the attention logits, and 128 branch outputs of unit
    scale would grow it elevenfold and saturate every softmax; at 0.1 it ends
    about 1.5 times its start."""
    if parts != ["visual"]:
        raise ValueError(f"the EVA02-E reference has the visual part only, not {parts}")
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
        ("attn/qkv/w", (d, 3 * d), std, 0.0),
        ("attn/q_bias", (d,), 0.02, 0.0), ("attn/v_bias", (d,), 0.02, 0.0),
        ("attn/proj/w", (d, d), std, 0.0), ("attn/proj/b", (d,), 0.02, 0.0),
        ("norm1/scale", (d,), 0.01, 0.1), ("norm1/bias", (d,), 0.02, 0.0),
        ("mlp/fc1/w", (d, f), std, 0.0), ("mlp/fc1/b", (f,), 0.02, 0.0),
        ("mlp/fc2/w", (f, d), f ** -0.5, 0.0), ("mlp/fc2/b", (d,), 0.02, 0.0),
        ("norm2/scale", (d,), 0.01, 0.1), ("norm2/bias", (d,), 0.02, 0.0),
    ):
        spec.append((f"{bl}/{name}", (n,) + shape, sd, mean))
    spec += [
        (f"{v}/norm/scale", (d,), 0.02, 1.0),
        (f"{v}/norm/bias", (d,), 0.02, 0.0),
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


def gelu(z: Tensor) -> Tensor:
    """z Phi(z) = z (1 + erf(z / sqrt 2)) / 2: nn.GELU()'s exact form."""
    return 0.5 * z * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))


def block(P: Precision, W: Dict[str, Tensor], i: int, x: Tensor, heads: int,
          eps: float) -> Tensor:
    """Post-norm block i (equations in the module's notes)."""
    g = lambda n: W[f"clip/visual/blocks/{n}"][i].float()  # noqa: E731
    b, s, d = x.shape
    dh = d // heads
    bias = torch.cat([g("attn/q_bias"), torch.zeros_like(g("attn/q_bias")), g("attn/v_bias")])
    q, k, v = (P.mm(x, g("attn/qkv/w")) + bias).split(d, dim=-1)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2) for t in (q, k, v))
    a = torch.empty(b, heads, s, dh, dtype=x.dtype, device=x.device)
    per = max(1, CHUNK_TOKENS // s)  # images per chunk of the scores
    for i0 in range(0, b, per):
        sl = slice(i0, i0 + per)
        scores = P.mm(q[sl], k[sl].transpose(-1, -2)) / math.sqrt(dh)
        a[sl] = P.mm(scores.softmax(dim=-1), v[sl])
    a = a.transpose(1, 2).reshape(b, s, d)
    x = x + layer_norm(P.mm(a, g("attn/proj/w")) + g("attn/proj/b"), g("norm1/scale"),
                       g("norm1/bias"), eps)
    rows = x.reshape(b * s, d)
    out = torch.empty_like(rows)
    for r0 in range(0, b * s, CHUNK_TOKENS):
        r = rows[r0:r0 + CHUNK_TOKENS]
        h = gelu(P.mm(r, g("mlp/fc1/w")) + g("mlp/fc1/b"))
        out[r0:r0 + CHUNK_TOKENS] = r + layer_norm(P.mm(h, g("mlp/fc2/w")) + g("mlp/fc2/b"),
                                                   g("norm2/scale"), g("norm2/bias"), eps)
    return out.reshape(b, s, d)


def vision(P: Precision, W: Dict[str, Tensor], cfg: dict, x: Tensor):
    """Normalized images (B, H, W, 3) -> the CLS features (last, non_proj,
    proj): the input of the last block, LN_post of the tower's output, and
    its projection. Patches (stride = patch) as one product plus the conv's
    bias, CLS and positions, the shallow prompt tokens appended; block i
    replaces the last n_ctx tokens by its own prompts for 0 < i < depth."""
    v = "clip/visual"
    f = lambda n: W[f"{v}/{n}"].float()  # noqa: E731
    p, s, d = cfg["patch"], cfg["stride"], cfg["vision_width"]
    n_ctx, heads, eps = cfg["vision_ctx"], cfg["vision_heads"], cfg["ln_eps"]
    if d != heads * cfg["head_width"]:
        raise ValueError(f"{cfg['name']}: width {d} is not {heads} heads of {cfg['head_width']}")
    b = x.shape[0]
    patches = x.unfold(1, p, s).unfold(2, p, s)  # (B, hg, wg, 3, p, p)
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, p * p * 3)
    x = P.mm(patches, f("conv/w").reshape(p * p * 3, d)) + f("conv/b")
    x = torch.cat([f("class_embedding").expand(b, 1, d), x], dim=1) + f("positional_embedding")
    x = torch.cat([x, f("vpt_shallow").expand(b, n_ctx, d)], dim=1)
    deep = f("vpt_deep")
    layers = cfg["vision_layers"]
    last = None
    for i in range(layers):
        if 0 < i < cfg["prompt_depth"]:
            x = torch.cat([x[:, :-n_ctx], deep[i].expand(b, n_ctx, d)], dim=1)
        if i == layers - 1:
            last = x[:, 0]
        x = block(P, W, i, x, heads, eps)
    non_proj = layer_norm(x[:, 0], f("norm/scale"), f("norm/bias"), eps)
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
