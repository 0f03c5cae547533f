"""Plain PyTorch reference of the IVLP CLIP ViT-B/16 ReID model.

It follows the published model (OpenAI CLIP ViT-B/16 and its text tower,
CLIP-ReID's BNNeck heads and losses, IVLP's per-layer prompt tokens) and is
written from its equations: float32 arithmetic, no kernel, no batching
trick, nothing of the program under test. The benchmark hands it the same
raw weights and inputs as the program, and judges the program's outputs by
it.

Parameters are a flat dict {name: tensor}; a name is the "/"-joined path of
the program's parameter tree, and the layouts are the published ones in
that tree's convention: linear weights (in, out), the patch embedding HWIO
(kh, kw, 3, width), transformer blocks stacked on a leading layer axis.

`Precision` says how every product is computed: "fp32" (TF32 off: the
reference), "tf32" (TF32 on: the control of an fp32 program) and "fp8" (the
operands of every product rounded to float8 e4m3 with one scale per tensor:
the control of a bf16 program).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# geometry and parameters
# ---------------------------------------------------------------------------


def grid(cfg: dict) -> Tuple[int, int]:
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    return (h - p) // s + 1, (w - p) // s + 1


def seq_len(cfg: dict) -> int:
    hg, wg = grid(cfg)
    return hg * wg + 1 + cfg["vision_ctx"]


def _block_spec(prefix: str, layers: int, width: int) -> list:
    std = width ** -0.5
    out = []
    for name, shape, sd, mean in (
        ("attn/in_proj/w", (width, 3 * width), std, 0.0),
        ("attn/in_proj/b", (3 * width,), 0.01, 0.0),
        ("attn/out_proj/w", (width, width), std / 2, 0.0),
        ("attn/out_proj/b", (width,), 0.01, 0.0),
        ("ln_1/scale", (width,), 0.01, 1.0),
        ("ln_1/bias", (width,), 0.01, 0.0),
        ("mlp/c_fc/w", (width, 4 * width), std, 0.0),
        ("mlp/c_fc/b", (4 * width,), 0.01, 0.0),
        ("mlp/c_proj/w", (4 * width, width), std / 4, 0.0),
        ("mlp/c_proj/b", (width,), 0.01, 0.0),
        ("ln_2/scale", (width,), 0.01, 1.0),
        ("ln_2/bias", (width,), 0.01, 0.0),
    ):
        out.append((f"{prefix}/blocks/{name}", (layers,) + shape, sd, mean))
    return out


def param_spec(cfg: dict, parts: List[str]) -> list:
    """[(name, shape, std, mean)] of the parameters the named parts need:
    "visual" (the image tower with its prompt tokens), "text" (the text
    tower with its prompt tokens, the prompt learner) and "head" (the two
    BNNecks and ID classifiers). A leaf is mean + std x N(0, 1); std 0 is a
    constant. The scales are those of a CLIP checkpoint's random stand-in
    (LayerNorm gains near 1, 1/sqrt(width) projections) and of the heads'
    published initialisations."""
    d, e = cfg["vision_width"], cfg["embed_dim"]
    p, n_v = cfg["patch"], cfg["vision_ctx"]
    spec = []
    if "visual" in parts:
        v = "clip/visual"
        spec += [
            (f"{v}/conv/w", (p, p, 3, d), (3 * p * p) ** -0.5, 0.0),
            (f"{v}/class_embedding", (d,), d ** -0.5, 0.0),
            (f"{v}/positional_embedding", (seq_len(cfg) - n_v, d), 0.01, 0.0),
            (f"{v}/ln_pre/scale", (d,), 0.01, 1.0),
            (f"{v}/ln_pre/bias", (d,), 0.01, 0.0),
        ]
        spec += _block_spec(v, cfg["vision_layers"], d)
        spec += [
            (f"{v}/ln_post/scale", (d,), 0.01, 1.0),
            (f"{v}/ln_post/bias", (d,), 0.01, 0.0),
            (f"{v}/proj", (d, e), d ** -0.5, 0.0),
            (f"{v}/vpt_shallow", (n_v, d), 0.02, 0.0),
            (f"{v}/vpt_deep", (cfg["vision_layers"], n_v, d), 0.02, 0.0),
        ]
    if "text" in parts:
        t, dt = "clip/text", cfg["text_width"]
        n_ctx, n_pre = cfg["n_cls_ctx"], cfg["n_prefix"]
        spec += [(f"{t}/positional_embedding", (cfg["context_length"], dt), 0.01, 0.0)]
        spec += _block_spec(t, cfg["text_layers"], dt)
        spec += [
            (f"{t}/ln_final/scale", (dt,), 0.01, 1.0),
            (f"{t}/ln_final/bias", (dt,), 0.01, 0.0),
            (f"{t}/text_projection", (dt, e), dt ** -0.5, 0.0),
            (f"{t}/vpt_deep", (cfg["text_layers"], cfg["language_ctx"], dt), 0.02, 0.0),
            ("clip/logit_scale", (), 0.0, math.log(1 / 0.07)),
            ("prompt_learner/cls_ctx", (cfg["n_cls"], n_ctx, dt), 0.02, 0.0),
            ("prompt_learner/prefix", (1, n_pre, dt), 0.02, 0.0),
            ("prompt_learner/suffix", (1, cfg["context_length"] - n_pre - n_ctx, dt), 0.02,
             0.0),
        ]
    if "head" in parts:
        for bn, width in (("bn", d), ("bn_proj", e)):
            spec += [
                (f"head/{bn}/scale", (width,), 0.0, 1.0),
                (f"head/{bn}/bias", (width,), 0.0, 0.0),
                (f"head/{bn}/mean", (width,), 0.0, 0.0),
                (f"head/{bn}/var", (width,), 0.0, 1.0),
            ]
        spec += [
            ("head/cls/w", (d, cfg["n_cls"]), 0.001, 0.0),
            ("head/cls_proj/w", (e, cfg["n_cls"]), 0.001, 0.0),
        ]
    return spec


# ---------------------------------------------------------------------------
# the towers
# ---------------------------------------------------------------------------


def layer_norm(x: Tensor, g: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def attention(P: Precision, x: Tensor, w_in, b_in, w_out, b_out, heads: int,
              mask: Tensor = None) -> Tensor:
    b, s, d = x.shape
    dh = d // heads
    q, k, v = (P.mm(x, w_in) + b_in).split(d, dim=-1)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2) for t in (q, k, v))
    scores = P.mm(q, k.transpose(-1, -2)) * dh ** -0.5
    if mask is not None:
        scores = scores + mask
    out = P.mm(scores.softmax(dim=-1), v).transpose(1, 2).reshape(b, s, d)
    return P.mm(out, w_out) + b_out


def block(P: Precision, W: Dict[str, Tensor], prefix: str, i: int, x: Tensor, heads: int,
          mask: Tensor = None) -> Tensor:
    """Pre-norm CLIP block i of the stack under `prefix`: x + attn(ln_1 x),
    then + mlp(ln_2 x) with QuickGELU."""
    g = lambda n: W[f"{prefix}/blocks/{n}"][i].float()  # noqa: E731
    h = layer_norm(x, g("ln_1/scale"), g("ln_1/bias"))
    x = x + attention(P, h, g("attn/in_proj/w"), g("attn/in_proj/b"), g("attn/out_proj/w"),
                      g("attn/out_proj/b"), heads, mask)
    h = layer_norm(x, g("ln_2/scale"), g("ln_2/bias"))
    u = P.mm(h, g("mlp/c_fc/w")) + g("mlp/c_fc/b")
    u = u * torch.sigmoid(1.702 * u)
    return x + P.mm(u, g("mlp/c_proj/w")) + g("mlp/c_proj/b")


def normalize(cfg: dict, images_u8: Tensor) -> Tensor:
    """uint8 (B, H, W, 3) -> the model's input scale, float32."""
    mean = torch.tensor(cfg["pixel_mean"], dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(cfg["pixel_std"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def vision(P: Precision, W: Dict[str, Tensor], cfg: dict, x: Tensor):
    """Normalized images (B, H, W, 3) -> the CLS features (last, non_proj,
    proj): the input of the last block, ln_post of the tower's output, and
    its projection. Overlapping patches (stride < patch) as one product,
    CLS and positions, the shallow prompt tokens appended, ln_pre, then
    block i replaces the last n_ctx tokens by its own prompts for 0 < i <
    depth."""
    v = "clip/visual"
    f = lambda n: W[f"{v}/{n}"].float()  # noqa: E731
    p, s, d = cfg["patch"], cfg["stride"], cfg["vision_width"]
    n_ctx, heads = cfg["vision_ctx"], cfg["vision_heads"]
    b = x.shape[0]
    patches = x.unfold(1, p, s).unfold(2, p, s)  # (B, hg, wg, 3, p, p)
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, p * p * 3)
    x = P.mm(patches, f("conv/w").reshape(p * p * 3, d))
    x = torch.cat([f("class_embedding").expand(b, 1, d), x], dim=1) + f("positional_embedding")
    x = torch.cat([x, f("vpt_shallow").expand(b, n_ctx, d)], dim=1)
    x = layer_norm(x, f("ln_pre/scale"), f("ln_pre/bias"))
    deep = f("vpt_deep")
    layers = cfg["vision_layers"]
    last = None
    for i in range(layers):
        if 0 < i < cfg["prompt_depth"]:
            x = torch.cat([x[:, :-n_ctx], deep[i].expand(b, n_ctx, d)], dim=1)
        if i == layers - 1:
            last = x[:, 0]
        x = block(P, W, v, i, x, heads)
    non_proj = layer_norm(x[:, 0], f("ln_post/scale"), f("ln_post/bias"))
    return last, non_proj, P.mm(non_proj, f("proj"))


def eval_embeddings(P: Precision, W: Dict[str, Tensor], cfg: dict, images_u8: Tensor,
                    flip_tta: bool = True) -> Tensor:
    """The retrieval embedding cat(non_proj, proj), averaged over the image
    and its horizontal mirror when flip_tta."""
    x = normalize(cfg, images_u8)
    out = torch.cat(vision(P, W, cfg, x)[1:], dim=-1)
    if flip_tta:
        out = 0.5 * (out + torch.cat(vision(P, W, cfg, x.flip(2))[1:], dim=-1))
    return out


def text_features(P: Precision, W: Dict[str, Tensor], cfg: dict) -> Tensor:
    """Every class's prompt "prefix | class context | suffix" through the
    causal text tower; block i replaces tokens 1..n_ctx by its own prompts
    for 0 < i < depth; the EOT token's ln_final feature, projected."""
    t = "clip/text"
    f = lambda n: W[n].float()  # noqa: E731
    n, dt = cfg["n_cls"], cfg["text_width"]
    ctx = f("prompt_learner/cls_ctx")
    x = torch.cat([f("prompt_learner/prefix").expand(n, -1, dt), ctx,
                   f("prompt_learner/suffix").expand(n, -1, dt)], dim=1)
    x = x + f(f"{t}/positional_embedding")
    s = x.shape[1]
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    deep, n_l = f(f"{t}/vpt_deep"), cfg["language_ctx"]
    for i in range(cfg["text_layers"]):
        if 0 < i < cfg["prompt_depth"]:
            x = torch.cat([x[:, :1], deep[i].expand(n, n_l, dt), x[:, 1 + n_l:]], dim=1)
        x = block(P, W, t, i, x, cfg["text_heads"], mask)
    x = layer_norm(x, f(f"{t}/ln_final/scale"), f(f"{t}/ln_final/bias"))
    return P.mm(x[:, cfg["eot_index"]], f(f"{t}/text_projection"))


# ---------------------------------------------------------------------------
# stage 2 of CLIP-ReID: heads, losses, Adam
# ---------------------------------------------------------------------------


def stage2_trainable(name: str) -> bool:
    """Stage 2 trains the image tower (not its prompt tokens) and the ID
    heads; the BNNecks' biases stay at zero and their statistics are state."""
    if name.startswith("clip/visual/"):
        return "vpt_" not in name
    return name in ("head/cls/w", "head/cls_proj/w", "head/bn/scale", "head/bn_proj/scale")


def is_bias(name: str) -> bool:
    return any(part in ("b", "bias") for part in name.split("/"))


def bn_train(x: Tensor, scale, bias, mean0, var0, momentum: float, eps: float = 1e-5):
    """BatchNorm1d in training mode: batch statistics, and the running ones
    moved by `momentum` (the variance unbiased)."""
    n = x.shape[0]
    mean = x.mean(0)
    var = (x - mean).square().mean(0)
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return y, (1 - momentum) * mean0 + momentum * mean, \
        (1 - momentum) * var0 + momentum * var * n / (n - 1)


def ce_smooth(logits: Tensor, labels: Tensor, eps: float) -> Tensor:
    n = logits.shape[-1]
    target = (1 - eps) * F.one_hot(labels, n).float() + eps / n
    return -(target * logits.log_softmax(dim=-1)).sum(-1).mean()


def triplet(P: Precision, f: Tensor, labels: Tensor, margin: float) -> Tensor:
    """Batch-hard triplet: the farthest positive and the nearest negative of
    each anchor under euclidean distance."""
    sq = (f * f).sum(1, keepdim=True)
    dist = (sq + sq.T - 2 * P.mm(f, f.T)).clamp_min(1e-12).sqrt()
    pos = labels[:, None] == labels[None, :]
    d_ap = torch.where(pos, dist, torch.full_like(dist, -1e30)).amax(1)
    d_an = torch.where(~pos, dist, torch.full_like(dist, 1e30)).amin(1)
    return torch.relu(d_ap - d_an + margin).mean()


def stage2_loss(P: Precision, W: Dict[str, Tensor], cfg: dict, tr: dict, images: Tensor,
                labels: Tensor, text: Tensor):
    """(loss, new BNNeck statistics) of one batch: ID cross entropies of
    both BNNecks, image-to-text cross entropy against every class's text
    feature, and the triplet on the three CLS features."""
    last, non_proj, proj = vision(P, W, cfg, images)
    stats, logits = {}, []
    for bn, cls, feat in (("bn", "cls", non_proj), ("bn_proj", "cls_proj", proj)):
        h = f"head/{bn}"
        y, stats[f"{h}/mean"], stats[f"{h}/var"] = bn_train(
            feat, W[f"{h}/scale"], W[f"{h}/bias"], W[f"{h}/mean"], W[f"{h}/var"],
            tr["bn_momentum"])
        logits.append(P.mm(y, W[f"head/{cls}/w"]))
    eps = tr["label_smooth"]
    loss = sum(tr["id_loss_weight"] * ce_smooth(lg, labels, eps) for lg in logits)
    loss = loss + ce_smooth(P.mm(proj, text.T), labels, eps)
    loss = loss + sum(triplet(P, f, labels, tr["triplet_margin"])
                      for f in (last, non_proj, proj))
    return loss, stats


def lr_at(tr: dict, epoch: int) -> float:
    """The stage's lr schedule: linear warm-up, then steps at milestones."""
    s = tr["schedule"]
    factor = 1.0
    if epoch < s["warmup_epochs"]:
        alpha = epoch / s["warmup_epochs"]
        factor = s["warmup_factor"] * (1 - alpha) + alpha
    steps = sum(1 for m in s["milestones"] if m <= epoch)
    return tr["lr"] * factor * s["gamma"] ** steps


def stage2_steps(P: Precision, W0: Dict[str, Tensor], cfg: dict, tr: dict, batches: list,
                 epochs: List[int]) -> dict:
    """Stage-2 steps from W0 over `batches` [(normalized images, labels)],
    step k at epoch epochs[k]'s lr, with Adam (coupled weight decay, bias
    leaves at bias_lr_mult x lr). Returns each step's loss, the first
    gradient as Adam takes it (with the decay term), the trained leaves and
    the BNNeck statistics after the last step."""
    with P.scope():
        W = {k: v.detach().float().clone() for k, v in W0.items()}
        names = [k for k in W if stage2_trainable(k)]
        for k in names:
            W[k].requires_grad_(True)
        with torch.no_grad():
            text = text_features(P, W, cfg)
        b1, b2 = tr["betas"]
        m = {k: torch.zeros_like(W[k]) for k in names}
        v = {k: torch.zeros_like(W[k]) for k in names}
        out = {"losses": [], "grad1": {}}
        for t, ((images, labels), epoch) in enumerate(zip(batches, epochs), start=1):
            loss, stats = stage2_loss(P, W, cfg, tr, images, labels, text)
            grads = torch.autograd.grad(loss, [W[k] for k in names])
            out["losses"].append(float(loss.detach()))
            lr = lr_at(tr, epoch)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    g = g + tr["weight_decay"] * W[k]
                    if t == 1:
                        out["grad1"][k] = g.clone()
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    step = lr * (tr["bias_lr_mult"] if is_bias(k) else 1.0) / (1 - b1 ** t)
                    denom = v[k].sqrt() / math.sqrt(1 - b2 ** t) + tr["adam_eps"]
                    W[k].addcdiv_(m[k], denom, value=-step)
                for k, s in stats.items():
                    W[k] = s.detach()
            del loss, grads
        out["params"] = {k: W[k].detach() for k in names}
        out["bn"] = {k: W[k] for k in W if k.startswith("head/bn") and k.endswith(("mean", "var"))}
    return out
