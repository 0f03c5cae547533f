"""Peaks of the card and the operations and bytes a forward needs, worked
out from a configuration's shapes: what the per-layer rooflines and model
FLOP/s shares divide by. They count the work the model's shapes need,
whatever implements it.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
# an fp32-accurate product on the tensor cores takes three TF32 passes
# (hi*hi + hi*lo + lo*hi): the fp32 programs' peak
PEAK_FP32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int, int]:
    """(S tokens, P patches, D width, F hidden, H heads, L layers, E embed)."""
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    patches = ((h - p) // s + 1) * ((w - p) // s + 1)
    d = cfg["vision_width"]
    return (patches + 1 + cfg["vision_ctx"], patches, d, 4 * d, cfg["vision_heads"],
            cfg["vision_layers"], cfg["embed_dim"])


def gemm_calls(cfg: dict):
    """(M per image, N, K) of the four products of each full block: the
    fused qkv, the attention output, the MLP's two."""
    s, _, d, f, _, _, _ = dims(cfg)
    return ((s, 3 * d, d), (s, d, d), (s, f, d), (s, d, f))


def vision_forward_flops(cfg: dict, heads_classes: int = 0) -> float:
    """FLOPs of one image through the tower as the CLS-only consumers run it:
    the patch embedding, L-1 full blocks, the last block for the CLS row
    (keys and values over every token), ln_post's projection, and with
    `heads_classes` the two ID heads and the image-to-text logits."""
    s, p, d, f, _, n_layers, e = dims(cfg)
    patch_k = 3 * cfg["patch"] ** 2
    flops = 2.0 * p * patch_k * d
    full = sum(2.0 * m * n * k for m, n, k in gemm_calls(cfg)) + 4.0 * s * s * d
    flops += (n_layers - 1) * full
    last = 2.0 * s * d * 2 * d + 2.0 * d * d + 4.0 * s * d + 2.0 * d * d + 4.0 * d * f
    flops += last + 2.0 * d * e
    if heads_classes:
        flops += 2.0 * (d + e + e) * heads_classes
    return flops


def block_gemm_bound_s(cfg: dict, images: int, elem_bytes: int, peak: float) -> float:
    """The least time of the full blocks' four products for `images` images
    (each call the larger of its operations over `peak` and its bytes over
    the memory rate: operands read once, the output written once, and the
    residual read where one is added)."""
    n_full = cfg["vision_layers"] - 1
    total = 0.0
    for i, (m, n, k) in enumerate(gemm_calls(cfg)):
        m *= images
        residual = m * n if i in (1, 3) else 0
        nbytes = elem_bytes * (m * k + k * n + m * n + residual + n)
        total += max(2.0 * m * n * k / peak, nbytes / PEAK_BYTES)
    return n_full * total


def attention_bound_s(cfg: dict, images: int, elem_bytes: int, peak: float) -> float:
    """The least time of the full blocks' attention cores for `images`
    images: QK^T and PV over every head, against q, k, v read once and the
    output written once."""
    s, _, d, _, _, n_layers, _ = dims(cfg)
    flops = 4.0 * images * s * s * d
    nbytes = elem_bytes * 4 * images * s * d
    return (n_layers - 1) * max(flops / peak, nbytes / PEAK_BYTES)
