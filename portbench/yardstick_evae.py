"""The operations and bytes an EVA02-CLIP-E vision tower's forward needs,
worked out from a configuration's shapes: what the EVA02-E cell's per-layer
rooflines and model FLOP/s share divide by. They count the work the model's
shapes need, whatever implements it: heads of 112 count 112 columns, not
the 128 a kernel may compute. The card's peaks are yardstick.py's.

Per full block of S tokens, D wide, hidden F (a post-norm block: no
LayerNorm before a product): the packed qkv product 2 S D 3D, the output
projection 2 S D D, fc1 2 S D F, fc2 2 S F D, and the attention core's
QK^T and PV 4 S^2 D.
"""

from __future__ import annotations

from typing import Tuple

from portbench.yardstick import PEAK_BF16_FLOPS, PEAK_BYTES  # noqa: F401


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int]:
    """(S tokens, P patches, D width, F hidden, L layers, E embed)."""
    (h, w), p, s = cfg["image_hw"], cfg["patch"], cfg["stride"]
    patches = ((h - p) // s + 1) * ((w - p) // s + 1)
    return (patches + 1 + cfg["vision_ctx"], patches, cfg["vision_width"], cfg["mlp_hidden"],
            cfg["vision_layers"], cfg["embed_dim"])


def gemm_calls(cfg: dict):
    """(M per image, N, K) of the four products of each full block: qkv,
    the attention output, fc1, fc2."""
    s, _, d, f, _, _ = dims(cfg)
    return ((s, 3 * d, d), (s, d, d), (s, f, d), (s, d, f))


def block_flops(cfg: dict) -> dict:
    """FLOPs of one image through one full block, by part."""
    s, _, d, _, _, _ = dims(cfg)
    parts = dict(zip(("qkv", "out", "fc1", "fc2"),
                     (2.0 * m * n * k for m, n, k in gemm_calls(cfg))))
    parts["attention"] = 4.0 * s * s * d
    return parts


def vision_forward_flops(cfg: dict) -> float:
    """FLOPs of one image through the tower as the CLS-only consumers run it:
    the patch embedding, L-1 full blocks, the last block for the CLS row
    (keys and values over every token), and the head."""
    s, p, d, f, n_layers, e = dims(cfg)
    flops = 2.0 * p * 3 * cfg["patch"] ** 2 * d
    flops += (n_layers - 1) * sum(block_flops(cfg).values())
    # the CLS-only block: k and v of every token, q, the attention row, the
    # output projection and the MLP of one row
    flops += 2.0 * s * d * 2 * d + 2.0 * d * d + 4.0 * s * d + 2.0 * d * d + 4.0 * d * f
    return flops + 2.0 * d * e


def block_gemm_bound_s(cfg: dict, images: int, elem_bytes: int, peak: float) -> float:
    """The least time of the full blocks' four products for `images` images:
    each call the larger of its operations over `peak` and its bytes over
    the memory rate (the input read once, the weight once, the output
    written once; the residual read where the branch's sum adds one: after
    the attention output and after fc2)."""
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
    images: QK^T and PV over every head of the configuration's width,
    against q, k, v read once and the output written once."""
    s, _, d, _, n_layers, _ = dims(cfg)
    flops = 4.0 * images * s * s * d
    nbytes = elem_bytes * 4 * images * s * d
    return (n_layers - 1) * max(flops / peak, nbytes / PEAK_BYTES)
