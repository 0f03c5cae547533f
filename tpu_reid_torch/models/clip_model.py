"""CLIP assembly helpers: image/text encode entry points and the load-time
positional-embedding grid resize.

The resize adapts square pretrained CLIP weights to the rectangular ReID
input with the exact cubic-convolution kernel of torch's bicubic mode
(a=-0.75, align_corners=False), in numpy since it runs once at load time (a
copy of the JAX package's numpy code).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tpu_reid_torch.configs import CLIPConfig
from tpu_reid_torch.models import text as T
from tpu_reid_torch.models import vit as V


def encode_image(params: dict, cfg: CLIPConfig, images: torch.Tensor, **kw):
    return V.apply_vit(params["visual"], cfg.vision, images, **kw)


def encode_text(params: dict, cfg: CLIPConfig, tokens: torch.Tensor, **kw):
    return T.encode_text_tokens(params["text"], cfg.text, tokens, **kw)


# ---------------------------------------------------------------------------
# positional-embedding resize (torch-bicubic-exact, numpy, load-time only)
# ---------------------------------------------------------------------------


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """4-tap cubic convolution weights at distances (1+f, f, 1-f, 2-f).

    Same kernel as torch's bicubic (Keys, a=-0.75)."""

    def k(t):
        t = np.abs(t)
        w = np.where(
            t <= 1,
            (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
        )
        return w

    offs = np.array([-1.0, 0.0, 1.0, 2.0])
    return k(frac[:, None] - offs[None, :])  # (n, 4)


def _resize_axis_cubic(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    x = np.moveaxis(x, axis, 0).astype(np.float64)
    in_size = x.shape[0]
    scale = out_size / in_size
    src = (np.arange(out_size) + 0.5) / scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    w = _cubic_weights(frac)  # (out, 4)
    idx = np.clip(i0[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    gathered = x[idx]  # (out, 4, ...)
    out = np.einsum("ot,ot...->o...", w, gathered)
    return np.moveaxis(out, 0, axis)


def resize_grid_bicubic(grid: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(h, w, d) -> (out_h, out_w, d), torch-bicubic-exact."""
    out = _resize_axis_cubic(grid, out_h, 0)
    out = _resize_axis_cubic(out, out_w, 1)
    return out


def resize_pos_embed(
    posemb: np.ndarray,
    out_h: int,
    out_w: int,
    prefix_tokens: int = 1,
    in_hw: Optional[tuple] = None,
) -> np.ndarray:
    """Resize a (prefix + h*w, d) positional embedding to a new grid.

    Reference: coop.py:398-414 — CLS row passes through, the grid is
    bicubic-resized to (out_h, out_w). The source grid is assumed square
    unless `in_hw` gives its rectangular shape.
    """
    posemb = np.asarray(posemb)
    head, grid = posemb[:prefix_tokens], posemb[prefix_tokens:]
    if in_hw is None:
        gs = int(round(math.sqrt(grid.shape[0])))
        assert gs * gs == grid.shape[0], (
            f"pos embed grid {grid.shape[0]} not square; pass in_hw"
        )
        in_hw = (gs, gs)
    assert in_hw[0] * in_hw[1] == grid.shape[0]
    grid = grid.reshape(in_hw[0], in_hw[1], -1)
    grid = resize_grid_bicubic(grid, out_h, out_w)
    grid = grid.reshape(out_h * out_w, -1)
    return np.concatenate([head, grid], axis=0).astype(posemb.dtype)
