"""Eval-path image preprocessing on the device.

uint8 (B, H, W, 3) batches -> normalized float (B, h, w, 3): bicubic resize
when the stored size differs, then normalization (or the raw 0..255 scale
for models whose normalization is folded into the patch embed).

The resize reproduces `jax.image.resize(method="cubic")`, which is what the
JAX package runs: the Keys cubic kernel with a = -0.5, and antialiasing when
downsampling (the kernel is stretched by the inverse scale and each output's
weights renormalised). torch's `F.interpolate(mode="bicubic")` uses a = -0.75
and no antialias, so it is not used.

Normalization constants: ViT towers use (0.5,0.5,0.5)/(0.5,0.5,0.5); RN
towers use ImageNet stats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Tensor = torch.Tensor


def norm_stats(model_type: str) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if model_type == "vit":
        return VIT_MEAN, VIT_STD
    return IMAGENET_MEAN, IMAGENET_STD


def _keys_cubic(x: Tensor) -> Tensor:
    """Keys cubic kernel, a = -0.5, on non-negative distances."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weight_mat(in_size: int, out_size: int, device=None) -> Tensor:
    """(in_size, out_size) fp32 resampling weights, the same computation as
    jax.image.scale.compute_weight_mat with the cubic kernel, antialias on
    and no translation."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_cubic(images: Tensor, size_hw: Tuple[int, int]) -> Tensor:
    """(B, H, W, C) float -> (B, h, w, C) float32, as
    jax.image.resize(method="cubic") (axes whose size is unchanged are left
    alone)."""
    x = images.float()
    h, w = size_hw
    if x.shape[1] != h:
        x = torch.einsum("bhwc,ho->bowc", x, cubic_weight_mat(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = torch.einsum("bhwc,wo->bhoc", x, cubic_weight_mat(x.shape[2], w, x.device))
    return x


@dataclasses.dataclass(frozen=True)
class DevicePreprocess:
    """Batched eval preprocessing on the images' device: uint8
    (B, H, W, 3) -> normalized (B, h, w, 3) in `dtype`."""

    size_hw: Tuple[int, int]
    model_type: str = "vit"
    dtype: torch.dtype = torch.float32

    def _normalize(self, x: Tensor) -> Tensor:
        mean, std = norm_stats(self.model_type)
        mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
        std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
        x = x.float() / 255.0
        return ((x - mean_t) / std_t).to(self.dtype)

    def eval_batch(self, images_u8: Tensor) -> Tensor:
        if tuple(images_u8.shape[1:3]) == tuple(self.size_hw):
            return self._normalize(images_u8)  # host already sized the crop
        return self._normalize(resize_cubic(images_u8, self.size_hw))

    def eval_batch_raw(self, images_u8: Tensor) -> Tensor:
        """Raw-scale eval path for normalization-folded models
        (models.vit.fold_visual_input_norm): 0..255-scale values in
        self.dtype, resized if needed. The bicubic resize is linear with
        weights summing to 1, so it commutes exactly with the folded affine
        normalization; uint8 values are exact in bfloat16."""
        if tuple(images_u8.shape[1:3]) == tuple(self.size_hw):
            return images_u8.to(self.dtype)
        return resize_cubic(images_u8, self.size_hw).to(self.dtype)

    def eval_flip_batch(self, images_u8: Tensor) -> Tensor:
        """Deterministic flip-TTA pass (horizontal flip, center-equivalent
        crop)."""
        return self.eval_batch(images_u8.flip(2))
